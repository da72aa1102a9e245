"""Continuous-batching serving: scheduler and engine."""
