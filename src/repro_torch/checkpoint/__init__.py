"""Atomic, asynchronous checkpoints of model and optimizer state."""
