"""The training loop: checkpoint/restart, failure injection, stragglers."""
