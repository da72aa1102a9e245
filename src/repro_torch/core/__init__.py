"""BCSR host format and row permutations (numpy)."""
