"""The harness: cells read from data files, the inputs drawn from the seed,
the adapter to the program, the traced slice, and the result line."""
