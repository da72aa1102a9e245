"""The plain reference: the configurations' decoder, its loss and AdamW in
plain PyTorch, in float32 with TF32 off, from the weights the benchmark
draws.  It imports nothing of the program, and nothing of JAX."""
