"""The benchmark's plain reference: plain PyTorch that imports nothing of
the program, the JAX package or JAX."""
