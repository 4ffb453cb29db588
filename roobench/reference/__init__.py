"""Plain PyTorch references the benchmark holds the program's outputs to.
They import nothing of the program and nothing of the JAX package."""
