"""Plain float32 PyTorch references that the benchmark holds the program
to.  Nothing here imports the program, JAX or the JAX package."""
