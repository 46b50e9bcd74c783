"""Weight conversion between the JAX package, reference checkpoints and the port."""
