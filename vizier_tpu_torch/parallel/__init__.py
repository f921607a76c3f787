"""Cross-study batching of the port (the JAX package's ``parallel``)."""
