"""Tracing and metrics of the port (copies of the JAX package's ``observability``)."""
