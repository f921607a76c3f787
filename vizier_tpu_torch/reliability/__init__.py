"""Typed errors of the port (the JAX package's ``reliability.errors``)."""
