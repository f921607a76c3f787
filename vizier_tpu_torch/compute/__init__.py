"""The batched designer-compute IR of the port (the JAX package's ``compute``)."""
