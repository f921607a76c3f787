"""Hand-written CUDA kernels: build and bind."""
