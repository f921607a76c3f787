"""PyTorch/CUDA port of the JAX package: the DEFAULT GP-UCB-PE designer on an H100.

The package keeps the JAX package's module layout (``models/``,
``optimizers/``, ``designers/``, ...) and imports nothing of it. Entry points
take ``device=`` (default ``"cuda"``) and raise when no GPU is present unless
the caller asks for ``"cpu"``. The mixed-feature ARD Matern-5/2 kernel and its
gradient run as hand-written CUDA kernels (``csrc/``) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.
"""
