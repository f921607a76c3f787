"""Scalable surrogates: the sparse inducing-point GP behind the GP designers.

Counterpart of the JAX package's ``surrogates/`` package:

- ``config``        — :class:`SurrogateConfig`, the exact↔sparse auto-switch;
- ``sparse_gp``     — the SGPR collapsed-bound model and k-center inducing
  selection, mask-safe like the exact GP (``models.gp``);
- ``sparse_bandit`` — the sparse train and acquisition sweep the GP designers
  call above the switch's trial threshold.
"""

from vizier_tpu_torch.surrogates.config import SurrogateConfig  # noqa: F401

__all__ = ["SurrogateConfig"]
