"""Reads of the port's ``VIZIER_TORCH_*`` environment switches.

The port's switches live inside the port under their own prefix, so they
never collide with the JAX package's ``VIZIER_*`` switches. Every read goes
through the switch registry (``analysis/registry.py``), which raises
``KeyError`` on a name it does not declare and supplies a flag's default.
"""

from __future__ import annotations

from vizier_tpu_torch.analysis.registry import (  # noqa: F401  (the read helpers)
    PREFIX,
    env_float,
    env_int,
    env_on,
    env_str,
)
