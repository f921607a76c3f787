"""Reads of the port's ``VIZIER_TORCH_*`` environment switches.

The port's switches live inside the port under their own prefix, so they
never collide with the JAX package's ``VIZIER_*`` switches.
"""

from __future__ import annotations

import os

PREFIX = "VIZIER_TORCH_"


def _check(name: str) -> str:
    if not name.startswith(PREFIX):
        raise ValueError(f"Port switches are named {PREFIX}*, got {name!r}.")
    return name


def env_on(name: str, default: str = "1") -> bool:
    """Boolean switch: unset -> ``default``; "0"/"false"/"" = off."""
    return os.environ.get(_check(name), default) not in ("0", "false", "False", "")


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(_check(name), default))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(_check(name), default))
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(_check(name), default)
