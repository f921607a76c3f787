"""Reusable value validators for dataclass ``__post_init__`` checks.

Copy of the JAX package's ``utils/validators.py``: the port's dataclasses
call them directly in ``__post_init__``. Each raises ``ValueError`` naming
the offending field.
"""

from __future__ import annotations

import re
from typing import Any, Collection, Optional, Tuple


def assert_not_empty(name: str, value: Collection) -> None:
    if not value:
        raise ValueError(f"{name} must not be empty.")


def assert_not_negative(name: str, value: float) -> None:
    if value < 0:
        raise ValueError(f"{name} must not be negative (got {value}).")


def assert_not_none(name: str, value: Any) -> None:
    if value is None:
        raise ValueError(f"{name} must not be None.")


def assert_between(name: str, value: float, low: float, high: float) -> None:
    if value < low or value > high:
        raise ValueError(f"{name} ({value}) must be between {low} and {high}.")


def assert_re_fullmatch(name: str, value: str, regex: str) -> None:
    if not re.fullmatch(regex, value):
        raise ValueError(f"{name} ({value!r}) must fully match {regex!r}.")


def assert_shape(
    name: str, value, expected: Tuple[Optional[int], ...]
) -> None:
    """Checks an array's shape; ``None`` entries match any extent."""
    shape = tuple(getattr(value, "shape", ()))
    if len(shape) != len(expected) or any(
        e is not None and s != e for s, e in zip(shape, expected)
    ):
        raise ValueError(f"{name} has shape {shape}; expected {expected}.")
