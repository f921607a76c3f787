"""Nested-structure numpy assertions for tests.

The port's copy of the JAX package's ``testing/numpy_assertions.py``. The
JAX copy walks pytrees with JAX's tree utilities; this one walks the port's
containers itself: dicts (by sorted key), lists, tuples, NamedTuples and
dataclasses (by field), with numpy arrays, torch tensors and scalars as
leaves and ``None`` as an empty subtree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch


def assert_arraytree_allclose(d1: Mapping[str, Any], d2: Mapping[str, Any], **kwargs) -> None:
    """Compares two (nested) dictionaries of arrays/scalars."""
    np.testing.assert_equal(sorted(d1.keys()), sorted(d2.keys()))
    for k, v in d1.items():
        if isinstance(v, dict):
            assert_arraytree_allclose(v, d2[k], **kwargs)
        else:
            try:
                np.testing.assert_allclose(_leaf(v), _leaf(d2[k]), err_msg=f"key={k!r}", **kwargs)
            except TypeError:
                np.testing.assert_equal(v, d2[k], err_msg=f"key={k!r}")


def _leaf(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def _flatten(tree: Any, leaves: List[Any]) -> Tuple:
    """Appends ``tree``'s leaves to ``leaves`` in order; returns its structure."""
    if tree is None:
        return ("None",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return (type(tree), names, tuple(_flatten(getattr(tree, n), leaves) for n in names))
    leaves.append(_leaf(tree))
    return ("*",)


def assert_pytree_allclose(t1: Any, t2: Any, **kwargs) -> None:
    """Compares two nested structures (same structure, allclose leaves)."""
    l1, l2 = [], []
    d1, d2 = _flatten(t1, l1), _flatten(t2, l2)
    if d1 != d2:
        raise AssertionError(f"Tree structures differ:\n  {d1}\n  {d2}")
    for i, (a, b) in enumerate(zip(l1, l2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), err_msg=f"leaf {i}", **kwargs
        )
