"""Numpy-aware JSON encoding for metadata serialization.

Copy of the JAX package's ``utils/json_utils.py``, byte for byte in its
format: arrays are encoded as ``{"__np__": {dtype, shape, data}}`` so designer
state holding numpy arrays round-trips through string metadata, and state
that either package wrote loads in the other.
"""

from __future__ import annotations

import base64
import json
from typing import Any

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj: Any) -> Any:
        if isinstance(obj, np.ndarray):
            return {
                "__np__": {
                    "dtype": str(obj.dtype),
                    "shape": list(obj.shape),
                    "data": base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode("ascii"),
                }
            }
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, (np.bool_,)):
            return bool(obj)
        if hasattr(obj, "__array__"):  # other array types (host tensors)
            return self.default(np.asarray(obj))
        return super().default(obj)


def _object_hook(d: dict) -> Any:
    if "__np__" in d and set(d) == {"__np__"}:
        spec = d["__np__"]
        arr = np.frombuffer(
            base64.b64decode(spec["data"]), dtype=np.dtype(spec["dtype"])
        ).reshape(spec["shape"])
        return arr.copy()
    return d


class NumpyDecoder(json.JSONDecoder):
    """Inverse of :class:`NumpyEncoder` (``json.loads(s, cls=NumpyDecoder)``)."""

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("object_hook", _object_hook)
        super().__init__(**kwargs)


def dumps(obj: Any) -> str:
    return json.dumps(obj, cls=NumpyEncoder)


def loads(s: str) -> Any:
    return json.loads(s, object_hook=_object_hook)
