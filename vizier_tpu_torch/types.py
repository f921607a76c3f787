"""Padded arrays and model input containers.

Counterparts of the JAX package's ``types.py:32-213``. ``PaddedArray`` pads trial
counts and feature dims to quantized shapes with per-axis validity masks;
every downstream op threads the masks so fill values never leak into a
Cholesky factor or an acquisition. The containers hold numpy arrays on the
host; ``.to(device)`` returns the same container holding torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]

_T = TypeVar("_T")

# float64/int64 host buffers are narrowed the way the reference's x64-off
# canonicalization does, so both packages see the same dtypes.
_CANONICAL = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
}


def _to(x: ArrayLike, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


@dataclasses.dataclass(frozen=True)
class PaddedArray:
    """A fixed-shape array whose trailing rows/cols are padding.

    ``padded_array`` has the quantized shape; ``is_missing`` holds one boolean
    mask per axis, True where that index is padding.
    """

    padded_array: ArrayLike
    is_missing: Tuple[ArrayLike, ...]
    fill_value: Any = 0.0

    @classmethod
    def from_array(
        cls,
        array: np.ndarray,
        target_shape: Optional[Tuple[int, ...]] = None,
        *,
        fill_value: Any = 0.0,
    ) -> "PaddedArray":
        """Pads a host array up to ``target_shape`` (defaults to its own)."""
        array = np.asarray(array)
        canonical = _CANONICAL.get(array.dtype)
        if canonical is not None:
            array = array.astype(canonical)
        if target_shape is None:
            target_shape = array.shape
        if len(target_shape) != array.ndim:
            raise ValueError(f"target_shape {target_shape} rank != array rank {array.ndim}.")
        for axis, (have, want) in enumerate(zip(array.shape, target_shape)):
            if have > want:
                raise ValueError(
                    f"Axis {axis}: array dim {have} exceeds target {want}; cannot pad down."
                )
        pad_width = [(0, want - have) for have, want in zip(array.shape, target_shape)]
        padded = np.pad(array, pad_width, constant_values=fill_value)
        masks = tuple(
            np.arange(want) >= have for have, want in zip(array.shape, target_shape)
        )
        return cls(padded_array=padded, is_missing=masks, fill_value=fill_value)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.padded_array.shape)

    def valid_mask(self, axis: int = 0) -> ArrayLike:
        """True where the index along ``axis`` is real data."""
        return ~self.is_missing[axis]

    def to(self, device: torch.device) -> "PaddedArray":
        """The same padded array as torch tensors on ``device``."""
        return PaddedArray(
            padded_array=_to(self.padded_array, device),
            is_missing=tuple(_to(m, device) for m in self.is_missing),
            fill_value=self.fill_value,
        )


@dataclasses.dataclass(frozen=True)
class ContinuousAndCategorical(Generic[_T]):
    """A pair of containers, one for continuous and one for categorical data."""

    continuous: _T
    categorical: _T

    def map(self, fn) -> "ContinuousAndCategorical":
        return ContinuousAndCategorical(fn(self.continuous), fn(self.categorical))

    def to(self, device: torch.device) -> "ContinuousAndCategorical":
        return self.map(lambda a: a.to(device))


# The GP feature container: continuous features are float [N, Dc] scaled to
# [0,1]; categorical features are integer category indices [N, Ds].
ModelInput = ContinuousAndCategorical[PaddedArray]


@dataclasses.dataclass(frozen=True)
class ModelData:
    """Features + labels: the training set handed to the GP."""

    features: ModelInput
    labels: PaddedArray  # [N, num_metrics] float, NaN for infeasible.

    def to(self, device: torch.device) -> "ModelData":
        return ModelData(self.features.to(device), self.labels.to(device))


def padded_zeros(
    continuous_shape: Tuple[int, int], categorical_shape: Tuple[int, int]
) -> ModelInput:
    """An all-padding ModelInput (useful as a neutral element)."""
    cont = PaddedArray(
        padded_array=np.zeros(continuous_shape, dtype=np.float32),
        is_missing=(
            np.ones(continuous_shape[0], dtype=bool),
            np.ones(continuous_shape[1], dtype=bool),
        ),
        fill_value=0.0,
    )
    cat = PaddedArray(
        padded_array=np.zeros(categorical_shape, dtype=np.int32),
        is_missing=(
            np.ones(categorical_shape[0], dtype=bool),
            np.ones(categorical_shape[1], dtype=bool),
        ),
        fill_value=0,
    )
    return ContinuousAndCategorical(continuous=cont, categorical=cat)
