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


def _check_target(shape: Tuple[int, ...], target_shape: Tuple[int, ...]) -> None:
    """Raises unless ``target_shape`` has ``shape``'s rank and no smaller axis."""
    if len(target_shape) != len(shape):
        raise ValueError(f"target_shape {target_shape} rank != array rank {len(shape)}.")
    for axis, (have, want) in enumerate(zip(shape, target_shape)):
        if have > want:
            raise ValueError(
                f"Axis {axis}: array dim {have} exceeds target {want}; cannot pad down."
            )


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
        _check_target(array.shape, target_shape)
        pad_width = [(0, want - have) for have, want in zip(array.shape, target_shape)]
        padded = np.pad(array, pad_width, constant_values=fill_value)
        masks = tuple(
            np.arange(want) >= have for have, want in zip(array.shape, target_shape)
        )
        return cls(padded_array=padded, is_missing=masks, fill_value=fill_value)

    @classmethod
    def as_padded(cls, array: ArrayLike, *, fill_value: Any = 0.0) -> "PaddedArray":
        """Wraps an array with no padding (all entries valid); a tensor stays
        a tensor on its own device."""
        if isinstance(array, torch.Tensor):
            masks = tuple(torch.zeros(n, dtype=torch.bool, device=array.device)
                          for n in array.shape)
            return cls(padded_array=array, is_missing=masks, fill_value=fill_value)
        return cls.from_array(array, fill_value=fill_value)

    # -- shape accessors ---------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        """The padded (static) shape."""
        return tuple(self.padded_array.shape)

    @property
    def dtype(self):
        return self.padded_array.dtype

    @property
    def ndim(self) -> int:
        return self.padded_array.ndim

    def true_shape(self) -> Tuple[ArrayLike, ...]:
        """Unpadded extent per axis, as int32 scalars (tensors on the masks'
        device)."""
        return tuple(self.num_valid(axis) for axis in range(len(self.is_missing)))

    def num_valid(self, axis: int = 0) -> ArrayLike:
        valid = ~self.is_missing[axis]
        if isinstance(valid, torch.Tensor):
            return valid.sum().to(torch.int32)
        return np.int32(np.sum(valid))

    def valid_mask(self, axis: int = 0) -> ArrayLike:
        """True where the index along ``axis`` is real data."""
        return ~self.is_missing[axis]

    def joint_valid_mask(self) -> ArrayLike:
        """Full-rank boolean mask, True where every axis index is valid."""
        if not self.is_missing:
            raise ValueError("A 0-d array has no axis to mask.")
        mask = None
        for axis, m in enumerate(self.is_missing):
            shape = [1] * self.ndim
            shape[axis] = self.shape[axis]
            part = (~m).reshape(shape)
            mask = part if mask is None else mask & part
        if isinstance(mask, torch.Tensor):
            return mask.expand(self.shape)
        return np.broadcast_to(mask, self.shape)

    # -- transforms --------------------------------------------------------

    def replace_fill_value(self, fill_value: Any) -> "PaddedArray":
        """Rewrites padding positions to a new fill value."""
        array = self.padded_array
        mask = self.joint_valid_mask()
        if isinstance(array, torch.Tensor):
            fill = torch.as_tensor(fill_value, dtype=array.dtype, device=array.device)
            new = torch.where(torch.as_tensor(mask, device=array.device), array, fill)
        else:
            new = np.where(mask, array, np.asarray(fill_value, dtype=array.dtype))
        return PaddedArray(padded_array=new, is_missing=self.is_missing, fill_value=fill_value)

    def unpad(self) -> ArrayLike:
        """Strips padding (its shape depends on the masks' values, read on
        the host); a tensor's valid block stays on its device."""
        counts = [int(self.num_valid(axis)) for axis in range(len(self.is_missing))]
        return self.padded_array[tuple(slice(0, c) for c in counts)]

    def pad_to(self, target_shape: Tuple[int, ...]) -> "PaddedArray":
        """Re-pads to a larger static shape, on the array's own device."""
        valid = self.unpad()
        if not isinstance(valid, torch.Tensor):
            return PaddedArray.from_array(valid, target_shape, fill_value=self.fill_value)
        _check_target(tuple(valid.shape), target_shape)
        padded = torch.full(tuple(target_shape), self.fill_value, dtype=valid.dtype,
                            device=valid.device)
        padded[tuple(slice(0, n) for n in valid.shape)] = valid
        masks = tuple(torch.arange(want, device=valid.device) >= have
                      for have, want in zip(valid.shape, target_shape))
        return PaddedArray(padded_array=padded, is_missing=masks, fill_value=self.fill_value)

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
