"""Multi-objective scalarizers.

Counterpart of the JAX package's ``designers/scalarization.py``: linear,
Chebyshev (augmented), and hypervolume scalarizations mapping [..., M]
objective vectors to scalars (all-MAXIMIZE convention), as functions on
tensors that run on the objectives' device and in their dtype. Weights,
reference point and ``rho`` are cast to that dtype first, and the sums over
the objectives run left to right, so float32 inputs give the JAX package's
float32 values bit for bit.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


def _constant(values, like: Tensor) -> Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _sum_last(x: Tensor) -> Tensor:
    """Sum over the last axis, left to right."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def _integer_pow(x: Tensor, exponent: int) -> Tensor:
    """``x ** exponent`` by repeated squaring, the multiplications in the
    order of XLA's integer power."""
    acc = None
    while exponent > 0:
        if exponent & 1:
            acc = x if acc is None else acc * x
        exponent >>= 1
        if exponent > 0:
            x = x * x
    return acc if acc is not None else torch.ones_like(x)


class Scalarization(abc.ABC):
    """Maps [..., M] objectives to [...] scalars (bigger = better)."""

    @abc.abstractmethod
    def __call__(self, objectives: Tensor) -> Tensor:
        ...


@dataclasses.dataclass(frozen=True)
class LinearScalarization(Scalarization):
    weights: tuple

    def __call__(self, objectives: Tensor) -> Tensor:
        return _sum_last(objectives * _constant(self.weights, objectives))


@dataclasses.dataclass(frozen=True)
class ChebyshevScalarization(Scalarization):
    """Augmented Chebyshev: min_j w_j (f_j - ref_j) + rho * sum_j w_j f_j."""

    weights: tuple
    reference_point: Optional[tuple] = None
    rho: float = 0.05

    def __call__(self, objectives: Tensor) -> Tensor:
        w = _constant(self.weights, objectives)
        ref = (
            _constant(self.reference_point, objectives)
            if self.reference_point is not None
            else torch.zeros_like(w)
        )
        weighted = w * (objectives - ref)
        return torch.amin(weighted, dim=-1) + _constant(self.rho, objectives) * _sum_last(weighted)


@dataclasses.dataclass(frozen=True)
class HyperVolumeScalarization(Scalarization):
    """Random-direction HV scalarization: min_j ((f_j - ref_j)_+ / w_j)^M.

    Averaging this over random positive directions w estimates hypervolume
    (the scalarization of the multi-objective GP bandit).
    """

    weights: tuple
    reference_point: Optional[tuple] = None

    def __call__(self, objectives: Tensor) -> Tensor:
        w = _constant(self.weights, objectives)
        ref = (
            _constant(self.reference_point, objectives)
            if self.reference_point is not None
            else torch.zeros_like(w)
        )
        ratios = torch.clamp(objectives - ref, min=0.0) / torch.clamp(w, min=1e-12)
        return _integer_pow(torch.amin(ratios, dim=-1), objectives.shape[-1])


def random_hv_directions(
    generator: Optional[torch.Generator],
    num: int,
    num_objectives: int,
    *,
    normals: Optional[Tensor] = None,
) -> Tensor:
    """[num, M] positive unit directions for HV scalarization ensembles.

    The standard normals come from ``generator`` (on its device), or are
    given as ``normals`` (``[num, M]``), e.g. another package's draws.
    """
    if normals is None:
        normals = torch.randn((num, num_objectives), generator=generator,
                              device=generator.device, dtype=torch.float32)
    v = torch.abs(normals)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)
