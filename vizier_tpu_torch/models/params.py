"""GP hyperparameter specs, constraints, and bijectors.

Counterpart of the JAX package's ``models/params.py``: a model declares a flat list
of ``ParameterSpec``s; hyperparameters live as a dict of unconstrained
tensors that optimizers treat as a plain vector, and
``constrain``/``unconstrain`` map through smooth sigmoid soft-clip bijectors.
Every function takes values with any number of leading batch dims
(restarts, ensemble members) ahead of the spec's own shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _sum_trailing(t: Tensor, ndim: int) -> Tensor:
    """Sums ``t`` over its last ``ndim`` dims."""
    return t.sum(dim=tuple(range(t.dim() - ndim, t.dim()))) if ndim else t


@dataclasses.dataclass(frozen=True)
class SoftClip:
    """Smooth bijector from R onto (low, high) via a scaled sigmoid.

    ``forward(0)`` lands at the geometric (log-space) midpoint for positive
    ranges, which keeps default inits well-scaled.
    """

    low: float
    high: float
    log_space: bool = True  # interpolate in log space (positive ranges)

    def forward(self, x: Tensor) -> Tensor:
        s = torch.sigmoid(x)
        if self.log_space and self.low > 0:
            lo, hi = float(np.log(self.low)), float(np.log(self.high))
            return torch.exp(lo + (hi - lo) * s)
        return self.low + (self.high - self.low) * s

    def inverse(self, y: Tensor) -> Tensor:
        eps = 1e-6
        if self.log_space and self.low > 0:
            lo, hi = float(np.log(self.low)), float(np.log(self.high))
            s = (torch.log(y) - lo) / (hi - lo)
        else:
            s = (y - self.low) / (self.high - self.low)
        s = torch.clamp(s, eps, 1.0 - eps)
        return torch.log(s) - torch.log1p(-s)


@dataclasses.dataclass(frozen=True)
class ParameterSpec:
    """One hyperparameter: shape, constraint, init distribution, regularizer.

    ``init_low/high``: constrained-space log-uniform init range for random
    restarts. ``prior_mu/sigma``: log-normal regularizer
    0.5*((log(v) - mu)/sigma)^2 summed over elements.

    ``linear=True`` samples uniformly in linear space and regularizes with a
    plain Gaussian 0.5*((v - mu)/sigma)^2: signed parameters (the
    multi-task GP's Cholesky off-diagonals) need it. ``regularize=False``
    drops the per-spec penalty (a Uniform prior, or one the model adds).
    """

    name: str
    shape: Tuple[int, ...]
    bijector: SoftClip
    init_low: float
    init_high: float
    prior_mu: float = 0.0
    prior_sigma: float = 1.0
    linear: bool = False
    regularize: bool = True

    def sample_constrained(self, generator: torch.Generator, batch: int) -> Tensor:
        u = torch.rand(
            (batch,) + self.shape, generator=generator, device=generator.device,
            dtype=torch.float32,
        )
        if self.linear:
            return self.init_low + (self.init_high - self.init_low) * u
        lo, hi = float(np.log(self.init_low)), float(np.log(self.init_high))
        return torch.exp(lo + (hi - lo) * u)

    def regularizer(self, constrained_value: Tensor) -> Tensor:
        ndim = len(self.shape)
        if not self.regularize:
            batch = constrained_value.shape[: constrained_value.dim() - ndim]
            return torch.zeros(batch, device=constrained_value.device)
        if self.linear:
            z = (constrained_value - self.prior_mu) / self.prior_sigma
        else:
            z = (torch.log(constrained_value) - self.prior_mu) / self.prior_sigma
        return 0.5 * _sum_trailing(z * z, ndim)


@dataclasses.dataclass(frozen=True)
class ParameterCollection:
    """A model's full hyperparameter declaration."""

    specs: Tuple[ParameterSpec, ...]

    def spec(self, name: str) -> ParameterSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)

    def batch_random_init_unconstrained(
        self, generator: torch.Generator, batch: int
    ) -> Params:
        """[batch, ...]-leading random inits in unconstrained space."""
        return {
            s.name: s.bijector.inverse(s.sample_constrained(generator, batch))
            for s in self.specs
        }

    def random_init_unconstrained(self, generator: torch.Generator) -> Params:
        """One random init (no batch axis)."""
        return {
            k: v[0] for k, v in self.batch_random_init_unconstrained(generator, 1).items()
        }

    def constrain(self, unconstrained: Params) -> Params:
        return {s.name: s.bijector.forward(unconstrained[s.name]) for s in self.specs}

    def unconstrain(self, constrained: Params) -> Params:
        return {
            s.name: s.bijector.inverse(constrained[s.name].to(torch.float32))
            for s in self.specs
        }

    def regularization(self, constrained: Params) -> Tensor:
        return sum(s.regularizer(constrained[s.name]) for s in self.specs)
