"""Acquisition functions and the trust region.

Counterpart of the JAX package's ``designers/gp/acquisitions.py``: stateless
functions over posterior (mean, stddev) tensors, all-MAXIMIZE convention
(labels are pre-flipped by the converters).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence

import torch

from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels

Tensor = torch.Tensor

_NORM_CONST = 0.3989422804014327  # 1/sqrt(2*pi)


def _norm_pdf(z: Tensor) -> Tensor:
    return _NORM_CONST * torch.exp(-0.5 * z * z)


def _norm_cdf(z: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def get_best_labels(labels: Tensor, mask: Tensor) -> Tensor:
    """Per-metric maxima over valid rows; labels ``[..., N]``, mask ``[N]``."""
    return torch.amax(torch.where(mask, labels, torch.full_like(labels, float("-inf"))), dim=-1)


def get_worst_labels(labels: Tensor, mask: Tensor) -> Tensor:
    """Per-metric minima over valid rows; labels ``[..., N]``, mask ``[N]``."""
    return torch.amin(torch.where(mask, labels, torch.full_like(labels, float("inf"))), dim=-1)


def get_reference_point(labels: Tensor, mask: Tensor, scale: float = 0.1) -> Tensor:
    """Hypervolume reference point: nadir − scale·range.

    The span is floored at 1.0 (warped labels are ~N(0,1) scale), and with
    no valid rows the point falls back to 0.
    """
    best = get_best_labels(labels, mask)
    worst = get_worst_labels(labels, mask)
    ref = worst - scale * torch.clamp(best - worst, min=1.0)
    return torch.where(torch.isfinite(ref), ref, torch.zeros_like(ref))


class Acquisition(Protocol):
    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        ...


@dataclasses.dataclass(frozen=True)
class UCB:
    """Upper confidence bound: mean + c·stddev."""

    coefficient: float = 1.8

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del best_label
        return mean + self.coefficient * stddev


@dataclasses.dataclass(frozen=True)
class EI:
    """Expected improvement over the best observed label."""

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        z = (mean - best_label) / stddev
        return stddev * (z * _norm_cdf(z) + _norm_pdf(z))


@dataclasses.dataclass(frozen=True)
class PE:
    """Pure exploration: maximize posterior stddev (GP-UCB-PE batches)."""

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del mean, best_label
        return stddev


@dataclasses.dataclass(frozen=True)
class TrustRegion:
    """L∞ trust region around observed points.

    Candidates farther than the trust radius from every observed point are
    penalized linearly; the radius grows with the number of observed trials.
    Built from a flush's stacked data it holds each study's region: radii
    [S], and penalties [S, Q] of [S, Q, ...] queries.
    """

    observed_continuous: Tensor  # [N, Dc] scaled features
    observed_cat: Tensor  # [N, Ds]
    row_mask: Tensor  # [N]
    min_radius: float = 0.2
    penalty_weight: float = 30.0

    @classmethod
    def from_data(cls, data: gp_lib.GPData, **kwargs) -> "TrustRegion":
        return cls(
            observed_continuous=data.continuous,
            observed_cat=data.categorical,
            row_mask=data.row_mask,
            **kwargs,
        )

    def trust_radius(self) -> Tensor:
        n = torch.sum(self.row_mask.to(torch.float32), dim=-1)
        dim = self.observed_continuous.shape[-1] + self.observed_cat.shape[-1]
        # 0.2 → 1.0 as observations accumulate relative to dimension.
        grow = 0.1 * n / max(math.sqrt(float(dim)), 1.0)
        return torch.clamp(self.min_radius + grow * 0.05, max=1.0)

    def linf_distance(self, query: kernels.MixedFeatures) -> Tensor:
        """[M] L∞ distance to the nearest valid observed point.

        Continuous dims only, as the reference's ``min_linf_distance``: a
        categorical mismatch would put every unobserved category outside
        the radius.
        """
        qc = query.continuous
        if qc.shape[-1] == 0:
            return torch.zeros(qc.shape[:-1], device=qc.device)
        linf = torch.amax(
            torch.abs(qc[..., :, None, :] - self.observed_continuous[..., None, :, :]), dim=-1
        )  # [(S,) M, N]
        linf = torch.where(
            self.row_mask[..., None, :], linf, torch.full_like(linf, float("inf"))
        )
        dist = torch.amin(linf, dim=-1)
        # No observations at all -> everything is trusted.
        return torch.where(torch.isfinite(dist), dist, torch.zeros_like(dist))

    def penalty(self, query: kernels.MixedFeatures) -> Tensor:
        excess = torch.clamp(self.linf_distance(query) - self.trust_radius()[..., None], min=0.0)
        return self.penalty_weight * excess


@dataclasses.dataclass(frozen=True)
class ScoringFunction:
    """Predictive + acquisition + optional trust region, as one callable."""

    predictive: gp_lib.EnsemblePredictive
    acquisition: Acquisition
    best_label: Tensor
    trust_region: Optional[TrustRegion] = None

    def score(self, query: kernels.MixedFeatures) -> Tensor:
        mean, stddev = self.predictive.predict(query)
        values = self.acquisition(mean, stddev, self.best_label)
        if self.trust_region is not None:
            values = values - self.trust_region.penalty(query)
        return values


@dataclasses.dataclass(frozen=True)
class HVScalarizedScoring:
    """Multi-objective scoring: random-direction HV scalarization of UCB.

    Per-metric UCB values are scalarized along K random positive directions
    as min_m((ucb_m − ref_m)_+ / v_m)^M and averaged over the directions.
    Each metric's state holds one parameter set over its own data (its own
    row mask), so each predict is its own K1 launch.
    """

    metric_states: Sequence[gp_lib.GPState]  # one per objective, batch 1 each
    directions: Tensor  # [K, M] positive unit vectors
    reference_point: Tensor  # [M]
    ucb_coefficient: float = 1.8
    trust_region: Optional[TrustRegion] = None

    def score(self, query: kernels.MixedFeatures) -> Tensor:
        predictions = [s.predict(query) for s in self.metric_states]  # ([1, Q], [1, Q]) each
        means = torch.cat([mean for mean, _ in predictions])
        stddevs = torch.cat([std for _, std in predictions])
        ucb = means + self.ucb_coefficient * stddevs  # [M, Q]
        m = ucb.shape[0]
        shifted = torch.clamp(ucb - self.reference_point[:, None], min=0.0)
        ratios = shifted[None, :, :] / torch.clamp(self.directions[:, :, None], min=1e-12)
        values = torch.mean(torch.amin(ratios, dim=1) ** m, dim=0)  # [Q]
        if self.trust_region is not None:
            values = values - self.trust_region.penalty(query)
        return values
