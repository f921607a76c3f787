"""Acquisition functions and the trust region.

Counterpart of the JAX package's ``designers/gp/acquisitions.py``: stateless
functions over posterior (mean, stddev) tensors, all-MAXIMIZE convention
(labels are pre-flipped by the converters).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence, Union

import torch

from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels

Tensor = torch.Tensor

_NORM_CONST = 0.3989422804014327  # 1/sqrt(2*pi)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# Random numbers come from a generator, or are given (a test feeds the JAX
# package's draws).
Draws = Union[torch.Generator, Tensor]


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
class LCB:
    """Lower confidence bound: mean − c·stddev."""

    coefficient: float = 1.8

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del best_label
        return mean - self.coefficient * stddev


@dataclasses.dataclass(frozen=True)
class EI:
    """Expected improvement over the best observed label."""

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        z = (mean - best_label) / stddev
        return stddev * (z * _norm_cdf(z) + _norm_pdf(z))


@dataclasses.dataclass(frozen=True)
class LogEI:
    """log(EI): the same argmax as EI, without its float32 underflow.

    log(s·h(z)), h(z) = zΦ(z) + φ(z), in three regimes, each on a clipped
    copy of z so the unused ones stay finite: directly for z > −1; for
    −10 < z ≤ −1 as log φ(z) + log1p(zΦ(z)/φ(z)), the ratio formed in log
    space through ``log_ndtr``; below −10 the asymptote h ≈ φ(z)(z²−3)/z⁴.
    """

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        z = (mean - best_label) / stddev
        zd = torch.clamp(z, min=-1.5)
        direct = torch.log(zd * _norm_cdf(zd) + _norm_pdf(zd))
        zm = torch.clamp(z, -12.0, -0.5)
        log_phi_m = -0.5 * zm * zm - _LOG_SQRT_2PI
        t = torch.log(-zm) + torch.special.log_ndtr(zm) - log_phi_m
        ratio = -torch.exp(torch.clamp(t, max=0.0))
        mills = log_phi_m + torch.log1p(torch.clamp(ratio, min=-0.9999999))
        zt = torch.clamp(z, max=-4.0)
        tail = -0.5 * zt * zt - _LOG_SQRT_2PI + torch.log(zt * zt - 3.0) - 2.0 * torch.log(zt * zt)
        return torch.where(z > -1.0, direct, torch.where(z > -10.0, mills, tail)) + torch.log(
            stddev)


@dataclasses.dataclass(frozen=True)
class PI:
    """Probability of improvement."""

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        return _norm_cdf((mean - best_label) / stddev)


@dataclasses.dataclass(frozen=True)
class PE:
    """Pure exploration: maximize posterior stddev (GP-UCB-PE batches)."""

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del mean, best_label
        return stddev


@dataclasses.dataclass(frozen=True)
class Sample:
    """Thompson sampling via one marginal posterior sample.

    Every call draws the same standard normals: a generator seeded with
    ``seed`` on the posterior's device.
    """

    seed: int = 0

    def draws(self, shape, device: torch.device) -> Tensor:
        generator = torch.Generator(device=device).manual_seed(self.seed)
        return torch.randn(shape, generator=generator, device=device)

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del best_label
        return self.apply(mean, stddev, self.draws(mean.shape, mean.device))

    @staticmethod
    def apply(mean: Tensor, stddev: Tensor, eps: Tensor) -> Tensor:
        return mean + stddev * eps


def _normals(draws: Draws, shape, like: Tensor) -> Tensor:
    if isinstance(draws, torch.Generator):
        return torch.randn(shape, generator=draws, dtype=like.dtype, device=like.device)
    return draws.to(like.device, like.dtype)


def q_acquisition(
    per_member_means: Tensor,  # [E, M]
    per_member_stddevs: Tensor,  # [E, M]
    draws: Draws,
    *,
    best_label: Tensor,
    num_samples: int = 32,
    kind: str = "qei",
) -> Tensor:
    """Monte-Carlo q-style score per point over member × posterior draws.

    ``draws`` is a generator or the [num_samples, E, M] standard normals.
    Kinds: ``qei`` (mean improvement over ``best_label``), ``qpi`` (share of
    draws above it), ``qucb`` (draw mean + 1.8 draw stddev).
    """
    e, m = per_member_means.shape
    eps = _normals(draws, (num_samples, e, m), per_member_means)
    samples = (per_member_means[None] + per_member_stddevs[None] * eps).reshape(-1, m)
    if kind == "qei":
        return torch.mean(torch.clamp(samples - best_label, min=0.0), dim=0)
    if kind == "qpi":
        return torch.mean((samples > best_label).to(samples.dtype), dim=0)
    if kind == "qucb":
        return torch.mean(samples, dim=0) + 1.8 * torch.std(samples, dim=0, unbiased=False)
    raise ValueError(f"Unknown q-acquisition {kind!r}.")


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


@dataclasses.dataclass(frozen=True)
class MaxValueEntropySearch:
    """Max-value entropy search over Gumbel-sampled optimum values.

    The optimum value y* is drawn from a Gumbel fitted to the posterior's
    marginals at the observed points; the score is the mutual information
    between a candidate's value and y*.
    """

    y_star_samples: Tensor  # [K] sampled optimum values

    @classmethod
    def from_predictive(
        cls, predictive, observed: kernels.MixedFeatures, draws: Draws, *, num_samples: int = 16,
    ) -> "MaxValueEntropySearch":
        """``draws`` is a generator or the [num_samples] uniforms in
        [float32 tiny, 1)."""
        mean, stddev = predictive.predict(observed)
        upper = torch.amax(mean + 3.0 * stddev)
        lower = torch.amax(mean)
        scale = torch.clamp((upper - lower) / 3.0, min=1e-3)
        if isinstance(draws, torch.Generator):
            tiny = torch.finfo(torch.float32).tiny
            u = torch.rand((num_samples,), generator=draws, device=mean.device)
            u = torch.clamp(u * (1.0 - tiny) + tiny, min=tiny)
        else:
            u = draws.to(mean.device, mean.dtype)
        return cls(y_star_samples=lower - scale * torch.log(-torch.log(u)))

    def __call__(self, mean: Tensor, stddev: Tensor, best_label: Tensor) -> Tensor:
        del best_label
        z = (self.y_star_samples[:, None] - mean[None, :]) / stddev[None, :]  # [K, Q]
        pdf = _norm_pdf(z)
        cdf = torch.clamp(_norm_cdf(z), 1e-9, 1.0 - 1e-9)
        # MI ≈ E_y*[ z φ(z) / (2 Φ(z)) − log Φ(z) ].
        return torch.mean(z * pdf / (2.0 * cdf) - torch.log(cdf), dim=0)
