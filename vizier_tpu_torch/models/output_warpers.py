"""Label (output) warping for GP robustness.

Parity with
``vizier/_src/algorithms/designers/gp/output_warpers.py``
(half-rank :289, log :381, infeasible :419, z-score :496, normalize :530,
outlier detection :578, gaussianization :666, pipelines :118-230): real
objective scales are pathological (huge outliers, NaN infeasibles, heavy
skew), and the default GP pipeline's robustness depends on taming them.
Host-side numpy (runs once per suggest on a small vector, before padding /
device transfer); the GP then sees bounded, roughly-gaussian labels, which
is what its log-normal hyperparameter priors assume. MAXIMIZE convention.

Warpers are stateful: ``warp`` fits whatever statistics it needs and
``unwarp`` inverts the most recent ``warp`` (used to report predictions in
the original metric scale, e.g. ``VizierGPUCBPEBandit.sample``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import special


def _validate(labels: np.ndarray) -> np.ndarray:
    """Casts to float [N, 1]-compatible, maps -inf to NaN, rejects +inf."""
    labels = np.array(labels, dtype=np.float64)
    if np.isposinf(labels).any():
        raise ValueError("+inf label values are not valid (MAXIMIZE convention).")
    labels[np.isneginf(labels)] = np.nan
    return labels


class OutputWarper(abc.ABC):
    """Maps a [N, 1] label column (NaN = infeasible) to warped values."""

    @abc.abstractmethod
    def warp(self, labels: np.ndarray) -> np.ndarray:
        ...

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        raise NotImplementedError(f"{type(self).__name__} has no unwarp.")

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = _validate(labels)
        squeeze = labels.ndim == 1
        if squeeze:
            labels = labels[:, None]
        out = self.warp(labels)
        return out[:, 0] if squeeze else out


@dataclasses.dataclass
class _HalfRankColumnState:
    """Monotone warped→original lookup for one column's below-median half."""

    original: np.ndarray  # sorted unique original values
    warped: np.ndarray  # their images under the warp (sorted, same order)
    median: float

    def unwarp(self, v: np.ndarray) -> np.ndarray:
        out = np.array(v, dtype=np.float64)
        below = out < self.median
        if not below.any() or len(self.original) < 2:
            return out
        # Piecewise-linear inverse; linear extrapolation below the image.
        lo_w, hi_w = self.warped[0], self.warped[-1]
        lo_o, hi_o = self.original[0], self.original[-1]
        interp = np.interp(out[below], self.warped, self.original)
        span_w = max(hi_w - lo_w, 1e-12)
        extrapolated = lo_o - (np.abs(out[below] - lo_w) / span_w) * (hi_o - lo_o)
        interp = np.where(out[below] < lo_w, extrapolated, interp)
        out[below] = interp
        return out


@dataclasses.dataclass
class HalfRankWarper(OutputWarper):
    """Gaussianizes the below-median half by rank (robust to bad outliers).

    Values >= median are kept; values below are replaced by
    ``median + std * Phi^{-1}(quantile)`` so a catastrophically bad trial
    cannot stretch the GP's length scales. MAXIMIZE convention. NaNs pass
    through untouched.
    """

    _states: Optional[List[Optional[_HalfRankColumnState]]] = None

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        self._states = []
        for j in range(labels.shape[1]):
            y = labels[:, j]
            finite = np.isfinite(y)
            vals = y[finite]
            if len(vals) < 2:
                self._states.append(None)
                continue
            med = np.median(vals)
            upper = vals[vals >= med]
            # Robust scale from the good half; fall back to overall std.
            std = np.sqrt(np.mean((upper - med) ** 2))
            if std <= 1e-12:
                std = np.std(vals) + 1e-12
            ranks = np.argsort(np.argsort(vals))  # 0..n-1
            quantiles = (ranks + 0.5) / len(vals)
            bad = vals < med
            mapped = vals.copy()
            mapped[bad] = med + std * np.sqrt(2.0) * special.erfinv(
                2.0 * quantiles[bad] - 1.0
            )
            out[finite, j] = mapped
            uniq, idx = np.unique(vals, return_index=True)
            self._states.append(
                _HalfRankColumnState(
                    original=uniq, warped=mapped[idx], median=float(med)
                )
            )
        return out

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        if self._states is None:
            raise ValueError("warp() must be called before unwarp().")
        out = labels.copy()
        for j, state in enumerate(self._states):
            if state is None:
                continue
            finite = np.isfinite(out[:, j])
            out[finite, j] = state.unwarp(out[finite, j])
        return out


@dataclasses.dataclass
class LogWarper(OutputWarper):
    """Compresses the range so differences between *good* values dominate.

    Maps finite labels into [-0.5, 0.5] via
    ``0.5 - log1p(norm_diff * (offset-1)) / log(offset)`` where ``norm_diff``
    is the normalized distance from the max — a log scale anchored at the
    best observed value. NaNs pass through.
    """

    offset: float = 1.5
    _mins: Optional[np.ndarray] = None
    _maxs: Optional[np.ndarray] = None

    def warp(self, labels: np.ndarray) -> np.ndarray:
        if self.offset <= 0:
            raise ValueError("offset must be positive.")
        out = labels.copy()
        self._mins = np.nanmin(labels, axis=0)
        self._maxs = np.nanmax(labels, axis=0)
        for j in range(labels.shape[1]):
            y = out[:, j]
            finite = np.isfinite(y)
            if not finite.any():
                continue
            span = max(self._maxs[j] - self._mins[j], 1e-12)
            norm_diff = (self._maxs[j] - y[finite]) / span
            out[finite, j] = 0.5 - np.log1p(
                norm_diff * (self.offset - 1.0)
            ) / np.log(self.offset)
        return out

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        if self._maxs is None:
            raise ValueError("warp() must be called before unwarp().")
        out = labels.copy()
        for j in range(labels.shape[1]):
            y = out[:, j]
            finite = np.isfinite(y)
            if not finite.any():
                continue
            span = max(self._maxs[j] - self._mins[j], 1e-12)
            norm_diff = np.expm1(np.log(self.offset) * (0.5 - y[finite])) / (
                self.offset - 1.0
            )
            out[finite, j] = self._maxs[j] - norm_diff * span
        return out


@dataclasses.dataclass
class ZScoreWarper(OutputWarper):
    """Standardizes finite labels to mean 0 / std 1; invertible."""

    _mu: Optional[np.ndarray] = None
    _sigma: Optional[np.ndarray] = None

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        m = labels.shape[1]
        self._mu = np.zeros(m)
        self._sigma = np.ones(m)
        for j in range(m):
            y = labels[:, j]
            finite = np.isfinite(y)
            if finite.sum() == 0:
                continue
            mu = np.mean(y[finite])
            sigma = np.std(y[finite])
            if sigma <= 1e-12 or not np.isfinite(sigma):
                sigma = 1.0
            self._mu[j], self._sigma[j] = mu, sigma
            out[finite, j] = (y[finite] - mu) / sigma
        return out

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        if self._mu is None:
            raise ValueError("warp() must be called before unwarp().")
        return labels * self._sigma[None, :] + self._mu[None, :]


@dataclasses.dataclass
class NormalizeLabels(OutputWarper):
    """Affine map of finite labels onto ``target_interval`` (invertible).

    All-equal finite labels map to the interval midpoint; NaNs untouched.
    """

    target_interval: Tuple[float, float] = (0.0, 1.0)
    _source: Optional[List[Optional[Tuple[float, float]]]] = None

    def warp(self, labels: np.ndarray) -> np.ndarray:
        lo_t, hi_t = self.target_interval
        if lo_t > hi_t:
            raise ValueError(f"Invalid target interval {self.target_interval}.")
        out = labels.copy()
        self._source = []
        for j in range(labels.shape[1]):
            y = labels[:, j]
            finite = np.isfinite(y)
            if not finite.any():
                self._source.append(None)
                continue
            lo, hi = np.min(y[finite]), np.max(y[finite])
            self._source.append((float(lo), float(hi)))
            if lo == hi:
                out[finite, j] = 0.5 * (lo_t + hi_t)
            else:
                out[finite, j] = lo_t + (y[finite] - lo) * (hi_t - lo_t) / (hi - lo)
        return out

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        if self._source is None:
            raise ValueError("warp() must be called before unwarp().")
        lo_t, hi_t = self.target_interval
        out = labels.copy()
        for j, src in enumerate(self._source):
            if src is None:
                continue
            lo, hi = src
            finite = np.isfinite(out[:, j])
            if lo == hi or hi_t == lo_t:
                out[finite, j] = lo
            else:
                out[finite, j] = lo + (out[finite, j] - lo_t) * (hi - lo) / (
                    hi_t - lo_t
                )
        return out


@dataclasses.dataclass
class InfeasibleWarper(OutputWarper):
    """Imputes NaN (infeasible) labels with a value worse than every real one.

    The imputed value sits half a range below the worst observed label, and
    all feasible labels are shifted so the frequency-weighted mean of the
    warped column is zero — matching a zero-mean GP prior: far from support,
    the posterior reverts to the blended feasible/infeasible expectation
    (reference ``InfeasibleWarperComponent`` docstring, Jeffreys-smoothed
    feasibility frequency).
    """

    _shift: Optional[np.ndarray] = None

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        m = labels.shape[1]
        self._shift = np.zeros(m)
        for j in range(m):
            y = out[:, j]
            finite = np.isfinite(y)
            if finite.sum() == 0:
                self._shift[j] = np.nan
                out[:, j] = 0.0
                continue
            lo, hi = np.min(y[finite]), np.max(y[finite])
            bad_value = lo - (0.5 * (hi - lo) + 1.0)
            # Jeffreys-smoothed feasible frequency: rare feasibles should pull
            # the zero point (GP prior mean) toward the infeasible value.
            p_feasible = (0.5 + finite.sum()) / (1.0 + len(y))
            shift = -np.mean(y[finite]) * p_feasible - bad_value * (1.0 - p_feasible)
            self._shift[j] = shift
            # Shift applies to ALL rows, imputed included, so the
            # frequency-weighted mean of the warped column is exactly zero
            # and unwarp (labels - shift) inverts every row.
            out[~finite, j] = bad_value
            out[:, j] = out[:, j] + shift
        return out

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        if self._shift is None:
            raise ValueError("warp() must be called before unwarp().")
        shift = np.where(np.isnan(self._shift), 0.0, self._shift)
        return labels - shift[None, :]


@dataclasses.dataclass
class DetectOutliers(OutputWarper):
    """Marks unreasonably-bad labels as NaN (outlier → infeasible).

    A label more than ``min_zscore`` estimated stds below the median is an
    outlier (e.g. a -1e76 sentinel in a [1, 10] metric). The std is estimated
    from (median, max, N) only — the bad tail itself must not inflate it —
    using the sample-size-dependent estimator of Hozo et al. (BMC Med. Res.
    Method. 2005) that the reference uses.
    """

    min_zscore: float = 6.0
    max_zscore: Optional[float] = None

    def _estimate_variance(self, vals: np.ndarray) -> float:
        n = len(vals)
        med = float(np.median(vals))
        hi = float(np.max(vals))
        if self.max_zscore:
            return ((hi - med) / self.min_zscore) ** 2
        if n >= 70:
            return ((hi - med) / 3.0) ** 2
        if n >= 15:
            return ((hi - med) / 2.0) ** 2
        # Small-sample range-based estimator (Hozo et al., eq. 12) with the
        # min hallucinated at zero after shifting.
        a = med - hi
        if a < 0:
            a = 0.0
        m, b = med, hi
        out = a**2 + m**2 + b**2
        out += ((n - 3) / 2.0) * ((a + m) ** 2 + (b + m) ** 2) / 4.0
        out -= n * ((a + 2 * m + b) / 4.0 + (a - 2 * m + b) / (4.0 * n)) ** 2
        return out / max(n - 1, 1)

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        for j in range(labels.shape[1]):
            y = out[:, j]
            finite = np.isfinite(y)
            if finite.sum() < 2:
                continue
            vals = y[finite]
            med = np.median(vals)
            std = np.sqrt(max(self._estimate_variance(vals), 1e-24))
            threshold = med - self.min_zscore * std
            vals = np.where(vals < threshold, np.nan, vals)
            out[finite, j] = vals
        return out


def _softclip(x: np.ndarray, low: float, high: float, softness: float) -> np.ndarray:
    """Smooth (differentiable, strictly monotone) clip of x into (low, high)."""
    # Chained softplus hinges: approaches identity away from the bounds.
    y = low + softness * np.logaddexp(0.0, (x - low) / softness)
    return high - softness * np.logaddexp(0.0, (high - y) / softness)


@dataclasses.dataclass
class TransformToGaussian(OutputWarper):
    """Quantile-transforms labels toward N(0, 1).

    Normalizes values (or ranks, with ``use_rank``) to [0, 1], soft-clips
    away from the endpoints, and applies the normal PPF — a non-parametric
    gaussianization suited to GP priors. NaNs pass through.
    """

    softclip_low: float = 1e-10
    softclip_high: float = 1.0 - 1e-10
    softclip_hinge_softness: float = 0.01
    use_rank: bool = False

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        for j in range(labels.shape[1]):
            y = out[:, j]
            finite = np.isfinite(y)
            vals = y[finite]
            if len(vals) < 2:
                continue
            base = np.argsort(np.argsort(vals)).astype(np.float64) if self.use_rank else vals
            span = np.max(base) - np.min(base)
            if span <= 0:
                out[finite, j] = 0.0
                continue
            normalized = (base - np.min(base)) / span
            clipped = _softclip(
                normalized,
                self.softclip_low,
                self.softclip_high,
                self.softclip_hinge_softness,
            )
            out[finite, j] = special.ndtri(np.clip(clipped, 1e-12, 1.0 - 1e-12))
        return out


@dataclasses.dataclass
class WarperPipeline(OutputWarper):
    """Sequential warping with the reference pipeline's edge-case contract.

    All-identical finite labels warp to zeros; all-infeasible labels warp to
    -1s (and those two cases unwarp back to themselves / NaNs).
    """

    warpers: Sequence[OutputWarper] = ()
    # Edge-case fit state: 'normal' | 'constant' (all labels equal; stores
    # the constant) | 'all_nan'. The sub-warpers are NOT fitted in the edge
    # modes, so unwarp must invert from this state, not from them.
    _mode: str = "normal"
    _constant: float = 0.0

    def warp(self, labels: np.ndarray) -> np.ndarray:
        labels = _validate(labels)
        if labels.size == 0:
            self._mode = "normal"
            return labels
        if np.isfinite(labels).all() and len(np.unique(labels)) == 1:
            self._mode = "constant"
            self._constant = float(labels.flat[0])
            return np.zeros_like(labels)
        if np.isnan(labels).all():
            self._mode = "all_nan"
            return -np.ones_like(labels)
        self._mode = "normal"
        for w in self.warpers:
            labels = w.warp(labels)
        return labels

    def unwarp(self, labels: np.ndarray) -> np.ndarray:
        labels = _validate(labels)
        if self._mode == "constant":
            # Warped space was 0 = the constant; shift arbitrary inputs
            # (e.g. GP samples around 0) back by it.
            return labels + self._constant
        if self._mode == "all_nan":
            return np.full_like(labels, np.nan)
        for w in reversed(list(self.warpers)):
            labels = w.unwarp(labels)
        return labels


def create_default_warper(
    *,
    half_rank_warp: bool = True,
    log_warp: bool = True,
    infeasible_warp: bool = True,
) -> WarperPipeline:
    """The reference's default pipeline: half-rank → log → infeasible."""
    if not (half_rank_warp or log_warp or infeasible_warp):
        raise ValueError("At least one warper must be enabled.")
    warpers: List[OutputWarper] = []
    if half_rank_warp:
        warpers.append(HalfRankWarper())
    if log_warp:
        warpers.append(LogWarper())
    if infeasible_warp:
        warpers.append(InfeasibleWarper())
    return WarperPipeline(warpers)


def create_warp_outliers_warper(
    *,
    warp_outliers: bool = True,
    infeasible_warp: bool = True,
    transform_gaussian: bool = True,
) -> WarperPipeline:
    """Outlier-robust pipeline: detect-outliers → infeasible → gaussianize."""
    warpers: List[OutputWarper] = []
    if warp_outliers:
        warpers.append(DetectOutliers())
    if infeasible_warp:
        warpers.append(InfeasibleWarper())
    if transform_gaussian:
        warpers.append(TransformToGaussian())
    return WarperPipeline(warpers)


@dataclasses.dataclass
class YeoJohnsonWarper(OutputWarper):
    """Yeo-Johnson power transform with per-column lambda fit by grid MLE.

    Parity with the reference's ``yjt.py``: gaussianizes skewed label
    distributions; lambda chosen to maximize the normal log-likelihood over
    a grid (robust, derivative-free, a handful of vectorized passes).
    """

    lambdas_grid: Sequence[float] = tuple(np.linspace(-2.0, 4.0, 25))

    @staticmethod
    def _transform(y: np.ndarray, lmbda: float) -> np.ndarray:
        out = np.empty_like(y)
        pos = y >= 0
        if abs(lmbda) > 1e-9:
            out[pos] = ((y[pos] + 1.0) ** lmbda - 1.0) / lmbda
        else:
            out[pos] = np.log1p(y[pos])
        if abs(lmbda - 2.0) > 1e-9:
            out[~pos] = -(((1.0 - y[~pos]) ** (2.0 - lmbda)) - 1.0) / (2.0 - lmbda)
        else:
            out[~pos] = -np.log1p(-y[~pos])
        return out

    def warp(self, labels: np.ndarray) -> np.ndarray:
        out = labels.copy()
        for j in range(labels.shape[1]):
            y = labels[:, j]
            finite = np.isfinite(y)
            vals = y[finite]
            if len(vals) < 3:
                continue
            best_ll, best_t = -np.inf, vals
            for lmbda in self.lambdas_grid:
                t = self._transform(vals, float(lmbda))
                var = np.var(t)
                if var <= 1e-12 or not np.isfinite(var):
                    continue
                # Normal log-likelihood + Jacobian term.
                ll = -0.5 * len(t) * np.log(var) + (lmbda - 1.0) * np.sum(
                    np.sign(vals) * np.log1p(np.abs(vals))
                )
                if ll > best_ll:
                    best_ll, best_t = ll, t
            out[finite, j] = best_t
        return out
