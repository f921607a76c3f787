"""Convergence curves and designer comparators.

Parity with
``vizier/_src/benchmarks/analyzers/convergence_curve.py:35,714,837``:
best-so-far curves extracted from trials, interpolation/alignment across
repeats, and comparators (log-efficiency score, win rate) used by the
statistical convergence tests that gate every algorithm change.

Copy of the JAX package's ``benchmarks/analyzers/convergence_curve.py``, on the port's data model, with the hypervolume curve on the port's Pareto ops.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np
import torch

from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class ConvergenceCurve:
    """ys[b, t]: best objective seen by batch b after t+1 trials."""

    xs: np.ndarray  # [T] trial counts (1-based)
    ys: np.ndarray  # [B, T]
    trend: "ConvergenceCurve.YTrend" = None  # type: ignore[assignment]

    class YTrend(enum.Enum):
        UNKNOWN = "UNKNOWN"
        INCREASING = "INCREASING"
        DECREASING = "DECREASING"

    def __post_init__(self):
        self.xs = np.asarray(self.xs)
        self.ys = np.atleast_2d(np.asarray(self.ys))
        if self.trend is None:
            self.trend = ConvergenceCurve.YTrend.UNKNOWN
        if self.ys.shape[-1] != len(self.xs):
            raise ValueError(f"ys {self.ys.shape} does not match xs {self.xs.shape}.")

    @property
    def num_batches(self) -> int:
        return self.ys.shape[0]

    @classmethod
    def align_xs(
        cls,
        curves: Sequence["ConvergenceCurve"],
        *,
        keep_curves_separate: bool = False,
    ) -> "ConvergenceCurve" | List["ConvergenceCurve"]:
        """Puts curves onto a common x grid (interpolating where needed).

        Default combines all batches into one stacked curve (reference
        ``_align_xs_combine_ys``); ``keep_curves_separate`` returns one
        aligned curve per input (``_align_xs_keep_ys``) — needed when the
        inputs are different algorithms that must not be pooled.
        """
        if not curves:
            raise ValueError("No curves to align.")
        trend = curves[0].trend
        if any(c.trend != trend for c in curves):
            raise ValueError("Cannot align curves with mismatched trends.")
        max_x = max(float(c.xs[-1]) for c in curves)
        xs = np.arange(1, int(max_x) + 1)
        if keep_curves_separate:
            return [
                cls(
                    xs=xs,
                    ys=np.stack([np.interp(xs, c.xs, row) for row in c.ys]),
                    trend=trend,
                )
                for c in curves
            ]
        ys = []
        for c in curves:
            for row in c.ys:
                ys.append(np.interp(xs, c.xs, row))
        return cls(xs=xs, ys=np.stack(ys), trend=trend)

    def interpolate_at(self, xs: np.ndarray) -> "ConvergenceCurve":
        """This curve resampled at arbitrary x positions."""
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.stack([np.interp(xs, self.xs, row) for row in self.ys])
        return ConvergenceCurve(xs=xs, ys=ys, trend=self.trend)

    def extrapolate_ys(self, num_extra_steps: int) -> "ConvergenceCurve":
        """Extends each batch flat at its best-so-far value.

        Reference ``extrapolate_ys`` (``convergence_curve.py:198``): a
        best-so-far curve is a running extremum, so the honest extrapolation
        holds the incumbent — comparators can then align curves from runs of
        different lengths without fabricating progress.
        """
        if num_extra_steps <= 0:
            return self
        step = float(self.xs[-1] - self.xs[-2]) if len(self.xs) > 1 else 1.0
        extra_xs = self.xs[-1] + step * np.arange(1, num_extra_steps + 1)
        extra_ys = np.repeat(self.ys[:, -1:], num_extra_steps, axis=1)
        return ConvergenceCurve(
            xs=np.concatenate([self.xs, extra_xs]),
            ys=np.concatenate([self.ys, extra_ys], axis=1),
            trend=self.trend,
        )

    def percentile_curve(self, percentile: float = 50.0) -> np.ndarray:
        return np.percentile(self.ys, percentile, axis=0)


class ConvergenceCurveConverter:
    """Trials → best-so-far ConvergenceCurve for one objective metric."""

    def __init__(
        self,
        metric_information: base_study_config.MetricInformation,
        *,
        flip_signs_for_min: bool = False,
    ):
        self._metric = metric_information
        self._flip = flip_signs_for_min

    def convert(self, trials: Sequence[trial_.Trial]) -> ConvergenceCurve:
        goal = self._metric.goal
        values = []
        for t in trials:
            usable = (
                t.final_measurement
                and not t.infeasible  # same invariant as MetricsEncoder
                and self._metric.name in t.final_measurement.metrics
            )
            if usable:
                values.append(t.final_measurement.metrics[self._metric.name].value)
            else:
                values.append(np.nan)
        values = np.asarray(values, dtype=np.float64)
        if goal.is_maximize:
            with np.errstate(invalid="ignore"):
                ys = np.fmax.accumulate(np.where(np.isnan(values), -np.inf, values))
            trend = ConvergenceCurve.YTrend.INCREASING
        else:
            with np.errstate(invalid="ignore"):
                ys = np.fmin.accumulate(np.where(np.isnan(values), np.inf, values))
            trend = ConvergenceCurve.YTrend.DECREASING
        if self._flip and goal.is_minimize:
            ys = -ys
            trend = ConvergenceCurve.YTrend.INCREASING
        return ConvergenceCurve(
            xs=np.arange(1, len(values) + 1), ys=ys[None, :], trend=trend
        )


@dataclasses.dataclass
class LogEfficiencyConvergenceCurveComparator:
    """Sample-efficiency score of ``compared`` vs ``baseline``.

    Score ≈ log(baseline trials needed / compared trials needed) to reach the
    same objective quantile: positive = compared is more sample-efficient.
    Curves must share trend (both INCREASING after any flips).
    """

    baseline_curve: ConvergenceCurve

    def score(self, compared: ConvergenceCurve) -> float:
        base = self.baseline_curve
        if base.trend != compared.trend:
            raise ValueError(f"Trend mismatch: {base.trend} vs {compared.trend}.")
        base_med, comp_med = _signed_median_curves(base, compared, align=False)
        # Objective threshold: final median of the baseline.
        target = base_med[-1]
        base_t = _first_index_reaching(base_med, target)
        comp_t = _first_index_reaching(comp_med, target)
        if comp_t is None:
            # Compared never reaches it; score by how far it got in log-ratio
            # of trials at its best value.
            reached = comp_med[-1]
            base_at = _first_index_reaching(base_med, reached)
            if base_at is None:
                return 0.0
            return float(np.log((base_at + 1) / len(comp_med)))
        return float(np.log((base_t + 1) / (comp_t + 1)))


def _first_index_reaching(values: np.ndarray, target: float) -> Optional[int]:
    hits = np.nonzero(values >= target - 1e-12)[0]
    return int(hits[0]) if len(hits) else None


def _signed_median_curves(
    base: ConvergenceCurve, compared: ConvergenceCurve, *, align: bool
):
    """Median curves of both, sign-flipped so bigger is always better.

    ``align=True`` truncates both to the shorter length.
    """
    sign = 1.0 if base.trend == ConvergenceCurve.YTrend.INCREASING else -1.0
    base_med = sign * base.percentile_curve(50.0)
    comp_med = sign * compared.percentile_curve(50.0)
    if align:
        n = min(len(base_med), len(comp_med))
        return base_med[:n], comp_med[:n]
    return base_med, comp_med


@dataclasses.dataclass
class WinRateComparator:
    """Fraction of (baseline, compared) batch pairs where compared wins."""

    baseline_curve: ConvergenceCurve

    def score(self, compared: ConvergenceCurve) -> float:
        base = self.baseline_curve
        sign = 1.0 if base.trend == ConvergenceCurve.YTrend.INCREASING else -1.0
        wins, total = 0, 0
        for b in base.ys:
            for c in compared.ys:
                total += 1
                if sign * c[-1] > sign * b[-1]:
                    wins += 1
        return wins / max(total, 1)


@dataclasses.dataclass
class SimpleRegretComparator:
    """Simple regret vs a known optimum at a fixed trial budget."""

    optimum: float
    goal: base_study_config.ObjectiveMetricGoal

    def regret(self, curve: ConvergenceCurve, at_trial: Optional[int] = None) -> float:
        idx = -1 if at_trial is None else min(at_trial - 1, curve.ys.shape[1] - 1)
        best = np.median(curve.ys[:, idx])
        if self.goal.is_maximize:
            return float(self.optimum - best)
        return float(best - self.optimum)


class HypervolumeCurveConverter:
    """Trials → cumulative-hypervolume curve (multi-objective progress).

    Parity with the reference ``HypervolumeCurveConverter``
    (``convergence_curve.py:714``). The JAX package draws its directions
    from a JAX key; here ``num_vectors`` directions come from a
    ``torch.Generator`` seeded with ``seed`` (``pareto.draw_directions``), and
    the cumulative hypervolume is computed on CPU tensors.
    """

    def __init__(
        self,
        metric_informations: Sequence[base_study_config.MetricInformation],
        *,
        reference_point: Optional[np.ndarray] = None,
        num_vectors: int = 2000,
        seed: int = 0,
    ):
        self._metrics = list(metric_informations)
        self._reference = reference_point
        self._num_vectors = num_vectors
        self._seed = seed

    def convert(self, trials: Sequence[trial_.Trial]) -> ConvergenceCurve:
        if not trials:
            return ConvergenceCurve(
                xs=np.zeros((0,)),
                ys=np.zeros((1, 0)),
                trend=ConvergenceCurve.YTrend.INCREASING,
            )
        rows = []
        for t in trials:
            row = []
            for info in self._metrics:
                usable = (
                    t.final_measurement
                    and not t.infeasible  # same invariant as MetricsEncoder
                    and info.name in t.final_measurement.metrics
                )
                if usable:
                    v = t.final_measurement.metrics[info.name].value
                    row.append(-v if info.goal.is_minimize else v)
                else:
                    row.append(-np.inf)
            rows.append(row)
        points = np.asarray(rows, dtype=np.float32)
        if self._reference is None:
            finite = points[np.all(np.isfinite(points), axis=1)]
            ref = (
                finite.min(axis=0) - 1e-6
                if len(finite)
                else np.zeros(points.shape[1], np.float32)
            )
        else:
            ref = np.asarray(self._reference, np.float32)
        shifted = np.maximum(np.nan_to_num(points - ref[None, :], neginf=0.0), 0.0)
        directions = pareto_ops.draw_directions(
            torch.Generator().manual_seed(self._seed), self._num_vectors, points.shape[1]
        )
        cum = pareto_ops.cum_hypervolume_origin(torch.from_numpy(shifted), directions)
        ys = cum.numpy().astype(np.float64)
        return ConvergenceCurve(
            xs=np.arange(1, len(trials) + 1),
            ys=ys[None, :],
            trend=ConvergenceCurve.YTrend.INCREASING,
        )


@dataclasses.dataclass
class PercentageBetterComparator:
    """Fraction of x-positions where compared's median beats baseline's."""

    baseline_curve: ConvergenceCurve

    def score(self, compared: ConvergenceCurve) -> float:
        base_med, comp_med = _signed_median_curves(
            self.baseline_curve, compared, align=True
        )
        return float(np.mean(comp_med > base_med))


@dataclasses.dataclass
class OptimalityGapComparator:
    """Relative final-gap score of compared vs baseline.

    Reference comparator family (``convergence_curve.py:913`` context):
    both curves' final median distances to the optimum are compared as
    log(baseline_gap / compared_gap) — positive means compared ends closer
    to the optimum; 0 means parity.
    """

    baseline_curve: ConvergenceCurve
    optimum: float

    def score(self, compared: ConvergenceCurve) -> float:
        base_gap = abs(self.optimum - np.median(self.baseline_curve.ys[:, -1]))
        comp_gap = abs(self.optimum - np.median(compared.ys[:, -1]))
        return float(np.log(max(base_gap, 1e-12) / max(comp_gap, 1e-12)))

