"""Convergence-curve plotting.

Parity with the reference's benchmark plotting utilities
(``analyzers/plot_utils.py``): median curves with interquartile bands per
algorithm, on a caller-supplied or fresh matplotlib axis.

Copy of the JAX package's ``benchmarks/analyzers/plot_utils.py``; matplotlib
is imported when a plot is drawn.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as cc


def plot_median_convergence(
    curves_by_algorithm: Dict[str, cc.ConvergenceCurve],
    *,
    ax=None,
    title: str = "",
    ylabel: str = "best objective",
    percentiles: Sequence[float] = (25.0, 75.0),
    log_x: bool = False,
):
    """Plots each algorithm's median curve with a percentile band."""
    import matplotlib.pyplot as plt

    if len(percentiles) != 2:
        raise ValueError(f"percentiles must be a (low, high) pair, got {percentiles}.")
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4.5))
    for name, curve in curves_by_algorithm.items():
        median = curve.percentile_curve(50.0)
        (line,) = ax.plot(curve.xs, median, label=name)
        if curve.num_batches > 1:
            lo = curve.percentile_curve(percentiles[0])
            hi = curve.percentile_curve(percentiles[1])
            ax.fill_between(curve.xs, lo, hi, alpha=0.2, color=line.get_color())
    if log_x:
        ax.set_xscale("log")
    ax.set_xlabel("trials")
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    return ax


def plot_states(
    states,
    *,
    algorithm_names: Optional[Sequence[str]] = None,
    ax=None,
    title: str = "",
):
    """Plots benchmark states directly (states → curves → plot)."""
    from vizier_tpu_torch.benchmarks.analyzers.state_analyzer import BenchmarkStateAnalyzer

    records = BenchmarkStateAnalyzer.to_records(
        states, algorithm_names=algorithm_names
    )
    # Repeats of the same algorithm stack into one multi-batch curve (so the
    # percentile band reflects run-to-run variation).
    grouped: Dict[str, list] = {}
    for r in records:
        grouped.setdefault(r["algorithm"], []).append(r)
    curves = {}
    for name, group in grouped.items():
        aligned = cc.ConvergenceCurve.align_xs(
            [
                cc.ConvergenceCurve(
                    xs=r["curve_xs"],
                    ys=np.asarray(r["curve_ys"])[None, :],
                    trend=cc.ConvergenceCurve.YTrend.INCREASING,
                )
                for r in group
            ]
        )
        curves[name] = aligned
    return plot_median_convergence(curves, ax=ax, title=title)
