"""Benchmark analyzers: convergence curves, comparators and scores."""

from vizier_tpu_torch.benchmarks.analyzers.convergence_curve import (
    ConvergenceCurve,
    ConvergenceCurveConverter,
    HypervolumeCurveConverter,
)
from vizier_tpu_torch.benchmarks.analyzers.simple_regret_score import t_test_mean_score
