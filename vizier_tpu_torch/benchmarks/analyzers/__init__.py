"""Benchmark analyzers: convergence curves, comparators, scores, records."""

from vizier_tpu_torch.benchmarks.analyzers.convergence_curve import (
    ConvergenceCurve,
    ConvergenceCurveConverter,
    HypervolumeCurveConverter,
)
from vizier_tpu_torch.benchmarks.analyzers.exploration_score import (
    compute_average_marginal_parameter_entropy,
    compute_parameter_entropy,
)
from vizier_tpu_torch.benchmarks.analyzers.simple_regret_score import t_test_mean_score
