"""Exploration scores: how thoroughly an algorithm covers the search space.

Parity with
``vizier/_src/benchmarks/analyzers/exploration_score_utils.py:29,99``:
marginal entropy of suggested parameter values (categorical/discrete/integer
by exact counts, continuous by cube-root-rule histogram bins), averaged over
all parameters of all studies in a benchmark-results mapping.

Copy of the JAX package's ``benchmarks/analyzers/exploration_score.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import study as study_
from vizier_tpu_torch.pyvizier import trial as trial_

# algorithm -> experimenter/spec -> seed -> study
BenchmarkResults = Dict[str, Dict[str, Dict[int, study_.ProblemAndTrials]]]


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(float)
    if p.size == 0:
        return 0.0
    p = p / p.sum()
    return float(-np.sum(p * np.log(p)))


def compute_parameter_entropy(
    parameter_config: pc.ParameterConfig,
    parameter_values: Iterable[Optional[trial_.ParameterValue]],
) -> float:
    """Entropy (nats) of one parameter's suggested values.

    Comparing two runs is only meaningful at equal sample sizes — the
    histogram/bin estimator's bias depends on n.
    """
    values = [pv.value for pv in parameter_values if pv is not None]
    if not values:
        return 0.0
    ptype = parameter_config.type
    if ptype in (pc.ParameterType.CATEGORICAL, pc.ParameterType.DISCRETE):
        feasible = set(parameter_config.feasible_values)
        bad = [v for v in values if v not in feasible]
        if bad:
            raise ValueError(
                f"Out-of-bound values {bad[:5]} for {parameter_config.name}; "
                f"feasible: {sorted(feasible)}"
            )
        _, counts = np.unique(np.asarray(values, dtype=object), return_counts=True)
        return _entropy(counts)
    lo, hi = parameter_config.bounds
    arr = np.asarray(values, dtype=float)
    if np.any(arr < lo) or np.any(arr > hi):
        raise ValueError(
            f"Out-of-bound values for {parameter_config.name}: bounds [{lo}, {hi}]"
        )
    if ptype == pc.ParameterType.INTEGER:
        _, counts = np.unique(arr, return_counts=True)
        return _entropy(counts)
    # Continuous: fixed-width bins, count ~ c * n^(1/3) (cube-root rules),
    # c chosen so n=100 gives ~30 bins; never more bins than samples.
    n = len(arr)
    c = 30.0 / (100.0 ** (1.0 / 3.0))
    num_bins = min(int(c * n ** (1.0 / 3.0)), n)
    num_bins = max(num_bins, 1)
    counts, _ = np.histogram(arr, bins=np.linspace(lo, hi, num=num_bins + 1))
    return _entropy(counts)


def compute_average_marginal_parameter_entropy(results: BenchmarkResults) -> float:
    """Mean marginal entropy over every parameter of every study in results."""
    entropies = []
    for spec_results in results.values():
        for seed_results in spec_results.values():
            for study in seed_results.values():
                for config in study.problem.search_space.parameters:
                    values = [t.parameters.get(config.name) for t in study.trials]
                    entropies.append(compute_parameter_entropy(config, values))
    if not entropies:
        return 0.0
    return float(np.mean(entropies))
