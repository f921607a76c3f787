"""One-sided t-test score for comparing algorithms' simple regrets.

Parity with
``vizier/_src/benchmarks/analyzers/simple_regret_score.py:27``:
the p-value that the baseline's mean final objective is better than the
candidate's. Low score = high confidence the candidate beats the baseline.
Single-candidate inputs use a one-sample t-test against the candidate's
value; otherwise Welch's unequal-variance two-sample test.

Copy of the JAX package's ``benchmarks/analyzers/simple_regret_score.py``, on the port's data model.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import stats

from vizier_tpu_torch.pyvizier import base_study_config


def t_test_mean_score(
    baseline_mean_values: Sequence[float],
    candidate_mean_values: Sequence[float],
    objective_goal: base_study_config.ObjectiveMetricGoal,
) -> float:
    """p-value of the one-sided test that candidate's mean beats baseline's."""
    baseline = np.asarray(baseline_mean_values, dtype=float)
    candidate = np.asarray(candidate_mean_values, dtype=float)
    if objective_goal == base_study_config.ObjectiveMetricGoal.MAXIMIZE:
        alternative = "less"  # confidence that baseline mean < candidate mean
    else:
        alternative = "greater"
    if candidate.size == 1:
        result = stats.ttest_1samp(
            a=baseline, popmean=float(candidate[0]), alternative=alternative
        )
    else:
        result = stats.ttest_ind(
            baseline, candidate, equal_var=False, alternative=alternative
        )
    return float(result.pvalue)
