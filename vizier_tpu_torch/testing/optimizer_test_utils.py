"""Smoke assertions for gradient-free acquisition optimizers.

The port's copy of the JAX package's ``testing/optimizer_test_utils.py``:
optimize a random score over a search space and assert suggestions are
produced and contained in the space.
"""

from __future__ import annotations

import numpy as np

from vizier_tpu_torch.optimizers import base as optimizer_base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc


def assert_passes_on_random_single_metric_function(
    search_space: pc.SearchSpace,
    optimizer: optimizer_base.GradientFreeOptimizer,
    *,
    np_random_seed: int,
    count: int = 5,
) -> None:
    """Optimizer produces in-space suggestions for a random single objective."""
    rng = np.random.default_rng(np_random_seed)
    problem = base_study_config.ProblemStatement(search_space=search_space)
    problem.metric_information.append(
        base_study_config.MetricInformation(
            name="acquisition", goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE
        )
    )

    def mock_score(trials):
        return {"acquisition": rng.uniform(size=[len(trials), 1])}

    suggestions = optimizer.optimize(mock_score, problem, count=count)
    assert suggestions, "optimizer returned no suggestions"
    for suggestion in suggestions:
        search_space.assert_contains(suggestion.parameters)


def assert_passes_on_random_multi_metric_function(
    search_space: pc.SearchSpace,
    optimizer: optimizer_base.GradientFreeOptimizer,
    *,
    np_random_seed: int,
    count: int = 5,
) -> None:
    """Same, with a random bi-objective score."""
    rng = np.random.default_rng(np_random_seed)
    problem = base_study_config.ProblemStatement(search_space=search_space)
    for name in ("acquisition_1", "acquisition_2"):
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name=name, goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE
            )
        )

    def mock_score(trials):
        return {
            "acquisition_1": rng.uniform(size=[len(trials), 1]),
            "acquisition_2": rng.uniform(size=[len(trials), 1]),
        }

    suggestions = optimizer.optimize(mock_score, problem, count=count)
    assert suggestions, "optimizer returned no suggestions"
    for suggestion in suggestions:
        search_space.assert_contains(suggestion.parameters)
