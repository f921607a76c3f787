"""Classic low-dimensional test objectives: Branin, Hartmann, multi-arm.

Parity with the reference's
``benchmarks/experimenters/synthetic/branin.py:51`` (Branin2DExperimenter),
``synthetic/hartmann.py:34`` (HartmannExperimenter + 3D/6D presets) and
``synthetic/multiarm.py:40,61`` (Bernoulli/Fixed multi-arm bandits), built
on this repo's batched ``NumpyExperimenter``.

Copy of the JAX package's ``benchmarks/experimenters/synthetic/classic.py``, on the port's data model; numpy only.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

MetricInformation = base_study_config.MetricInformation
ObjectiveMetricGoal = base_study_config.ObjectiveMetricGoal
ProblemStatement = base_study_config.ProblemStatement


def branin(x: np.ndarray) -> np.ndarray:
    """Branin-Hoo function, batched ``[..., 2] -> [...]`` (minimize).

    Global minimum 0.397887 at (-pi, 12.275), (pi, 2.275), (9.42478, 2.475).
    """
    x1, x2 = x[..., 0], x[..., 1]
    b = 5.1 / (4.0 * np.pi**2)
    c = 5.0 / np.pi
    t = 1.0 / (8.0 * np.pi)
    return (x2 - b * x1**2 + c * x1 - 6.0) ** 2 + 10.0 * (1.0 - t) * np.cos(x1) + 10.0


class Branin2DExperimenter(base.NumpyExperimenter):
    """2-D Branin minimization over x1 in [-5, 10], x2 in [0, 15]."""

    def __init__(self):
        problem = ProblemStatement()
        problem.search_space.root.add_float_param("x1", -5.0, 10.0)
        problem.search_space.root.add_float_param("x2", 0.0, 15.0)
        problem.metric_information.append(
            MetricInformation(name="value", goal=ObjectiveMetricGoal.MINIMIZE)
        )
        super().__init__(branin, problem)


# Published Hartmann constants (https://www.sfu.ca/~ssurjano/hart3.html, hart6.html).
_HARTMANN_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_HARTMANN3_A = np.array(
    [[3, 10, 30], [0.1, 10, 35], [3, 10, 30], [0.1, 10, 35]], dtype=float
)
_HARTMANN3_P = 1e-4 * np.array(
    [[3689, 1170, 2673], [4699, 4387, 7470], [1091, 8732, 5547], [381, 5743, 8828]],
    dtype=float,
)
_HARTMANN6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ],
    dtype=float,
)
_HARTMANN6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ],
    dtype=float,
)


class HartmannExperimenter(base.NumpyExperimenter):
    """Hartmann family minimization over the unit hypercube (batched)."""

    def __init__(self, alpha: np.ndarray, a: np.ndarray, p: np.ndarray):
        alpha = np.asarray(alpha, float)
        a = np.asarray(a, float)
        p = np.asarray(p, float)
        dim = a.shape[-1]

        def impl(x: np.ndarray) -> np.ndarray:
            # x: [N, D]; inner exponent over the 4 Hartmann terms.
            sq = np.sum(a[None] * (x[:, None, :] - p[None]) ** 2, axis=-1)  # [N, 4]
            return -np.exp(-sq) @ alpha

        problem = ProblemStatement()
        for i in range(1, dim + 1):
            problem.search_space.root.add_float_param(f"x{i}", 0.0, 1.0)
        problem.metric_information.append(
            MetricInformation(name="value", goal=ObjectiveMetricGoal.MINIMIZE)
        )
        super().__init__(impl, problem)

    @classmethod
    def from_3d(cls) -> "HartmannExperimenter":
        """3-D Hartmann; minimum -3.86278 at (0.114614, 0.555649, 0.852547)."""
        return cls(_HARTMANN_ALPHA, _HARTMANN3_A, _HARTMANN3_P)

    @classmethod
    def from_6d(cls) -> "HartmannExperimenter":
        """6-D Hartmann; minimum -3.32237."""
        return cls(_HARTMANN_ALPHA, _HARTMANN6_A, _HARTMANN6_P)


def _multiarm_problem(arms: Sequence[str]) -> ProblemStatement:
    problem = ProblemStatement()
    problem.search_space.root.add_categorical_param("arm", feasible_values=list(arms))
    problem.metric_information.append(
        MetricInformation(name="reward", goal=ObjectiveMetricGoal.MAXIMIZE)
    )
    return problem


class BernoulliMultiArmExperimenter(base.Experimenter):
    """1-D categorical bandit: each arm pays 1 with its own probability."""

    def __init__(
        self, arms_to_probs: Mapping[str, float], seed: Optional[int] = None
    ):
        self._arms_to_probs = dict(arms_to_probs)
        self._rng = np.random.default_rng(seed)

    def problem_statement(self) -> ProblemStatement:
        return _multiarm_problem(self._arms_to_probs)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            prob = self._arms_to_probs[str(t.parameters.get_value("arm"))]
            reward = float(self._rng.random() < prob)
            t.complete(trial_.Measurement(metrics={"reward": reward}))


class FixedMultiArmExperimenter(base.Experimenter):
    """1-D categorical bandit with deterministic per-arm rewards."""

    def __init__(self, arms_to_rewards: Mapping[str, float]):
        self._arms_to_rewards = dict(arms_to_rewards)

    def problem_statement(self) -> ProblemStatement:
        return _multiarm_problem(self._arms_to_rewards)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            reward = float(self._arms_to_rewards[str(t.parameters.get_value("arm"))])
            t.complete(trial_.Measurement(metrics={"reward": reward}))
