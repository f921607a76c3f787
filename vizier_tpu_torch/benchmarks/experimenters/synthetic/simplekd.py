"""SimpleKD: a mixed-type testing objective with a known optimum.

The port's copy of the JAX package's
``benchmarks/experimenters/synthetic/simplekd.py``: a smooth objective over
one categorical, one discrete, one integer, and k float parameters, with a
known optimum, used by convergence tests to check that designers actually
optimize mixed spaces (not just continuous ones).

MAXIMIZE convention; optimum value is 0.0, attained at
``corner='corner'``, ``discrete=2``, ``int=2``, and every float at the
``best_category``-dependent optimum location.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

_CATEGORIES = ("corner", "center", "mixed")
_DISCRETE = (1.0, 2.0, 5.0)
_INT_RANGE = (1, 4)
_FLOAT_RANGE = (-1.0, 1.0)
# Per-category optimum location of the float block.
_FLOAT_OPT = {"corner": -0.8, "center": 0.0, "mixed": 0.4}


class SimpleKDExperimenter(base.Experimenter):
    """-(loss) objective with a known optimum at value 0."""

    def __init__(self, best_category: str = "corner", *, num_float_params: int = 2):
        if best_category not in _CATEGORIES:
            raise ValueError(f"best_category must be one of {_CATEGORIES}.")
        self._best_category = best_category
        self._num_floats = num_float_params
        problem = base_study_config.ProblemStatement()
        root = problem.search_space.root
        root.add_categorical_param("categorical", list(_CATEGORIES))
        root.add_discrete_param("discrete", list(_DISCRETE))
        root.add_int_param("int", *_INT_RANGE)
        for i in range(num_float_params):
            root.add_float_param(f"float_{i}", *_FLOAT_RANGE)
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name="value", goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE
            )
        )
        self._problem = problem

    @property
    def optimal_value(self) -> float:
        return 0.0

    def optimal_trial(self) -> trial_.Trial:
        params = {"categorical": self._best_category, "discrete": 2.0, "int": 2}
        for i in range(self._num_floats):
            params[f"float_{i}"] = _FLOAT_OPT[self._best_category]
        return trial_.Trial(parameters=params)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            cat = str(t.parameters.get_value("categorical"))
            disc = float(t.parameters.get_value("discrete"))
            ival = int(t.parameters.get_value("int"))
            floats = np.asarray(
                [float(t.parameters.get_value(f"float_{i}")) for i in range(self._num_floats)]
            )
            loss = 0.0
            if cat != self._best_category:
                loss += 1.0
            loss += 0.5 * (np.log(disc) - np.log(2.0)) ** 2
            loss += 0.3 * (ival - 2) ** 2
            loss += float(np.sum((floats - _FLOAT_OPT[cat]) ** 2))
            t.complete(trial_.Measurement(metrics={"value": -loss}))

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem
