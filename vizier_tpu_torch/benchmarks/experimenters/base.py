"""Experimenter ABC and numpy-function experimenter.

Parity with
``vizier/_src/benchmarks/experimenters/experimenter.py:40``
and ``numpy_experimenter.py:147``: an Experimenter evaluates trials in place
(attaching final measurements) and owns its problem statement.

Copy of the JAX package's ``benchmarks/experimenters/base.py``, on the port's data model; numpy only.
"""

from __future__ import annotations

import abc
import math
from typing import Callable, List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


class Experimenter(abc.ABC):
    """A benchmark objective."""

    @abc.abstractmethod
    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        """Completes each trial with a final measurement (in place)."""

    @abc.abstractmethod
    def problem_statement(self) -> base_study_config.ProblemStatement:
        ...


class NumpyExperimenter(Experimenter):
    """Wraps ``f: [N, D] -> [N]`` over a flat double search space.

    The objective name is ``value`` and the goal is MINIMIZE by default
    (BBOB convention).
    """

    def __init__(
        self,
        impl: Callable[[np.ndarray], np.ndarray],
        problem: base_study_config.ProblemStatement,
        *,
        metric_name: Optional[str] = None,
    ):
        self._impl = impl
        self._problem = problem
        self._metric_name = metric_name or problem.metric_information.item().name
        self._param_names = [p.name for p in problem.search_space.parameters]

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        if not suggestions:
            return
        xs = np.asarray(
            [
                [float(t.parameters.get_value(name)) for name in self._param_names]
                for t in suggestions
            ]
        )
        values = np.atleast_1d(np.asarray(self._impl(xs)))
        if values.ndim == 1 and len(values) == len(suggestions):
            pass
        elif values.size == len(suggestions):
            values = values.reshape(len(suggestions))
        else:
            raise ValueError(
                f"Objective returned shape {values.shape} for {len(suggestions)} trials."
            )
        for t, v in zip(suggestions, values):
            v = float(v)
            if math.isnan(v):
                t.complete(infeasibility_reason="NaN objective.")
            else:
                t.complete(trial_.Measurement(metrics={self._metric_name: v}))

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem

    def __repr__(self) -> str:
        return f"NumpyExperimenter({getattr(self._impl, '__name__', self._impl)!r})"


def bbob_problem(
    dimension: int,
    *,
    low: float = -5.0,
    high: float = 5.0,
    metric_name: str = "bbob_eval",
) -> base_study_config.ProblemStatement:
    """The standard BBOB problem shell: D doubles in [-5, 5], MINIMIZE."""
    problem = base_study_config.ProblemStatement()
    root = problem.search_space.root
    for i in range(dimension):
        root.add_float_param(f"x{i}", low, high)
    problem.metric_information.append(
        base_study_config.MetricInformation(
            name=metric_name, goal=base_study_config.ObjectiveMetricGoal.MINIMIZE
        )
    )
    return problem
