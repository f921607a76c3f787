"""Multi-objective synthetic problems: ZDT and DTLZ families.

Parity in role with the reference's
``synthetic/multiobjective_optproblems.py`` / ``deb.py``: the standard
two-objective ZDT suite (1, 2, 3, 4, 6) and DTLZ1/DTLZ2 with a configurable
number of objectives. All objectives are MINIMIZE.

Copy of the JAX package's ``benchmarks/experimenters/synthetic/multiobjective.py``, on the port's data model; numpy only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


def _zdt_g(x: np.ndarray) -> np.ndarray:
    return 1.0 + 9.0 * np.mean(x[..., 1:], axis=-1)


def zdt1(x: np.ndarray) -> np.ndarray:
    f1 = x[..., 0]
    g = _zdt_g(x)
    return np.stack([f1, g * (1.0 - np.sqrt(f1 / g))], axis=-1)


def zdt2(x: np.ndarray) -> np.ndarray:
    f1 = x[..., 0]
    g = _zdt_g(x)
    return np.stack([f1, g * (1.0 - (f1 / g) ** 2)], axis=-1)


def zdt3(x: np.ndarray) -> np.ndarray:
    f1 = x[..., 0]
    g = _zdt_g(x)
    h = 1.0 - np.sqrt(f1 / g) - (f1 / g) * np.sin(10.0 * np.pi * f1)
    return np.stack([f1, g * h], axis=-1)


def zdt4(x: np.ndarray) -> np.ndarray:
    # x0 in [0,1], rest in [-5,5] conventionally; we keep [0,1] and rescale.
    f1 = x[..., 0]
    rest = x[..., 1:] * 10.0 - 5.0
    g = 1.0 + 10.0 * rest.shape[-1] + np.sum(
        rest**2 - 10.0 * np.cos(4.0 * np.pi * rest), axis=-1
    )
    return np.stack([f1, g * (1.0 - np.sqrt(np.maximum(f1, 1e-12) / g))], axis=-1)


def zdt6(x: np.ndarray) -> np.ndarray:
    f1 = 1.0 - np.exp(-4.0 * x[..., 0]) * np.sin(6.0 * np.pi * x[..., 0]) ** 6
    g = 1.0 + 9.0 * np.mean(x[..., 1:], axis=-1) ** 0.25
    return np.stack([f1, g * (1.0 - (f1 / g) ** 2)], axis=-1)


def dtlz1(x: np.ndarray, num_objectives: int = 2) -> np.ndarray:
    m = num_objectives
    xm = x[..., m - 1 :]
    g = 100.0 * (
        xm.shape[-1]
        + np.sum((xm - 0.5) ** 2 - np.cos(20.0 * np.pi * (xm - 0.5)), axis=-1)
    )
    fs = []
    for i in range(m):
        f = 0.5 * (1.0 + g)
        for j in range(m - 1 - i):
            f = f * x[..., j]
        if i > 0:
            f = f * (1.0 - x[..., m - 1 - i])
        fs.append(f)
    return np.stack(fs, axis=-1)


def dtlz2(x: np.ndarray, num_objectives: int = 2) -> np.ndarray:
    m = num_objectives
    xm = x[..., m - 1 :]
    g = np.sum((xm - 0.5) ** 2, axis=-1)
    fs = []
    for i in range(m):
        f = 1.0 + g
        for j in range(m - 1 - i):
            f = f * np.cos(0.5 * np.pi * x[..., j])
        if i > 0:
            f = f * np.sin(0.5 * np.pi * x[..., m - 1 - i])
        fs.append(f)
    return np.stack(fs, axis=-1)


ZDT_FUNCTIONS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "zdt1": zdt1,
    "zdt2": zdt2,
    "zdt3": zdt3,
    "zdt4": zdt4,
    "zdt6": zdt6,
}


class MultiObjectiveExperimenter(base.Experimenter):
    """Wraps ``f: [N, D] -> [N, M]`` over [0, 1]^D, all objectives MINIMIZE."""

    def __init__(
        self,
        impl: Callable[[np.ndarray], np.ndarray],
        *,
        dimension: int,
        num_objectives: int = 2,
        name: str = "mo",
    ):
        self._impl = impl
        self._num_objectives = num_objectives
        problem = base_study_config.ProblemStatement()
        root = problem.search_space.root
        for i in range(dimension):
            root.add_float_param(f"x{i}", 0.0, 1.0)
        for j in range(num_objectives):
            problem.metric_information.append(
                base_study_config.MetricInformation(
                    name=f"{name}_f{j}", goal=base_study_config.ObjectiveMetricGoal.MINIMIZE
                )
            )
        self._problem = problem
        self._param_names = [p.name for p in problem.search_space.parameters]
        self._metric_names = [m.name for m in problem.metric_information]

    @classmethod
    def zdt(cls, which: str, *, dimension: int = 10) -> "MultiObjectiveExperimenter":
        return cls(ZDT_FUNCTIONS[which], dimension=dimension, name=which)

    @classmethod
    def dtlz(
        cls, which: str, *, dimension: int = 7, num_objectives: int = 2
    ) -> "MultiObjectiveExperimenter":
        impls = {"dtlz1": dtlz1, "dtlz2": dtlz2}
        fn = impls[which]
        return cls(
            lambda x: fn(x, num_objectives),
            dimension=dimension,
            num_objectives=num_objectives,
            name=which,
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        if not suggestions:
            return
        xs = np.asarray(
            [
                [float(t.parameters.get_value(n)) for n in self._param_names]
                for t in suggestions
            ]
        )
        values = np.atleast_2d(self._impl(xs))
        for t, row in zip(suggestions, values):
            t.complete(
                trial_.Measurement(
                    metrics={n: float(v) for n, v in zip(self._metric_names, row)}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem
