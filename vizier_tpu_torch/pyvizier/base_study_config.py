"""Problem statements: metric configuration + search space.

Functional parity with the reference's
``vizier/_src/pyvizier/shared/base_study_config.py:55,92,222,306``:
``MetricInformation`` (goal, optional safety config, optional value range),
``MetricsConfig`` (an ordered collection with single/multi-objective
predicates), and ``ProblemStatement`` binding a search space, metrics, and
study metadata.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import enum
import math
from typing import Any, Callable, Iterable, Iterator, List, Optional, Union

from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import parameter_config as pc


class ObjectiveMetricGoal(enum.Enum):
    MAXIMIZE = "MAXIMIZE"
    MINIMIZE = "MINIMIZE"

    @property
    def is_maximize(self) -> bool:
        return self == ObjectiveMetricGoal.MAXIMIZE

    @property
    def is_minimize(self) -> bool:
        return self == ObjectiveMetricGoal.MINIMIZE


class MetricType(str, enum.Enum):
    """OBJECTIVE (optimized) vs SAFETY (soft constraint) — reference
    ``base_study_config.py:71``. str-valued so ``m.type == "SAFETY"``
    comparisons keep working."""

    OBJECTIVE = "OBJECTIVE"
    SAFETY = "SAFETY"

    # Keep str()/f-string output identical to the plain strings the old
    # `type` property returned ("OBJECTIVE", not "MetricType.OBJECTIVE").
    __str__ = str.__str__
    __format__ = str.__format__

    @property
    def is_safety(self) -> bool:
        return self == MetricType.SAFETY

    @property
    def is_objective(self) -> bool:
        return self == MetricType.OBJECTIVE


@dataclasses.dataclass(frozen=True)
class MetricInformation:
    """Configuration of one reported metric.

    A metric with ``safety_threshold`` set is a *safety* metric (constraint),
    not an objective: trials violating the threshold are unsafe.
    """

    name: str = ""
    goal: ObjectiveMetricGoal = ObjectiveMetricGoal.MAXIMIZE
    safety_threshold: Optional[float] = None
    desired_min_safe_trials_fraction: Optional[float] = None
    min_value: float = -math.inf
    max_value: float = math.inf

    def __post_init__(self):
        if isinstance(self.goal, str):
            object.__setattr__(self, "goal", ObjectiveMetricGoal(self.goal))
        if self.min_value > self.max_value:
            raise ValueError(
                f"{self.name}: min_value {self.min_value} > max_value {self.max_value}"
            )
        frac = self.desired_min_safe_trials_fraction
        if frac is not None and not (0.0 <= frac <= 1.0):
            raise ValueError(f"{self.name}: safe-trials fraction must be in [0,1], got {frac}")

    @property
    def type(self) -> MetricType:
        return (
            MetricType.SAFETY
            if self.safety_threshold is not None
            else MetricType.OBJECTIVE
        )

    @property
    def is_safety_metric(self) -> bool:
        return self.safety_threshold is not None

    @property
    def range(self) -> float:
        """max_value - min_value; can be infinite."""
        return self.max_value - self.min_value

    def min_value_or(self, default_fn: Callable[[], float] = lambda: -math.inf) -> float:
        return self.min_value if math.isfinite(self.min_value) else default_fn()

    def max_value_or(self, default_fn: Callable[[], float] = lambda: math.inf) -> float:
        return self.max_value if math.isfinite(self.max_value) else default_fn()

    def flip_goal(self) -> "MetricInformation":
        new_goal = (
            ObjectiveMetricGoal.MINIMIZE if self.goal.is_maximize else ObjectiveMetricGoal.MAXIMIZE
        )
        return dataclasses.replace(self, goal=new_goal)


class MetricsConfig(collections.abc.Collection):
    """Ordered, name-unique collection of MetricInformation."""

    def __init__(self, metrics: Iterable[MetricInformation] = ()):
        self._metrics: List[MetricInformation] = list(metrics)
        names = [m.name for m in self._metrics]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate metric names: {names}")

    def append(self, metric: MetricInformation) -> None:
        if any(m.name == metric.name for m in self._metrics):
            raise ValueError(f"Metric {metric.name!r} already present.")
        self._metrics.append(metric)

    def extend(self, metrics: Iterable[MetricInformation]) -> None:
        for m in metrics:
            self.append(m)

    def __iter__(self) -> Iterator[MetricInformation]:
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, item: object) -> bool:
        return item in self._metrics

    def __getitem__(self, index: int) -> MetricInformation:
        return self._metrics[index]

    def get(self, name: str) -> MetricInformation:
        for m in self._metrics:
            if m.name == name:
                return m
        raise KeyError(f"No metric named {name!r}.")

    @staticmethod
    def _type_set(
        types: Union[str, MetricType, Iterable[Union[str, MetricType]]]
    ) -> set:
        if isinstance(types, (str, MetricType)):
            types = (types,)
        return {MetricType(t) for t in types}

    def of_type(
        self, include: Union[str, MetricType, Iterable[Union[str, MetricType]]]
    ) -> "MetricsConfig":
        wanted = self._type_set(include)
        return MetricsConfig(m for m in self._metrics if m.type in wanted)

    def exclude_type(
        self, exclude: Union[str, MetricType, Iterable[Union[str, MetricType]]]
    ) -> "MetricsConfig":
        unwanted = self._type_set(exclude)
        return MetricsConfig(m for m in self._metrics if m.type not in unwanted)

    def item(self) -> MetricInformation:
        """The unique objective metric; raises unless single-objective."""
        objectives = [m for m in self._metrics if not m.is_safety_metric]
        if len(objectives) != 1:
            raise ValueError(f"Expected exactly one objective metric, have {len(objectives)}.")
        return objectives[0]

    @property
    def is_single_objective(self) -> bool:
        return sum(1 for m in self._metrics if not m.is_safety_metric) == 1

    @property
    def is_safety_metric_present(self) -> bool:
        return any(m.is_safety_metric for m in self._metrics)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MetricsConfig):
            return NotImplemented
        return self._metrics == other._metrics

    def __repr__(self) -> str:
        return f"MetricsConfig({self._metrics!r})"


@dataclasses.dataclass
class ProblemStatement:
    """Search space + metric configuration + study-level metadata."""

    search_space: pc.SearchSpace = dataclasses.field(default_factory=pc.SearchSpace)
    metric_information: MetricsConfig = dataclasses.field(default_factory=MetricsConfig)
    metadata: common.Metadata = dataclasses.field(default_factory=common.Metadata)

    def __post_init__(self):
        if not isinstance(self.metric_information, MetricsConfig):
            self.metric_information = MetricsConfig(self.metric_information)

    @property
    def is_single_objective(self) -> bool:
        return self.metric_information.is_single_objective

    @property
    def single_objective_metric_name(self) -> Optional[str]:
        if self.is_single_objective:
            return self.metric_information.item().name
        return None

    @property
    def is_safety_metric_present(self) -> bool:
        return self.metric_information.is_safety_metric_present

    def to_problem(self) -> "ProblemStatement":
        return self

    def __repr__(self) -> str:
        return (
            f"ProblemStatement(search_space={self.search_space!r}, "
            f"metric_information={self.metric_information!r})"
        )
