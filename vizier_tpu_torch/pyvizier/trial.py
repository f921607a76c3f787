"""Trials, measurements, and parameter values.

Functional parity with the reference's trial module
(``vizier/_src/pyvizier/shared/trial.py:91,128,276,404,439``):
typed ``ParameterValue`` with casting, ``Measurement`` (metrics + steps +
elapsed time), the ``Trial`` lifecycle state machine
(REQUESTED → ACTIVE → STOPPING → SUCCEEDED / INFEASIBLE), ``TrialSuggestion``,
``TrialFilter``, and ``MetadataDelta`` for metadata update RPCs.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import datetime
import enum
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Union

from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier.parameter_config import ParameterValueTypes

Metadata = common.Metadata


class TrialStatus(enum.Enum):
    """Trial lifecycle states."""

    UNKNOWN = "UNKNOWN"
    REQUESTED = "REQUESTED"
    ACTIVE = "ACTIVE"
    STOPPING = "STOPPING"
    COMPLETED = "COMPLETED"


@dataclasses.dataclass(frozen=True)
class Metric:
    """A single scalar result. NaN is allowed and signals a failed evaluation."""

    value: float
    std: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "value", float(self.value))
        if self.std is not None:
            if self.std < 0:
                raise ValueError(f"Metric std must be >= 0, got {self.std}.")
            object.__setattr__(self, "std", float(self.std))


@dataclasses.dataclass(frozen=True)
class ParameterValue:
    """A typed parameter assignment with explicit casting accessors."""

    value: ParameterValueTypes

    def __post_init__(self):
        if not isinstance(self.value, (str, int, float, bool)):
            raise TypeError(f"ParameterValue must be str/int/float/bool, got {type(self.value)}")

    def cast_as_internal(self, internal_type: Any) -> ParameterValueTypes:
        """Casts to a ParameterType's canonical python type (duck-typed)."""
        name = getattr(internal_type, "name", str(internal_type))
        if name == "DOUBLE" or name == "DISCRETE":
            return self.as_float
        if name == "INTEGER":
            return self.as_int
        if name == "CATEGORICAL":
            return self.as_str
        return self.value

    @property
    def as_float(self) -> float:
        return float(self.value)  # type: ignore[arg-type]

    @property
    def as_int(self) -> int:
        f = float(self.value)  # type: ignore[arg-type]
        if not f.is_integer():
            raise ValueError(f"Cannot cast {self.value!r} to int losslessly.")
        return int(f)

    @property
    def as_str(self) -> str:
        if isinstance(self.value, bool):
            return "True" if self.value else "False"
        return str(self.value)

    @property
    def as_bool(self) -> bool:
        if isinstance(self.value, bool):
            return self.value
        if isinstance(self.value, str):
            if self.value.lower() in ("true", "1"):
                return True
            if self.value.lower() in ("false", "0"):
                return False
            raise ValueError(f"Cannot cast {self.value!r} to bool.")
        if isinstance(self.value, (int, float)):
            if float(self.value) == 1.0:
                return True
            if float(self.value) == 0.0:
                return False
        raise ValueError(f"Cannot cast {self.value!r} to bool.")


class ParameterDict(collections.abc.MutableMapping):
    """Mapping name → ParameterValue; raw values are wrapped on insert.

    ``get_value(name)`` returns the raw python value; ``as_dict()`` returns a
    plain {name: raw value} dict.
    """

    def __init__(self, items: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        self._items: Dict[str, ParameterValue] = {}
        merged = dict(items or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, ParameterValue):
            self._items[key] = value
        else:
            self._items[key] = ParameterValue(value)

    def __getitem__(self, key: str) -> ParameterValue:
        return self._items[key]

    def __delitem__(self, key: str) -> None:
        del self._items[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def get_value(self, key: str, default: Any = None) -> Any:
        pv = self._items.get(key)
        return default if pv is None else pv.value

    def as_dict(self) -> Dict[str, ParameterValueTypes]:
        return {k: v.value for k, v in self._items.items()}

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ParameterDict):
            return self._items == other._items
        if isinstance(other, Mapping):
            try:
                return self._items == ParameterDict(other)._items
            except TypeError:
                return False
        return NotImplemented

    def __repr__(self) -> str:
        return f"ParameterDict({self.as_dict()!r})"


@dataclasses.dataclass
class Measurement:
    """Metrics observed at one evaluation point of a trial."""

    metrics: Dict[str, Metric] = dataclasses.field(default_factory=dict)
    elapsed_secs: float = 0.0
    steps: float = 0.0

    def __post_init__(self):
        clean: Dict[str, Metric] = {}
        for name, m in dict(self.metrics).items():
            if isinstance(m, Metric):
                clean[name] = m
            elif isinstance(m, (int, float)):
                clean[name] = Metric(value=float(m))
            else:
                raise TypeError(f"Metric {name!r} must be Metric or number, got {type(m)}")
        self.metrics = clean
        if self.elapsed_secs < 0:
            raise ValueError("elapsed_secs must be >= 0.")
        if self.steps < 0:
            raise ValueError("steps must be >= 0.")

    def as_float_dict(self) -> Dict[str, float]:
        """Metric name → value (reference ``Measurement.as_float_dict``)."""
        return {name: m.value for name, m in self.metrics.items()}


@dataclasses.dataclass
class TrialSuggestion:
    """A suggested point, not yet assigned a trial id by the service."""

    parameters: ParameterDict = dataclasses.field(default_factory=ParameterDict)
    metadata: Metadata = dataclasses.field(default_factory=Metadata)

    def __post_init__(self):
        if not isinstance(self.parameters, ParameterDict):
            self.parameters = ParameterDict(self.parameters)

    def to_trial(self, uid: int = 0) -> "Trial":
        return Trial(id=uid, parameters=self.parameters, metadata=self.metadata)


@dataclasses.dataclass
class Trial:
    """A (possibly running or completed) evaluation of one parameter point."""

    id: int = 0
    parameters: ParameterDict = dataclasses.field(default_factory=ParameterDict)
    metadata: Metadata = dataclasses.field(default_factory=Metadata)
    assigned_worker: Optional[str] = None
    is_requested: bool = False
    stopping_reason: Optional[str] = None
    _is_stopping: bool = dataclasses.field(default=False)
    measurements: List[Measurement] = dataclasses.field(default_factory=list)
    final_measurement: Optional[Measurement] = None
    infeasibility_reason: Optional[str] = None
    creation_time: Optional[datetime.datetime] = None
    completion_time: Optional[datetime.datetime] = None

    def __post_init__(self):
        if not isinstance(self.parameters, ParameterDict):
            self.parameters = ParameterDict(self.parameters)
        if self.creation_time is None:
            self.creation_time = datetime.datetime.now(datetime.timezone.utc)
        if (self.final_measurement is not None or self.infeasibility_reason is not None) and (
            self.completion_time is None
        ):
            self.completion_time = datetime.datetime.now(datetime.timezone.utc)

    # -- lifecycle --

    @property
    def is_completed(self) -> bool:
        return self.final_measurement is not None or self.infeasibility_reason is not None

    @property
    def infeasible(self) -> bool:
        return self.infeasibility_reason is not None

    @property
    def final_measurement_or_die(self) -> Measurement:
        """The final measurement, raising if the trial has none (reference
        ``Trial.final_measurement_or_die``)."""
        if self.final_measurement is None:
            raise ValueError(f"Trial {self.id} has no final measurement.")
        return self.final_measurement

    @property
    def status(self) -> TrialStatus:
        if self.is_completed:
            return TrialStatus.COMPLETED
        if self._is_stopping:
            return TrialStatus.STOPPING
        if self.is_requested:
            return TrialStatus.REQUESTED
        return TrialStatus.ACTIVE

    def complete(
        self,
        measurement: Optional[Measurement] = None,
        *,
        infeasibility_reason: Optional[str] = None,
        inplace: bool = True,
    ) -> "Trial":
        """Marks the trial completed with a final measurement.

        With neither a measurement nor an infeasibility reason, the last
        intermediate measurement is promoted; if none exists the trial is
        marked infeasible (matching the service semantics of the reference's
        ``CompleteTrial``, ``vizier_service.py:568``).
        """
        if inplace:
            target = self
        else:
            target = dataclasses.replace(
                self,
                parameters=ParameterDict(dict(self.parameters)),
                measurements=list(self.measurements),
            )
        if measurement is None and infeasibility_reason is None:
            if target.measurements:
                measurement = target.measurements[-1]
            else:
                infeasibility_reason = "Completed without any measurement."
        if measurement is not None and any(
            m.value != m.value for m in measurement.metrics.values()  # NaN check
        ):
            infeasibility_reason = infeasibility_reason or "NaN metric value."
        target.final_measurement = measurement
        target.infeasibility_reason = infeasibility_reason
        target.is_requested = False
        target._is_stopping = False
        target.completion_time = datetime.datetime.now(datetime.timezone.utc)
        return target

    def stop(self, reason: Optional[str] = None) -> None:
        if not self.is_completed:
            self._is_stopping = True
            self.stopping_reason = reason

    @property
    def duration(self) -> Optional[datetime.timedelta]:
        if self.completion_time is not None and self.creation_time is not None:
            return self.completion_time - self.creation_time
        return None

    def to_suggestion(self) -> TrialSuggestion:
        return TrialSuggestion(parameters=self.parameters, metadata=self.metadata)


@dataclasses.dataclass
class TrialFilter:
    """Predicate over trials: by ids, min id, and/or status set."""

    ids: Optional[frozenset] = None
    min_id: Optional[int] = None
    status: Optional[frozenset] = None

    def __post_init__(self):
        if self.ids is not None:
            self.ids = frozenset(self.ids)
        if self.status is not None:
            self.status = frozenset(
                s if isinstance(s, TrialStatus) else TrialStatus(s) for s in self.status
            )

    def __call__(self, trial: Trial) -> bool:
        if self.ids is not None and trial.id not in self.ids:
            return False
        if self.min_id is not None and trial.id < self.min_id:
            return False
        if self.status is not None and trial.status not in self.status:
            return False
        return True


@dataclasses.dataclass
class MetadataDelta:
    """Metadata updates addressed to a study and/or individual trials."""

    on_study: Metadata = dataclasses.field(default_factory=Metadata)
    on_trials: Dict[int, Metadata] = dataclasses.field(default_factory=dict)

    def assign(
        self,
        namespace: str,
        key: str,
        value: Any,
        *,
        trial_id: Optional[int] = None,
        trial: Optional[Trial] = None,
    ) -> None:
        if trial is not None:
            trial_id = trial.id
        if trial_id is None:
            self.on_study.abs_ns(common.Namespace(namespace))[key] = value
        else:
            md = self.on_trials.setdefault(trial_id, Metadata())
            md.abs_ns(common.Namespace(namespace))[key] = value

    @property
    def empty(self) -> bool:
        return not self.on_study.namespaces() and not any(
            md.namespaces() for md in self.on_trials.values()
        )


# Convenience containers used by Designer.update (reference:
# vizier/_src/algorithms/core/abstractions.py:31-56).
@dataclasses.dataclass(frozen=True)
class CompletedTrials:
    """Completed trials delivered to a Designer exactly once each."""

    trials: tuple

    def __init__(self, trials: Iterable[Trial] = ()):
        object.__setattr__(self, "trials", tuple(trials))
        for t in self.trials:
            if not t.is_completed:
                raise ValueError(f"Trial {t.id} is not completed.")


@dataclasses.dataclass(frozen=True)
class ActiveTrials:
    """Currently-active (pending) trials; delivered on every update."""

    trials: tuple = ()

    def __init__(self, trials: Iterable[Trial] = ()):
        object.__setattr__(self, "trials", tuple(trials))
        for t in self.trials:
            if t.status != TrialStatus.ACTIVE:
                raise ValueError(f"Trial {t.id} is not ACTIVE (status={t.status}).")
