"""Platform-independent client interface contracts.

A copy of the JAX package's ``client/client_abc.py``: any
Vizier backend (this OSS service, a cloud service, an in-RAM fake) exposes
the same ``StudyInterface``/``TrialInterface`` so user code is portable.
"""

from __future__ import annotations

import abc
from typing import Collection, List, Optional

from vizier_tpu_torch import pyvizier as vz


class ResourceNotFoundError(KeyError):
    """The referenced study/trial does not exist."""


class TrialInterface(abc.ABC):
    """A handle to one trial on the service."""

    @property
    @abc.abstractmethod
    def id(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def parameters(self) -> dict:
        """User-facing parameter values (external types applied)."""

    @abc.abstractmethod
    def add_measurement(self, measurement: vz.Measurement) -> None:
        ...

    @abc.abstractmethod
    def complete(
        self,
        measurement: Optional[vz.Measurement] = None,
        *,
        infeasible_reason: Optional[str] = None,
    ) -> Optional[vz.Measurement]:
        """Completes the trial; returns the final measurement."""

    @abc.abstractmethod
    def check_early_stopping(self) -> bool:
        """True if the service wants this trial to stop."""

    @abc.abstractmethod
    def stop(self) -> None:
        ...

    @abc.abstractmethod
    def delete(self) -> None:
        ...

    @abc.abstractmethod
    def materialize(self) -> vz.Trial:
        """Fetches the full current trial state."""

    @abc.abstractmethod
    def update_metadata(self, delta: vz.Metadata) -> None:
        ...

    @property
    @abc.abstractmethod
    def status(self) -> vz.TrialStatus:
        ...


class StudyInterface(abc.ABC):
    """A handle to one study on the service."""

    @property
    @abc.abstractmethod
    def resource_name(self) -> str:
        ...

    @abc.abstractmethod
    def suggest(
        self, *, count: Optional[int] = None, client_id: str = "default_client_id"
    ) -> List[TrialInterface]:
        ...

    @abc.abstractmethod
    def delete(self) -> None:
        ...

    @abc.abstractmethod
    def trials(
        self, trial_filter: Optional[vz.TrialFilter] = None
    ) -> Collection[TrialInterface]:
        ...

    @abc.abstractmethod
    def get_trial(self, uid: int) -> TrialInterface:
        ...

    @abc.abstractmethod
    def optimal_trials(self, count: Optional[int] = None) -> Collection[TrialInterface]:
        ...

    @abc.abstractmethod
    def materialize_study_config(self) -> vz.StudyConfig:
        ...

    @abc.abstractmethod
    def set_state(self, state: vz.StudyState) -> None:
        ...

    @abc.abstractmethod
    def update_metadata(self, delta: vz.Metadata) -> None:
        ...
