"""The Policy protocol: the algorithm-hosting contract.

A copy of the JAX package's ``pythia/policy.py``, so that the port imports nothing
of the JAX package.

``SuggestRequest`` → ``SuggestDecision`` and ``EarlyStopRequest`` →
``EarlyStopDecisions``, plus the abstract ``Policy``. A Policy is the unit
the Pythia service hosts; Designers are wrapped into Policies by
``vizier_tpu_torch.algorithms.designer_policy``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import FrozenSet, Iterable, List, Optional

from vizier_tpu_torch.pyvizier import study as study_lib
from vizier_tpu_torch.pyvizier import study_config as sc
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass(frozen=True)
class SuggestRequest:
    """A request for ``count`` new suggestions for one study."""

    study_descriptor: study_lib.StudyDescriptor
    count: int = 1
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        if self.count <= 0:
            raise ValueError(f"count must be positive, got {self.count}.")

    @property
    def study_config(self) -> sc.StudyConfig:
        return self.study_descriptor.config

    @property
    def study_guid(self) -> str:
        return self.study_descriptor.guid

    @property
    def max_trial_id(self) -> int:
        return self.study_descriptor.max_trial_id


@dataclasses.dataclass
class SuggestDecision:
    """Suggestions plus any metadata updates to persist."""

    suggestions: List[trial_.TrialSuggestion]
    metadata: trial_.MetadataDelta = dataclasses.field(default_factory=trial_.MetadataDelta)

    def __post_init__(self):
        self.suggestions = list(self.suggestions)


@dataclasses.dataclass(frozen=True)
class EarlyStopRequest:
    """Which trials to consider stopping (empty = all STOPPING+ACTIVE)."""

    study_descriptor: study_lib.StudyDescriptor
    trial_ids: FrozenSet[int] = frozenset()
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "trial_ids", frozenset(self.trial_ids))

    @property
    def study_config(self) -> sc.StudyConfig:
        return self.study_descriptor.config

    @property
    def study_guid(self) -> str:
        return self.study_descriptor.guid


@dataclasses.dataclass
class EarlyStopDecision:
    """Whether one trial should stop."""

    id: int
    reason: str = ""
    should_stop: bool = True
    metadata: trial_.Metadata = dataclasses.field(default_factory=trial_.Metadata)


@dataclasses.dataclass
class EarlyStopDecisions:
    decisions: List[EarlyStopDecision] = dataclasses.field(default_factory=list)
    metadata: trial_.MetadataDelta = dataclasses.field(default_factory=trial_.MetadataDelta)


class Policy(abc.ABC):
    """An algorithm hosted by the Pythia service."""

    @abc.abstractmethod
    def suggest(self, request: SuggestRequest) -> SuggestDecision:
        """Produces new trial suggestions."""

    def early_stop(self, request: EarlyStopRequest) -> EarlyStopDecisions:
        """Decides which trials should stop early. Default: stop nothing."""
        return EarlyStopDecisions(
            decisions=[
                EarlyStopDecision(id=tid, reason="Policy does not early-stop.", should_stop=False)
                for tid in request.trial_ids
            ]
        )

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def should_be_cached(self) -> bool:
        """Whether the service may reuse this policy object across requests."""
        return False
