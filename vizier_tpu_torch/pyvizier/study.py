"""Pythia-side study types.

A copy of the JAX package's ``pyvizier/study.py``, so that the port imports nothing
of the JAX package.

the study lifecycle state and the lightweight descriptor handed to policies.
"""

from __future__ import annotations

import dataclasses
import enum

from vizier_tpu_torch.pyvizier import study_config as sc


class StudyState(enum.Enum):
    ACTIVE = "ACTIVE"
    ABORTED = "ABORTED"
    COMPLETED = "COMPLETED"


@dataclasses.dataclass(frozen=True)
class StudyStateInfo:
    state: StudyState
    explanation: str = ""


@dataclasses.dataclass(frozen=True)
class StudyDescriptor:
    """What a Policy needs to know about a study to make suggestions."""

    config: sc.StudyConfig
    guid: str = ""
    max_trial_id: int = 0


@dataclasses.dataclass
class ProblemAndTrials:
    """Container pairing a problem statement with its trials.

    
    the unit benchmark pipelines pass around (analyzers, state dumps).
    """

    problem: "base_study_config.ProblemStatement"  # noqa: F821 (kept unimported to avoid a cycle)
    trials: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.trials = list(self.trials)
