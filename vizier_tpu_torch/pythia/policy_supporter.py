"""PolicySupporter: the algorithm's read-back channel to the study DB.

A copy of the JAX package's ``pythia/policy_supporter.py``, so that the port imports nothing
of the JAX package.

"""

from __future__ import annotations

import abc
import datetime
from typing import Iterable, List, Optional

from vizier_tpu_torch.pythia import errors
from vizier_tpu_torch.pyvizier import study_config as sc
from vizier_tpu_torch.pyvizier import trial as trial_


class PolicySupporter(abc.ABC):
    """Reads study state on behalf of a running policy."""

    @abc.abstractmethod
    def GetStudyConfig(self, study_guid: Optional[str] = None) -> sc.StudyConfig:
        """Fetches a study's config (defaults to the policy's own study)."""

    @abc.abstractmethod
    def GetTrials(
        self,
        *,
        study_guid: Optional[str] = None,
        trial_ids: Optional[Iterable[int]] = None,
        min_trial_id: Optional[int] = None,
        max_trial_id: Optional[int] = None,
        status_matches: Optional[trial_.TrialStatus] = None,
        include_intermediate_measurements: bool = True,
    ) -> List[trial_.Trial]:
        """Fetches trials matching the filters."""

    def CheckCancelled(self, note: str = "") -> None:
        """Raises CancelComputeError if the RPC was cancelled (default: no-op)."""

    def TimeRemaining(self) -> datetime.timedelta:
        """Time left before the deadline (default: unbounded)."""
        return datetime.timedelta.max

    def SendMetadata(self, delta: trial_.MetadataDelta) -> None:
        """Persists metadata immediately (mid-computation checkpointing)."""
        raise NotImplementedError(f"{type(self).__name__} does not support SendMetadata.")
