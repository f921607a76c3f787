"""PolicySupporter reading trials back from the Vizier service.

A copy of the JAX package's ``service/service_policy_supporter.py``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.pythia import policy_supporter
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service.protos import vizier_service_pb2


class ServicePolicySupporter(policy_supporter.PolicySupporter):
    """Reads study/trial state via the Vizier servicer (or stub)."""

    def __init__(self, study_name: str, vizier_service):
        self._study_name = study_name
        self._vizier = vizier_service

    def GetStudyConfig(self, study_guid: Optional[str] = None) -> vz.StudyConfig:
        name = study_guid or self._study_name
        study = self._vizier.GetStudy(vizier_service_pb2.GetStudyRequest(name=name))
        return pc.study_config_from_proto(study.study_spec)

    def GetTrials(
        self,
        *,
        study_guid: Optional[str] = None,
        trial_ids: Optional[Iterable[int]] = None,
        min_trial_id: Optional[int] = None,
        max_trial_id: Optional[int] = None,
        status_matches: Optional[vz.TrialStatus] = None,
        include_intermediate_measurements: bool = True,
    ) -> List[vz.Trial]:
        name = study_guid or self._study_name
        response = self._vizier.ListTrials(
            vizier_service_pb2.ListTrialsRequest(parent=name)
        )
        trials = [pc.trial_from_proto(t) for t in response.trials]
        ids = frozenset(trial_ids) if trial_ids is not None else None
        out = []
        for t in trials:
            if ids is not None and t.id not in ids:
                continue
            if min_trial_id is not None and t.id < min_trial_id:
                continue
            if max_trial_id is not None and t.id > max_trial_id:
                continue
            if status_matches is not None and t.status != status_matches:
                continue
            out.append(t)
        return out
