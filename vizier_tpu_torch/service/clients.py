"""User-facing client: ``Study`` / ``Trial``.

A copy of the JAX package's ``service/clients.py``:
``Study.from_study_config`` implicitly creates/loads the study (spinning an
in-process service when no endpoint is configured, whose Pythia runs the
designers on ``environment_variables.device``); trials round-trip through
the platform-independent ``client_abc`` interfaces.
"""

from __future__ import annotations

import secrets
from typing import Any, Collection, Dict, List, Optional

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.client import client_abc
from vizier_tpu_torch.service import vizier_client

NO_ENDPOINT = vizier_client.NO_ENDPOINT
environment_variables = vizier_client.environment_variables


def list_studies(owner: str, *, endpoint: Optional[str] = None) -> List["Study"]:
    """All studies under an owner (parity with the ListStudies RPC)."""
    from vizier_tpu_torch.service import resources
    from vizier_tpu_torch.service.protos import vizier_service_pb2

    service = vizier_client.create_service_stub(endpoint)
    response = service.ListStudies(
        vizier_service_pb2.ListStudiesRequest(
            parent=resources.OwnerResource(owner).name
        )
    )
    return [
        Study(vizier_client.VizierClient(service, s.name, "default_client_id"))
        for s in response.studies
    ]


class Trial(client_abc.TrialInterface):
    def __init__(
        self,
        client: vizier_client.VizierClient,
        uid: int,
        snapshot: Optional[vz.Trial] = None,
    ):
        self._client = client
        self._uid = uid
        # Trial parameters are immutable after creation, so a creation-time
        # snapshot (e.g. the proto ``suggest`` already received) answers
        # ``.parameters`` with zero RPCs; measurements/state always
        # re-materialize.
        self._snapshot = snapshot
        self._params: Optional[Dict[str, Any]] = None

    @property
    def id(self) -> int:
        return self._uid

    @property
    def parameters(self) -> Dict[str, Any]:
        if self._params is None:
            config = self._client.cached_study_config()
            trial = self._snapshot if self._snapshot is not None else self.materialize()
            self._params = config.trial_parameters(trial)
        # Fresh dict per access: a caller mutating the returned mapping must
        # not poison later reads through the cache.
        return dict(self._params)

    def add_measurement(self, measurement: vz.Measurement) -> None:
        self._client.report_intermediate_objective_value(self._uid, measurement)

    def complete(
        self,
        measurement: Optional[vz.Measurement] = None,
        *,
        infeasible_reason: Optional[str] = None,
    ) -> Optional[vz.Measurement]:
        trial = self._client.complete_trial(
            self._uid, measurement, infeasibility_reason=infeasible_reason
        )
        return trial.final_measurement

    def check_early_stopping(self) -> bool:
        return self._client.should_trial_stop(self._uid)

    def stop(self) -> None:
        self._client.stop_trial(self._uid)

    def delete(self) -> None:
        self._client.delete_trial(self._uid)

    def materialize(self) -> vz.Trial:
        return self._client.get_trial(self._uid)

    def update_metadata(self, delta: vz.Metadata) -> None:
        md = vz.MetadataDelta(on_trials={self._uid: delta})
        self._client.update_metadata(md)

    @property
    def status(self) -> vz.TrialStatus:
        return self.materialize().status


class Study(client_abc.StudyInterface):
    def __init__(self, client: vizier_client.VizierClient):
        self._client = client
        # client_id -> VizierClient scoped to it. Building a VizierClient
        # is not free (RetryPolicy + jitter RNG construction), and the
        # multi-worker stress shape calls suggest(client_id=...) per trial;
        # clients are stateless wrappers over the shared service handle, so
        # caching per worker id is safe.
        self._scoped_clients: Dict[str, vizier_client.VizierClient] = {}

    # -- factories ---------------------------------------------------------

    @classmethod
    def from_study_config(
        cls,
        config: vz.StudyConfig,
        *,
        owner: str = "owner",
        study_id: str = "",
        client_id: str = "default_client_id",
        endpoint: Optional[str] = None,
    ) -> "Study":
        study_id = study_id or f"study-{secrets.token_hex(4)}"
        return cls(
            vizier_client.VizierClient.create_or_load_study(
                owner, study_id, config, client_id=client_id, endpoint=endpoint
            )
        )

    @classmethod
    def from_resource_name(
        cls,
        name: str,
        *,
        client_id: str = "default_client_id",
        endpoint: Optional[str] = None,
    ) -> "Study":
        try:
            return cls(
                vizier_client.VizierClient.load_study(
                    name, client_id=client_id, endpoint=endpoint
                )
            )
        except KeyError as e:
            raise client_abc.ResourceNotFoundError(str(e))

    # -- StudyInterface ----------------------------------------------------

    @property
    def resource_name(self) -> str:
        return self._client.study_name

    def suggest(
        self, *, count: Optional[int] = None, client_id: Optional[str] = None
    ) -> List[Trial]:
        if client_id is not None and client_id != self._client.client_id:
            scoped = self._scoped_clients.get(client_id)
            if scoped is None:
                scoped = self._scoped_clients[client_id] = vizier_client.VizierClient(
                    self._client._service, self._client.study_name, client_id
                )
        else:
            scoped = self._client
        trials = scoped.get_suggestions(count or 1)
        return [Trial(self._client, t.id, snapshot=t) for t in trials]

    def delete(self) -> None:
        self._client.delete_study()

    def trials(
        self, trial_filter: Optional[vz.TrialFilter] = None
    ) -> Collection[Trial]:
        all_trials = self._client.list_trials()
        if trial_filter is not None:
            all_trials = [t for t in all_trials if trial_filter(t)]
        return [Trial(self._client, t.id) for t in all_trials]

    def get_trial(self, uid: int) -> Trial:
        try:
            self._client.get_trial(uid)
        except KeyError as e:
            raise client_abc.ResourceNotFoundError(str(e))
        return Trial(self._client, uid)

    def optimal_trials(self, count: Optional[int] = None) -> Collection[Trial]:
        optimal = self._client.list_optimal_trials()
        if count is not None:
            optimal = optimal[:count]
        return [Trial(self._client, t.id) for t in optimal]

    def materialize_study_config(self) -> vz.StudyConfig:
        return self._client.get_study_config()

    def materialize_state(self) -> vz.StudyState:
        from vizier_tpu_torch.service.protos import study_pb2, vizier_service_pb2

        study = self._client._service.GetStudy(
            vizier_service_pb2.GetStudyRequest(name=self._client.study_name)
        )
        state_map = {
            study_pb2.Study.ACTIVE: vz.StudyState.ACTIVE,
            study_pb2.Study.INACTIVE: vz.StudyState.ABORTED,
            study_pb2.Study.COMPLETED: vz.StudyState.COMPLETED,
        }
        return state_map.get(study.state, vz.StudyState.ACTIVE)

    def set_state(self, state: vz.StudyState) -> None:
        self._client.set_study_state(state)

    def update_metadata(self, delta: vz.Metadata) -> None:
        self._client.update_metadata(vz.MetadataDelta(on_study=delta))
