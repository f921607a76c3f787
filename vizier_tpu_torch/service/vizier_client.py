"""Low-level Vizier client: RPC wrappers + suggestion-operation polling.

A copy of the JAX package's ``service/vizier_client.py``: the client
targets either a remote gRPC endpoint or an in-process ``VizierServicer``
through the same interface. The JAX client's routed multi-replica stub
(``server_endpoints``) belongs to the fleet, which is not ported yet.
"""

from __future__ import annotations

import atexit
import dataclasses
import time
from typing import Any, Dict, List, Optional

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.reliability import config as reliability_config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import retry as retry_lib
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import study_pb2, vizier_service_pb2

NO_ENDPOINT = "NO_ENDPOINT"

# Hard ceiling on retry-after-paced shed retries per get_suggestions call
# (the overall polling deadline is the real bound; this stops a pathological
# zero-hint loop from spinning).
_MAX_SHED_RETRIES = 100


@dataclasses.dataclass
class EnvironmentVariables:
    """Process-global client defaults."""

    server_endpoint: str = NO_ENDPOINT
    # Where the in-process service's Pythia runs its designers (the
    # NO_ENDPOINT path): CUDA unless set to "cpu".
    device: str = "cuda"
    servicer_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Initial GetOperation poll delay; grows by bounded exponential backoff
    # (doubling with jitter, capped at 8x) while an op stays not-done.
    polling_delay_secs: float = 0.1
    polling_timeout_secs: float = 600.0


environment_variables = EnvironmentVariables()

_local_servicer = None


def _get_local_servicer():
    """Lazily creates one in-process service shared by local clients."""
    global _local_servicer
    if _local_servicer is None:
        from vizier_tpu_torch.service import pythia_service, vizier_service

        servicer = vizier_service.VizierServicer(
            **environment_variables.servicer_kwargs
        )
        pythia = pythia_service.PythiaServicer(
            servicer, device=environment_variables.device
        )
        servicer.set_pythia(pythia)
        _local_servicer = servicer
        # The serving runtime's batch-executor thread is drained before
        # interpreter teardown. Explicit servers shut down through their own
        # lifecycle; the implicit in-process service gets an atexit hook
        # (shutdown is idempotent).
        atexit.register(pythia.shutdown)
    return _local_servicer


def create_service_stub(endpoint: Optional[str] = None):
    """Returns a gRPC stub or the in-process servicer — duck-typed alike, so
    callers cannot tell them apart."""
    endpoint = endpoint or environment_variables.server_endpoint
    if endpoint == NO_ENDPOINT:
        return _get_local_servicer()
    from vizier_tpu_torch.service import grpc_stubs

    return grpc_stubs.create_vizier_stub(endpoint)


class VizierClient:
    """Study-scoped RPC wrapper.

    Every RPC goes through a :class:`~vizier_tpu_torch.reliability.RetryPolicy`
    (exponential backoff + full jitter over transient transport errors),
    and ``get_suggestions`` attaches a deadline budget to the request,
    polls with bounded exponential backoff, and retries ops that failed
    with a ``TRANSIENT:``-marked error. ``VIZIER_TORCH_RELIABILITY=0`` (or a
    ``reliability`` config with everything off) restores fail-hard,
    fixed-sleep behavior.
    """

    def __init__(
        self,
        service,
        study_name: str,
        client_id: str,
        *,
        reliability: Optional[reliability_config_lib.ReliabilityConfig] = None,
    ):
        self._service = service
        self._study_name = study_name
        self._client_id = client_id
        self._reliability = (
            reliability or reliability_config_lib.ReliabilityConfig.from_env()
        )
        self._retry = retry_lib.RetryPolicy.from_config(self._reliability)

    # -- reliability plumbing ----------------------------------------------

    def _count_retry(self, error: BaseException, attempt: int) -> None:
        del error, attempt
        # Surfaces in serving_stats() when the service is in-process; a
        # remote stub has no retry-accounting RPC, so this is best-effort.
        record = getattr(self._service, "record_client_retry", None)
        if record is not None:
            try:
                record(1)
            except Exception:
                pass

    def _call(self, method_name: str, request, deadline=None):
        """One RPC with transient-error retries (when reliability is on).

        At-least-once semantics: a transient failure on the response path
        of a mutating RPC can re-apply it (a duplicated measurement, or a
        "already completed" error on a replayed CompleteTrial). The
        service's idempotent paths (op dedup, ACTIVE-trial reuse) absorb
        the suggest-side cases; the rest is the standard retry tradeoff.
        """
        method = getattr(self._service, method_name)
        if not self._reliability.retries_on:
            return method(request)
        return self._retry.call(
            lambda: method(request), on_retry=self._count_retry, deadline=deadline
        )

    @property
    def study_name(self) -> str:
        return self._study_name

    @property
    def client_id(self) -> str:
        return self._client_id

    # -- factory -----------------------------------------------------------

    @classmethod
    def create_or_load_study(
        cls,
        owner_id: str,
        study_id: str,
        study_config: vz.StudyConfig,
        *,
        client_id: str = "default_client_id",
        endpoint: Optional[str] = None,
    ) -> "VizierClient":
        service = create_service_stub(endpoint)
        study_name = resources.StudyResource(owner_id, study_id).name
        study = pc.study_to_proto(study_config, study_name, display_name=study_id)
        service.CreateStudy(
            vizier_service_pb2.CreateStudyRequest(
                parent=resources.OwnerResource(owner_id).name, study=study
            )
        )
        return cls(service, study_name, client_id)

    @classmethod
    def load_study(
        cls,
        study_name: str,
        *,
        client_id: str = "default_client_id",
        endpoint: Optional[str] = None,
    ) -> "VizierClient":
        service = create_service_stub(endpoint)
        service.GetStudy(vizier_service_pb2.GetStudyRequest(name=study_name))
        return cls(service, study_name, client_id)

    # -- suggestions -------------------------------------------------------

    def get_suggestions(
        self, suggestion_count: int, *, deadline_secs: Optional[float] = None
    ) -> List[vz.Trial]:
        """Requests suggestions, polling the long-running operation.

        The whole exchange — RPCs, polling, and op-level retries — is
        bounded by ``polling_timeout_secs``. With deadlines on, a budget
        (``deadline_secs`` or the config default, never more than the
        remaining polling window) rides on each request so the service can
        complete an over-budget computation with a typed
        ``TRANSIENT: DEADLINE_EXCEEDED:`` error instead of silently burning
        this client's polling timeout. Ops that fail with a
        ``TRANSIENT:``-marked error are retried with backoff; permanent
        errors raise immediately.
        """
        cfg = self._reliability
        overall = deadline_lib.Deadline.from_budget(
            environment_variables.polling_timeout_secs
        )
        attempts = max(1, cfg.retry_max_attempts) if cfg.retries_on else 1
        op = None
        # The trace root: every downstream hop (service, Pythia dispatch,
        # designer compute) parents onto this span via the request's
        # trace_context field.
        with tracing_lib.get_tracer().span(
            "client.suggest",
            study=self._study_name,
            client_id=self._client_id,
            count=int(suggestion_count),
        ) as span:
            attempt = 0
            shed_retries = 0
            while True:
                op = self._poll_suggest_op(
                    suggestion_count, overall, deadline_secs
                )
                if not op.error:
                    return [pc.trial_from_proto(t) for t in op.response.trials]
                if not errors_lib.has_transient_marker(op.error):
                    break
                # An admission shed carrying a retry-after hint is
                # BACKPRESSURE, not failure: the service is pacing this
                # client, so honoring the hint must not burn the fixed
                # retry budget (a saturated-but-recovering fleet would
                # otherwise fail exactly the clients it asked to wait).
                # Shed retries are bounded by the overall polling deadline
                # and a hard ceiling instead.
                hint = (
                    errors_lib.retry_after_secs(op.error)
                    if cfg.retries_on
                    else None
                )
                if hint is not None and shed_retries < _MAX_SHED_RETRIES:
                    shed_retries += 1
                    delay = max(self._retry.delay_for_attempt(attempt), hint)
                    if overall.remaining() <= delay:
                        break
                    self._count_retry(RuntimeError(op.error), attempt)
                    span.add_event("shed_retry", shed=shed_retries)
                    self._retry.sleep_fn(delay)
                    continue
                attempt += 1
                if attempt >= attempts:
                    break
                delay = self._retry.delay_for_attempt(attempt - 1)
                if overall.remaining() <= delay:
                    break
                self._count_retry(RuntimeError(op.error), attempt - 1)
                span.add_event("transient_retry", attempt=attempt - 1)
                self._retry.sleep_fn(delay)
            span.set_attribute("error", op.error.splitlines()[0][:200])
        raise RuntimeError(f"SuggestTrials failed: {op.error}")

    def _poll_suggest_op(
        self,
        suggestion_count: int,
        overall: deadline_lib.Deadline,
        deadline_secs: Optional[float],
    ) -> vizier_service_pb2.Operation:
        """One SuggestTrials round-trip: issue the op, poll it to done."""
        budget = 0.0
        if self._reliability.deadlines_on:
            budget = (
                deadline_secs
                if deadline_secs is not None
                else self._reliability.default_deadline_secs
            )
            # Never promise the service more budget than this client will
            # actually wait.
            budget = min(budget, overall.remaining())
            if budget <= 0.0:
                # The budget is already gone at send time. 0 on the wire
                # means "no deadline", so an expired budget travels as a
                # NEGATIVE value — the service ingress sheds it with the
                # typed deadline error instead of computing unbounded.
                budget = min(budget, -1e-3)
        op = self._call(
            "SuggestTrials",
            vizier_service_pb2.SuggestTrialsRequest(
                parent=self._study_name,
                suggestion_count=suggestion_count,
                client_id=self._client_id,
                deadline_secs=budget,
                # Carries the client.suggest span across the RPC ('' when
                # tracing is off — the service then starts its own trace).
                trace_context=tracing_lib.format_context(
                    tracing_lib.get_tracer().current_context()
                ),
            ),
            deadline=overall,
        )
        # Bounded exponential backoff on the poll (satellite of the fixed
        # 100 ms sleep): doubles per not-done poll, jittered, capped at 8x
        # the base delay — cutting idle GetOperation load at scale while
        # keeping first-response latency identical.
        base = environment_variables.polling_delay_secs
        delay = base
        while not op.done:
            if overall.expired:
                raise TimeoutError(f"Suggestion operation timed out: {op.name}")
            jittered = (
                self._retry.rng.uniform(0.5 * delay, delay)
                if self._retry.jitter
                else delay
            )
            time.sleep(min(jittered, max(0.0, overall.remaining())))
            op = self._call(
                "GetOperation",
                vizier_service_pb2.GetOperationRequest(name=op.name),
                deadline=overall,
            )
            delay = min(delay * 2.0, base * 8.0)
        return op

    # -- trials ------------------------------------------------------------

    def _trial_name(self, trial_id: int) -> str:
        return resources.StudyResource.from_name(self._study_name).trial_resource(
            trial_id
        ).name

    def create_trial(self, trial: vz.Trial) -> vz.Trial:
        proto = pc.trial_to_proto(trial)
        out = self._call("CreateTrial",
            vizier_service_pb2.CreateTrialRequest(parent=self._study_name, trial=proto)
        )
        return pc.trial_from_proto(out)

    def get_trial(self, trial_id: int) -> vz.Trial:
        return pc.trial_from_proto(
            self._call("GetTrial",
                vizier_service_pb2.GetTrialRequest(name=self._trial_name(trial_id))
            )
        )

    def list_trials(self) -> List[vz.Trial]:
        response = self._call("ListTrials",
            vizier_service_pb2.ListTrialsRequest(parent=self._study_name)
        )
        return [pc.trial_from_proto(t) for t in response.trials]

    def report_intermediate_objective_value(
        self, trial_id: int, measurement: vz.Measurement
    ) -> vz.Trial:
        out = self._call("AddTrialMeasurement",
            vizier_service_pb2.AddTrialMeasurementRequest(
                trial_name=self._trial_name(trial_id),
                measurement=pc.measurement_to_proto(measurement),
            )
        )
        return pc.trial_from_proto(out)

    def complete_trial(
        self,
        trial_id: int,
        final_measurement: Optional[vz.Measurement] = None,
        *,
        infeasibility_reason: Optional[str] = None,
    ) -> vz.Trial:
        request = vizier_service_pb2.CompleteTrialRequest(
            name=self._trial_name(trial_id),
            trial_infeasible=infeasibility_reason is not None,
            infeasible_reason=infeasibility_reason or "",
        )
        if final_measurement is not None:
            request.final_measurement.CopyFrom(
                pc.measurement_to_proto(final_measurement)
            )
        return pc.trial_from_proto(self._call("CompleteTrial", request))

    def should_trial_stop(self, trial_id: int) -> bool:
        response = self._call("CheckTrialEarlyStoppingState",
            vizier_service_pb2.CheckTrialEarlyStoppingStateRequest(
                trial_name=self._trial_name(trial_id)
            )
        )
        return response.should_stop

    def stop_trial(self, trial_id: int) -> vz.Trial:
        return pc.trial_from_proto(
            self._call("StopTrial",
                vizier_service_pb2.StopTrialRequest(name=self._trial_name(trial_id))
            )
        )

    def delete_trial(self, trial_id: int) -> None:
        self._call("DeleteTrial",
            vizier_service_pb2.DeleteTrialRequest(name=self._trial_name(trial_id))
        )

    # -- study -------------------------------------------------------------

    def get_study_config(self, study_name: Optional[str] = None) -> vz.StudyConfig:
        study = self._call("GetStudy",
            vizier_service_pb2.GetStudyRequest(name=study_name or self._study_name)
        )
        return pc.study_config_from_proto(study.study_spec)

    def cached_study_config(self) -> vz.StudyConfig:
        """This study's config, fetched once per client — for SPEC decoding.

        The service has no RPC that edits a study's search space or metric
        configuration after creation (``SetStudyState`` touches state only),
        so spec-derived uses — e.g. decoding trial parameters — can reuse
        one fetch instead of a ``GetStudy`` round-trip per access. Study
        METADATA is mutable via ``UpdateMetadata`` and may be stale here;
        metadata readers must use :meth:`get_study_config`.
        """
        cached = getattr(self, "_study_config_cache", None)
        if cached is None:
            cached = self._study_config_cache = self.get_study_config()
        return cached

    def set_study_state(self, state: vz.StudyState, reason: str = "") -> None:
        state_map = {
            vz.StudyState.ACTIVE: study_pb2.Study.ACTIVE,
            vz.StudyState.ABORTED: study_pb2.Study.INACTIVE,
            vz.StudyState.COMPLETED: study_pb2.Study.COMPLETED,
        }
        self._call("SetStudyState",
            vizier_service_pb2.SetStudyStateRequest(
                name=self._study_name, state=state_map[state], reason=reason
            )
        )

    def delete_study(self) -> None:
        self._call("DeleteStudy",
            vizier_service_pb2.DeleteStudyRequest(name=self._study_name)
        )

    def list_optimal_trials(self) -> List[vz.Trial]:
        response = self._call("ListOptimalTrials",
            vizier_service_pb2.ListOptimalTrialsRequest(parent=self._study_name)
        )
        return [pc.trial_from_proto(t) for t in response.optimal_trials]

    def update_metadata(self, delta: vz.MetadataDelta) -> None:
        request = vizier_service_pb2.UpdateMetadataRequest(name=self._study_name)
        for kv in pc.metadata_to_key_values(delta.on_study):
            unit = request.deltas.add()
            unit.trial_id = 0
            unit.key_value.CopyFrom(kv)
        for trial_id, md in delta.on_trials.items():
            for kv in pc.metadata_to_key_values(md):
                unit = request.deltas.add()
                unit.trial_id = trial_id
                unit.key_value.CopyFrom(kv)
        response = self._call("UpdateMetadata", request)
        if response.error_details:
            raise KeyError(response.error_details)
