"""VizierServicer: study/trial lifecycle + Pythia dispatch.

A copy of the JAX package's ``service/vizier_service.py``, with every RPC
that ``grpc_stubs.VIZIER_METHODS`` lists. The multi-worker behavioral
contract:

- per-(owner/study/operation) locks; datastore does its own locking;
- ``SuggestTrials`` first returns the client's existing ACTIVE trials, then
  drains the REQUESTED pool, then dispatches to Pythia — so a crashed
  worker that re-requests gets its old trials back;
- suggestion operations are deduplicated per client (an unfinished op for
  the same client is returned as-is);
- Pythia failures are captured into the operation's ``error`` field;
- completed trials and completed studies are immutable;
- early-stopping ops are recycled after ``early_stop_recycle_period``.

Every suggest, completion and expired ingress lands on the study's
flight-recorder ring (``VIZIER_TORCH_FLIGHT_RECORDER=1``; a no-op otherwise);
each completion or measurement tells an in-process Pythia that the study's
frontier moved, the speculative engine's trigger; and with admission armed
the service hop's latency series is split per tenant.
"""

from __future__ import annotations

import collections
import datetime
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.reliability import config as reliability_config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.service import datastore as datastore_lib
from vizier_tpu_torch.service import pythia_util
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service import sql_datastore
from vizier_tpu_torch.service.protos import pythia_service_pb2
from vizier_tpu_torch.service.protos import study_pb2, vizier_service_pb2
from vizier_tpu_torch.serving import admission as admission_lib

_logger = logging.getLogger(__name__)


class VizierServicer:
    """The study service; callable in-process or wrapped by gRPC."""

    # Which fleet replica this servicer is (set by ReplicaManager /
    # replica_main); '' = standalone. Stamped onto request spans so a
    # fleet merge can split one process's span ring back into per-replica
    # dumps (observability.fleet).
    replica_id = ""

    def __init__(
        self,
        *,
        database_url: Optional[str] = None,
        datastore: Optional[datastore_lib.DataStore] = None,
        early_stop_recycle_period: datetime.timedelta = datetime.timedelta(seconds=60),
        reliability_config: Optional[reliability_config_lib.ReliabilityConfig] = None,
    ):
        # An injected datastore wins over ``database_url``.
        if datastore is not None:
            if database_url is not None:
                raise ValueError("Pass either datastore or database_url, not both.")
            self.datastore: datastore_lib.DataStore = datastore
        elif database_url is None:
            self.datastore = ram_datastore.NestedDictRAMDataStore()
        else:
            self.datastore = sql_datastore.SQLDataStore(database_url)
        self._early_stop_recycle_period = early_stop_recycle_period
        self._reliability = (
            reliability_config or reliability_config_lib.ReliabilityConfig.from_env()
        )
        self._study_locks: Dict[str, threading.Lock] = collections.defaultdict(
            threading.Lock
        )
        self._policy_factory = None  # set via set_policy_factory / pythia servicer
        self._pythia = None  # object with Suggest/EarlyStop proto methods
        # Ops created by THIS process; a persisted not-done op absent from
        # here was orphaned by a crash and must not wedge its client.
        self._inflight_ops: set = set()

    def set_pythia(self, pythia) -> None:
        """Connects a Pythia endpoint (in-process servicer or gRPC stub)."""
        self._pythia = pythia

    # -- observability (in-process Pythia only) ----------------------------

    def _serving_stats_sink(self):
        """The connected Pythia's ServingStats, or None (remote stub)."""
        runtime = getattr(self._pythia, "serving_runtime", None)
        return runtime.stats if runtime is not None else None

    def record_client_retry(self, amount: int = 1) -> None:
        """Client-side retry accounting (no-op without in-process Pythia).

        Clients of the in-process servicer report their RPC/suggest retries
        here so they surface in ``serving_stats()`` next to the server-side
        fallback/breaker counters; a remote client's retries are only
        observable client-side.
        """
        stats = self._serving_stats_sink()
        if stats is not None:
            stats.increment("retries", amount)

    def prometheus_text(self) -> str:
        """Delegates to the in-process Pythia's metric dump ('' if remote)."""
        dump = getattr(self._pythia, "prometheus_text", None)
        return dump() if dump is not None else ""

    def trial_frontier(self, study_name: str) -> Tuple[List[int], List[int], int]:
        """``(completed_ids, active_ids, max_trial_id)`` for a study.

        The designer-visible frontier identity, read as bare id/state pairs
        (no proto copies): completed = SUCCEEDED|INFEASIBLE (what the policy
        feeds ``designer.update``), active = ACTIVE (the pending points batch
        designers condition on). The speculative pre-compute fingerprints
        this to decide whether a parked suggestion batch still matches.
        """
        completed: List[int] = []
        active: List[int] = []
        max_id = 0
        for trial_id, state in self.datastore.trial_states(study_name):
            trial_id = int(trial_id)
            max_id = max(max_id, trial_id)
            if state in (study_pb2.Trial.SUCCEEDED, study_pb2.Trial.INFEASIBLE):
                completed.append(trial_id)
            elif state == study_pb2.Trial.ACTIVE:
                active.append(trial_id)
        return completed, active, max_id

    def _notify_trial_event(self, study_name: str) -> None:
        """Tells the in-process Pythia the study's frontier moved, so it can
        invalidate and re-speculate the next suggestion batch. Called outside
        the study lock (the engine's enqueue takes its own queue lock).
        Best-effort: a remote Pythia stub has no trigger surface and relies
        on the serve-time fingerprint check alone."""
        notify = getattr(self._pythia, "notify_trial_event", None)
        if notify is None:
            return
        try:
            notify(study_name)
        except Exception as e:  # completion must not fail on speculation
            _logger.warning("Speculative trigger failed for %s: %s", study_name, e)

    # -- studies -----------------------------------------------------------

    def CreateStudy(
        self, request: vizier_service_pb2.CreateStudyRequest, context=None
    ) -> study_pb2.Study:
        owner = resources.OwnerResource.from_name(request.parent)
        study = request.study
        if not study.name:
            study_id = study.display_name or f"study-{int(time.time() * 1e6)}"
            study.name = f"{owner.name}/studies/{study_id}"
        try:
            self.datastore.create_study(study)
        except datastore_lib.AlreadyExistsError:
            # create_or_load semantics: return the existing study.
            return self.datastore.load_study(study.name)
        return self.datastore.load_study(study.name)

    def GetStudy(
        self, request: vizier_service_pb2.GetStudyRequest, context=None
    ) -> study_pb2.Study:
        return self.datastore.load_study(request.name)

    def ListStudies(
        self, request: vizier_service_pb2.ListStudiesRequest, context=None
    ) -> vizier_service_pb2.ListStudiesResponse:
        return vizier_service_pb2.ListStudiesResponse(
            studies=self.datastore.list_studies(request.parent)
        )

    def DeleteStudy(
        self, request: vizier_service_pb2.DeleteStudyRequest, context=None
    ) -> vizier_service_pb2.Empty:
        self.datastore.delete_study(request.name)
        # Explicitly drop the study's serving state (cached designer, warm
        # ARD params, stopping policies): a reused study name must never
        # see its predecessor's designer. In-process Pythia only — a remote
        # Pythia stub has no invalidation RPC and relies on the cache TTL.
        invalidate = getattr(self._pythia, "invalidate_study", None)
        if invalidate is not None:
            try:
                invalidate(request.name)
            except Exception as e:  # deletion must not fail on cache cleanup
                _logger.warning("Serving-state invalidation failed: %s", e)
        return vizier_service_pb2.Empty()

    def SetStudyState(
        self, request: vizier_service_pb2.SetStudyStateRequest, context=None
    ) -> study_pb2.Study:
        study = self.datastore.load_study(request.name)
        study.state = request.state
        study.state_reason = request.reason
        self.datastore.update_study(study)
        return study

    # -- suggestions -------------------------------------------------------

    def SuggestTrials(
        self, request: vizier_service_pb2.SuggestTrialsRequest, context=None
    ) -> vizier_service_pb2.Operation:
        # The service hop's span: parented on the client's span when the
        # request carries a trace context, a fresh trace otherwise.
        tracer = tracing_lib.get_tracer()
        parent = tracing_lib.parse_context(request.trace_context)
        t0 = time.perf_counter()
        attrs = {"replica": self.replica_id} if self.replica_id else {}
        with tracer.span(
            "service.suggest_trials",
            parent=parent,
            study=request.parent,
            client_id=request.client_id or "default_client_id",
            deadline_budget_secs=float(request.deadline_secs),
            **attrs,
        ) as span:
            op = self._suggest_trials(request)
            span.set_attribute("operation", op.name)
            if op.error:
                span.set_attribute("error", op.error.splitlines()[0][:200])
            trace_id = getattr(span, "trace_id", None)
        elapsed = time.perf_counter() - t0
        recorder_lib.get_recorder().record(
            request.parent, "suggest", trace_id=trace_id,
            operation=op.name, replica=self.replica_id or None,
            duration_secs=round(elapsed, 6), error=bool(op.error),
        )
        runtime = getattr(self._pythia, "serving_runtime", None)
        if runtime is not None:
            # Per-tenant latency series (admission armed only, so the metric
            # series stay as they were with it off): feeds the SLO engine's
            # per-tenant p99 objective.
            tenant = None
            if getattr(runtime, "admission", None) is not None:
                tenant = admission_lib.tenant_of(request.parent)
            runtime.observe_suggest_latency("service", elapsed, trace_id=trace_id, tenant=tenant)
        return op

    def _suggest_trials(
        self, request: vizier_service_pb2.SuggestTrialsRequest
    ) -> vizier_service_pb2.Operation:
        study_name = request.parent
        client_id = request.client_id or "default_client_id"

        # Ingress deadline check: a request whose wire budget is already
        # expired (negative ``deadline_secs`` — the client's remaining
        # budget at send time) must never reach Pythia: the caller has
        # given up, so a designer computation would complete work nobody
        # reads. Short-circuit with the typed error on a synthetic done
        # op — no op number is consumed, nothing is persisted.
        if self._reliability.deadlines_on and request.deadline_secs < 0:
            stats = self._serving_stats_sink()
            if stats is not None:
                stats.increment("deadline_exceeded")
            tracing_lib.add_current_event(
                "deadline.exceeded", at="service_ingress"
            )
            recorder_lib.get_recorder().record(
                study_name, "deadline_expired_at_ingress",
                budget_secs=float(request.deadline_secs),
            )
            op = vizier_service_pb2.Operation(
                name=(
                    f"{study_name}/clients/{client_id}/operations/expired"
                ),
                done=True,
            )
            op.error = errors_lib.format_op_error(
                errors_lib.DeadlineExceededError(
                    errors_lib.mark_transient(
                        "DEADLINE_EXCEEDED: request budget expired "
                        f"{-request.deadline_secs:.3f}s before dispatch; "
                        "designer computation skipped."
                    )
                )
            )
            return op
        with self._study_locks[study_name]:
            study = self.datastore.load_study(study_name)
            if study.state != study_pb2.Study.ACTIVE:
                raise ValueError(f"Study {study_name} is not ACTIVE.")

            # Op dedup: an unfinished op for this client is returned as-is —
            # unless it was orphaned by a server crash (persisted not-done
            # but not in flight here), in which case it is failed and retried.
            unfinished = self.datastore.list_suggestion_operations(
                study_name, client_id, done=False
            )
            for op in unfinished:
                if op.name in self._inflight_ops:
                    return op
                op.done = True
                op.error = "Orphaned by server restart; retry."
                self.datastore.update_suggestion_operation(op)

            op_number = self.datastore.max_suggestion_operation_number(
                study_name, client_id
            ) + 1
            sr = resources.StudyResource.from_name(study_name)
            op = vizier_service_pb2.Operation(
                name=resources.SuggestionOperationResource(
                    sr.owner_id, sr.study_id, client_id, op_number
                ).name
            )
            self.datastore.create_suggestion_operation(op)
            self._inflight_ops.add(op.name)

        # The Pythia dispatch runs OUTSIDE the study lock (see _suggest):
        # the lock protects datastore read-modify-write windows, not the
        # designer computation. Concurrent clients therefore reach Pythia
        # with the same trial frontier and coalesce onto ONE computation
        # (vizier_tpu_torch.serving); a same-client retry meanwhile sees the
        # not-done op above and polls GetOperation, the
        # long-running-operation contract.
        #
        # The client's deadline budget (request.deadline_secs, remaining
        # seconds) becomes a Deadline here and is decremented across every
        # hop below; transient failures are marked TRANSIENT: in op.error
        # so client retry logic can tell them from permanent errors.
        deadline = (
            deadline_lib.Deadline.from_budget(request.deadline_secs)
            if self._reliability.deadlines_on
            else deadline_lib.Deadline.none()
        )
        try:
            trials = self._suggest(
                study, study_name, client_id, request, deadline, op.name
            )
            op.response.trials.extend(trials)
        except Exception as e:  # captured into the long-running op
            op.error = errors_lib.format_op_error(e)
        finally:
            op.done = True
            self.datastore.update_suggestion_operation(op)
            self._inflight_ops.discard(op.name)
        return op

    def _claim_open_trials(
        self, study_name: str, client_id: str, count: int, *, reuse_active: bool = True
    ) -> Tuple[List[study_pb2.Trial], bool]:
        """Under the study lock: ACTIVE reuse, then REQUESTED-pool drain.

        Returns ``(trials, reused)``: ``reused`` means the client's
        existing ACTIVE trials were returned (no pool mutation).
        ``reuse_active=False`` skips that branch — the post-compute
        re-drain must not hand the client back the trials it claimed in
        phase 1.
        """
        # Only ACTIVE/REQUESTED rows matter here; the storage-level filter
        # keeps this scan O(open trials) instead of O(study history)
        # (measured: RANDOM_SEARCH suggest throughput fell 430→50/s over a
        # 5k-trial soak with the unfiltered read).
        open_trials = self.datastore.list_trials(
            study_name,
            states=(study_pb2.Trial.ACTIVE, study_pb2.Trial.REQUESTED),
        )

        # 1. Reuse this client's ACTIVE trials.
        if reuse_active:
            active_for_client = [
                t
                for t in open_trials
                if t.state == study_pb2.Trial.ACTIVE
                and t.assigned_worker == client_id
            ]
            if active_for_client:
                return active_for_client[:count], True

        # 2. Drain the REQUESTED pool.
        out: List[study_pb2.Trial] = []
        for t in open_trials:
            if len(out) >= count:
                break
            if t.state == study_pb2.Trial.REQUESTED:
                t.state = study_pb2.Trial.ACTIVE
                t.assigned_worker = client_id
                self.datastore.update_trial(t)
                out.append(t)
        return out, False

    def _suggest(
        self,
        study: study_pb2.Study,
        study_name: str,
        client_id: str,
        request: vizier_service_pb2.SuggestTrialsRequest,
        deadline: deadline_lib.Deadline = deadline_lib.Deadline.none(),
        operation_name: str = "",
    ) -> List[study_pb2.Trial]:
        count = request.suggestion_count or 1
        with self._study_locks[study_name]:
            out, reused = self._claim_open_trials(study_name, client_id, count)
            if reused or len(out) >= count:
                return out
            max_id = self.datastore.max_trial_id(study_name)

        # 3. Ask Pythia for the remainder — lock released, so concurrent
        # clients' identical requests can coalesce at the compute level.
        if self._pythia is None:
            raise RuntimeError("No Pythia endpoint connected to the Vizier service.")
        deadline.check(f"Pythia dispatch for operation {operation_name!r}")
        preq = pythia_service_pb2.PythiaSuggestRequest(
            count=count - len(out),
            algorithm=study.study_spec.algorithm,
            study_name=study_name,
            deadline_secs=deadline.wire_budget(),
        )
        preq.study_descriptor.config.CopyFrom(study.study_spec)
        preq.study_descriptor.guid = study_name
        preq.study_descriptor.max_trial_id = max_id
        tracer = tracing_lib.get_tracer()
        with tracer.span(
            "service.pythia_dispatch",
            study=study_name,
            deadline_remaining_secs=(
                deadline.remaining() if deadline.is_set else 0.0
            ),
        ) as dispatch_span:
            # The dispatch span rides the wire so Pythia's spans parent
            # correctly even across the worker-thread / process hop.
            preq.trace_context = tracing_lib.format_context(
                dispatch_span.context()
            )
            presp = self._dispatch_pythia(preq, deadline, operation_name)
        if presp.error:
            if errors_lib.has_transient_marker(presp.error):
                raise errors_lib.TransientError(f"Pythia error: {presp.error}")
            raise RuntimeError(f"Pythia error: {presp.error}")

        sr = resources.StudyResource.from_name(study_name)
        with self._study_locks[study_name]:
            # Re-drain first: a coalesced peer that shared this computation
            # may have materialized extras as REQUESTED while we waited —
            # claiming those avoids creating duplicate trials for the same
            # suggested points.
            refill, _ = self._claim_open_trials(
                study_name, client_id, count - len(out), reuse_active=False
            )
            redrained = bool(refill)
            out.extend(refill)

            # Materialize suggestions as trials: the first `remaining`
            # become ACTIVE for this client; extras (policy over-produced)
            # stay REQUESTED. When the re-drain supplied trials, only the
            # shortfall is materialized — the shared computation's points
            # already exist as the peer's trials.
            remaining = count - len(out)
            to_create = (
                list(presp.suggestions)[:remaining]
                if redrained
                else list(presp.suggestions)
            )
            next_id = self.datastore.max_trial_id(study_name)
            for i, suggestion in enumerate(to_create):
                next_id += 1
                t = study_pb2.Trial()
                t.CopyFrom(suggestion)
                t.id = next_id
                t.name = sr.trial_resource(next_id).name
                t.creation_time_secs = time.time()
                if i < remaining:
                    t.state = study_pb2.Trial.ACTIVE
                    t.assigned_worker = client_id
                else:
                    t.state = study_pb2.Trial.REQUESTED
                self.datastore.create_trial(t)
                if i < remaining:
                    out.append(t)

            # Persist policy metadata deltas AFTER trial creation so deltas
            # addressed to the new suggestions' ids resolve; a bad delta must
            # not lose the suggestion batch.
            study_kvs, trial_kvs = [], []
            for delta in presp.metadata_deltas:
                for kv in delta.key_values:
                    if delta.trial_id == 0:
                        study_kvs.append(kv)
                    else:
                        trial_kvs.append((int(delta.trial_id), kv))
            if study_kvs or trial_kvs:
                try:
                    self.datastore.update_metadata(study_name, study_kvs, trial_kvs)
                except datastore_lib.NotFoundError as e:
                    _logger.warning("Dropping policy metadata delta: %s", e)
        return out

    def _dispatch_pythia(self, preq, deadline: deadline_lib.Deadline, operation_name: str):
        """Runs the Pythia Suggest, bounded by the remaining deadline.

        With no deadline the call is synchronous. With
        one, the computation runs on a daemon thread reporting into a
        ``ResponseWaiter`` and the wait is capped at the remaining budget:
        a wedged designer can no longer hold the study's frontier past the
        client's deadline — the op completes with a typed
        ``TRANSIENT: DEADLINE_EXCEEDED:`` error while the abandoned
        computation finishes (and is discarded) in the background.
        """
        if not deadline.is_set:
            return self._pythia.Suggest(preq)
        waiter: pythia_util.ResponseWaiter = pythia_util.ResponseWaiter(
            operation_name=operation_name
        )
        # The worker thread starts with an empty contextvars context; carry
        # the dispatch span over so any spans opened on that thread (beyond
        # what the proto's trace_context already covers) parent correctly.
        tracer = tracing_lib.get_tracer()
        dispatch_ctx = tracer.current_context()

        def run():
            try:
                with tracer.use_context(dispatch_ctx):
                    waiter.Report(self._pythia.Suggest(preq))
            except BaseException as e:  # pragma: no cover - defensive
                try:
                    waiter.ReportError(e)
                except RuntimeError:
                    pass  # waiter already completed (should not happen)

        threading.Thread(
            target=run, daemon=True, name=f"pythia-suggest-{operation_name}"
        ).start()
        try:
            return waiter.WaitForResponse(timeout=max(0.0, deadline.remaining()))
        except TimeoutError as e:
            stats = self._serving_stats_sink()
            if stats is not None:
                stats.increment("deadline_exceeded")
            tracing_lib.add_current_event(
                "deadline.exceeded", at="pythia_wait", operation=operation_name
            )
            raise errors_lib.DeadlineExceededError(
                errors_lib.mark_transient(f"DEADLINE_EXCEEDED: {e}")
            ) from None

    def GetOperation(
        self, request: vizier_service_pb2.GetOperationRequest, context=None
    ) -> vizier_service_pb2.Operation:
        return self.datastore.get_suggestion_operation(request.name)

    # -- trials ------------------------------------------------------------

    def CreateTrial(
        self, request: vizier_service_pb2.CreateTrialRequest, context=None
    ) -> study_pb2.Trial:
        study_name = request.parent
        with self._study_locks[study_name]:
            sr = resources.StudyResource.from_name(study_name)
            trial = request.trial
            trial.id = self.datastore.max_trial_id(study_name) + 1
            trial.name = sr.trial_resource(trial.id).name
            if trial.state == study_pb2.Trial.STATE_UNSPECIFIED:
                trial.state = study_pb2.Trial.ACTIVE
            trial.creation_time_secs = time.time()
            self.datastore.create_trial(trial)
            return trial

    def GetTrial(
        self, request: vizier_service_pb2.GetTrialRequest, context=None
    ) -> study_pb2.Trial:
        return self.datastore.get_trial(request.name)

    def ListTrials(
        self, request: vizier_service_pb2.ListTrialsRequest, context=None
    ) -> vizier_service_pb2.ListTrialsResponse:
        return vizier_service_pb2.ListTrialsResponse(
            trials=self.datastore.list_trials(request.parent)
        )

    def AddTrialMeasurement(
        self, request: vizier_service_pb2.AddTrialMeasurementRequest, context=None
    ) -> study_pb2.Trial:
        study_name = resources.TrialResource.from_name(
            request.trial_name
        ).study_resource.name
        # Read-modify-write under the study lock: two workers racing here must
        # not both pass the completed check or drop each other's measurement.
        with self._study_locks[study_name]:
            trial = self.datastore.get_trial(request.trial_name)
            if trial.state in (study_pb2.Trial.SUCCEEDED, study_pb2.Trial.INFEASIBLE):
                raise ValueError(f"Trial {request.trial_name} is already completed.")
            trial.measurements.add().CopyFrom(request.measurement)
            self.datastore.update_trial(trial)
        self._notify_trial_event(study_name)
        return trial

    def CompleteTrial(
        self, request: vizier_service_pb2.CompleteTrialRequest, context=None
    ) -> study_pb2.Trial:
        study_name = resources.TrialResource.from_name(request.name).study_resource.name
        # The completion gets a span of its own: it is the trigger edge of
        # the speculative pre-compute, and the precompute span links back
        # here — "this completion set that compute in motion".
        tracer = tracing_lib.get_tracer()
        attrs = {"replica": self.replica_id} if self.replica_id else {}
        with tracer.span(
            "service.complete_trial", study=study_name, trial=request.name, **attrs
        ) as span:
            trial = self._complete_trial(request, study_name)
            self._notify_trial_event(study_name)
            trace_id = getattr(span, "trace_id", None)
        recorder_lib.get_recorder().record(
            study_name, "complete", trace_id=trace_id, trial=request.name,
            replica=self.replica_id or None,
            state=study_pb2.Trial.State.Name(trial.state),
        )
        return trial

    def _complete_trial(
        self, request: vizier_service_pb2.CompleteTrialRequest, study_name: str
    ) -> study_pb2.Trial:
        with self._study_locks[study_name]:
            trial = self.datastore.get_trial(request.name)
            study = self.datastore.load_study(study_name)
            if study.state == study_pb2.Study.COMPLETED:
                raise ValueError(
                    f"Study {study_name} is completed; trials are immutable."
                )
            if trial.state in (study_pb2.Trial.SUCCEEDED, study_pb2.Trial.INFEASIBLE):
                raise ValueError(f"Trial {request.name} is already completed.")

            if request.HasField("final_measurement"):
                trial.final_measurement.CopyFrom(request.final_measurement)
                trial.state = study_pb2.Trial.SUCCEEDED
            elif trial.measurements:
                trial.final_measurement.CopyFrom(trial.measurements[-1])
                trial.state = study_pb2.Trial.SUCCEEDED
            else:
                trial.state = study_pb2.Trial.INFEASIBLE
                trial.infeasibility_reason = (
                    request.infeasible_reason or "Completed without any measurement."
                )
            if request.trial_infeasible:
                trial.state = study_pb2.Trial.INFEASIBLE
                trial.infeasibility_reason = request.infeasible_reason or "infeasible"
            trial.completion_time_secs = time.time()
            self.datastore.update_trial(trial)
            return trial

    def DeleteTrial(
        self, request: vizier_service_pb2.DeleteTrialRequest, context=None
    ) -> vizier_service_pb2.Empty:
        self.datastore.delete_trial(request.name)
        return vizier_service_pb2.Empty()

    def StopTrial(
        self, request: vizier_service_pb2.StopTrialRequest, context=None
    ) -> study_pb2.Trial:
        study_name = resources.TrialResource.from_name(request.name).study_resource.name
        with self._study_locks[study_name]:
            trial = self.datastore.get_trial(request.name)
            if trial.state in (study_pb2.Trial.ACTIVE, study_pb2.Trial.REQUESTED):
                trial.state = study_pb2.Trial.STOPPING
                self.datastore.update_trial(trial)
            return trial

    # -- early stopping ----------------------------------------------------

    def CheckTrialEarlyStoppingState(
        self,
        request: vizier_service_pb2.CheckTrialEarlyStoppingStateRequest,
        context=None,
    ) -> vizier_service_pb2.CheckTrialEarlyStoppingStateResponse:
        tr = resources.TrialResource.from_name(request.trial_name)
        study_name = tr.study_resource.name
        with self._study_locks[study_name]:
            op_resource = resources.EarlyStoppingOperationResource(
                tr.owner_id, tr.study_id, tr.trial_id
            )
            now = time.time()
            period = self._early_stop_recycle_period.total_seconds()
            try:
                op = self.datastore.get_early_stopping_operation(op_resource.name)
                if op.status == vizier_service_pb2.EarlyStoppingOperation.DONE:
                    expired = now - op.completion_time_secs > period
                else:
                    # A stale ACTIVE op (Pythia crashed mid-computation) must
                    # also be recycled, or should_stop pins to False forever.
                    expired = now - op.creation_time_secs > period
                if not expired:
                    return vizier_service_pb2.CheckTrialEarlyStoppingStateResponse(
                        should_stop=op.should_stop
                    )
            except datastore_lib.NotFoundError:
                pass

            op = vizier_service_pb2.EarlyStoppingOperation(
                name=op_resource.name,
                status=vizier_service_pb2.EarlyStoppingOperation.ACTIVE,
                creation_time_secs=now,
            )
            self.datastore.create_early_stopping_operation(op)

            study = self.datastore.load_study(study_name)
            if not study.study_spec.HasField("early_stopping"):
                # Without a stopping config, nothing ever stops early.
                op.status = vizier_service_pb2.EarlyStoppingOperation.DONE
                op.should_stop = False
                op.completion_time_secs = time.time()
                self.datastore.update_early_stopping_operation(op)
                return vizier_service_pb2.CheckTrialEarlyStoppingStateResponse(
                    should_stop=False
                )
            if self._pythia is None:
                raise RuntimeError("No Pythia endpoint connected.")
            max_trial_id = self.datastore.max_trial_id(study_name)

        # The Pythia dispatch runs OUTSIDE the study lock, like the suggest
        # path: the lock protects datastore read-modify-write windows, not
        # the stopping-policy computation — holding it across a potentially
        # slow policy (or remote RPC) would stall every suggest/complete for
        # the study. A concurrent check racing this window sees the ACTIVE
        # op above and returns its (not-yet-stopping) answer instead of
        # blocking; it re-asks after the recycle period, the same contract
        # as a crashed-mid-computation op.
        preq = pythia_service_pb2.PythiaEarlyStopRequest(
            trial_ids=[tr.trial_id],
            algorithm=study.study_spec.algorithm,
            study_name=study_name,
        )
        preq.study_descriptor.config.CopyFrom(study.study_spec)
        preq.study_descriptor.guid = study_name
        preq.study_descriptor.max_trial_id = max_trial_id
        presp = self._pythia.EarlyStop(preq)
        if presp.error:
            raise RuntimeError(f"Pythia error: {presp.error}")

        # Fan decisions out into per-trial ops (batch-aware policies may
        # return decisions for other trials too) — back under the lock for
        # the datastore writes.
        should_stop = False
        with self._study_locks[study_name]:
            for decision in presp.decisions:
                d_resource = resources.EarlyStoppingOperationResource(
                    tr.owner_id, tr.study_id, int(decision.id)
                )
                d_op = vizier_service_pb2.EarlyStoppingOperation(
                    name=d_resource.name,
                    status=vizier_service_pb2.EarlyStoppingOperation.DONE,
                    should_stop=decision.should_stop,
                    creation_time_secs=now,
                    completion_time_secs=time.time(),
                )
                self.datastore.create_early_stopping_operation(d_op)
                if int(decision.id) == tr.trial_id:
                    should_stop = decision.should_stop
        return vizier_service_pb2.CheckTrialEarlyStoppingStateResponse(
            should_stop=should_stop
        )

    # -- optimal trials ----------------------------------------------------

    def ListOptimalTrials(
        self, request: vizier_service_pb2.ListOptimalTrialsRequest, context=None
    ) -> vizier_service_pb2.ListOptimalTrialsResponse:
        study = self.datastore.load_study(request.parent)
        trials = [
            t
            for t in self.datastore.list_trials(
                request.parent, states=(study_pb2.Trial.SUCCEEDED,)
            )
            if t.HasField("final_measurement")
        ]
        response = vizier_service_pb2.ListOptimalTrialsResponse()
        if not trials:
            return response

        metric_specs = list(study.study_spec.metrics)
        objective_specs = [m for m in metric_specs if not m.HasField("safety_config")]
        if not objective_specs:
            return response

        # Matrix of objective values, sign-flipped so bigger is better.
        values = np.full((len(trials), len(objective_specs)), -np.inf)
        for i, t in enumerate(trials):
            by_name = {m.name: m.value for m in t.final_measurement.metrics}
            for j, spec in enumerate(objective_specs):
                if spec.name in by_name:
                    v = by_name[spec.name]
                    values[i, j] = -v if spec.goal == study_pb2.MetricSpec.MINIMIZE else v

        if values.shape[1] == 1:
            best = np.nanargmax(values[:, 0])
            response.optimal_trials.add().CopyFrom(trials[int(best)])
            return response

        # Pareto frontier via a pairwise domination matrix.
        dominated = np.zeros(len(trials), dtype=bool)
        for i in range(len(trials)):
            if dominated[i]:
                continue
            geq = np.all(values >= values[i], axis=1)
            gt = np.any(values > values[i], axis=1)
            if np.any(geq & gt):
                dominated[i] = True
        for i, t in enumerate(trials):
            if not dominated[i]:
                response.optimal_trials.add().CopyFrom(t)
        return response

    # -- metadata ----------------------------------------------------------

    def UpdateMetadata(
        self, request: vizier_service_pb2.UpdateMetadataRequest, context=None
    ) -> vizier_service_pb2.UpdateMetadataResponse:
        study_kvs, trial_kvs = [], []
        for delta in request.deltas:
            if delta.trial_id == 0:
                study_kvs.append(delta.key_value)
            else:
                trial_kvs.append((int(delta.trial_id), delta.key_value))
        try:
            self.datastore.update_metadata(request.name, study_kvs, trial_kvs)
        except datastore_lib.NotFoundError as e:
            return vizier_service_pb2.UpdateMetadataResponse(error_details=str(e))
        return vizier_service_pb2.UpdateMetadataResponse()
