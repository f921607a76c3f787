"""``RoutedVizierStub``: client-side study-affinity routing, stub-shaped.

A copy of the JAX package's ``distributed/router_stub.py``.

Exposes exactly the ``VizierServiceStub`` method surface and routes every
RPC to the replica that owns the request's study (rendezvous placement via
:class:`~vizier_tpu_torch.distributed.routing.StudyRouter`), so it drops into
every place a stub or in-process servicer already goes — ``VizierClient``,
``clients.Study``, the Pythia supporter — with zero caller changes.

Per-method routing keys come from the request protos themselves (study
``name``/``parent`` fields, trial and operation names parsed back to their
study), so the router needs no out-of-band placement metadata. The one
owner-scoped RPC, ``ListStudies``, fans out across live replicas and
merges — and is LOUD about partiality: when a replica is down and nothing
has declared its studies failed over to successors
(:meth:`RoutedVizierStub.note_failed_over`, called by the manager after a
WAL-restore), the fan-out raises a transport-shaped error instead of
silently returning a subset.

Failure handling: transport-shaped errors (``ConnectionError``, gRPC
``UNAVAILABLE``) are reported to the failure hook — a
:class:`~vizier_tpu_torch.distributed.replica_manager.ReplicaManager` verifies
the replica is really dead, marks it down, and lifts its studies onto
their successors — and then re-raised unchanged. The caller's existing
retry machinery (``vizier_tpu_torch.reliability``) absorbs the transition: the
retried RPC routes to the successor. Without a hook, the stub marks a
replica down itself after ``failure_threshold`` consecutive transport
failures.

Observability: ``vizier_replica_requests_total{replica,method}`` /
``vizier_replica_failures_total{replica,method}`` counters plus a
``router.route`` event (replica + method) on the active span.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Mapping, Optional, Union

from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import vizier_service_pb2


def _study_of_trial(name: str) -> str:
    return resources.TrialResource.from_name(name).study_resource.name


def _study_of_operation(name: str) -> str:
    r = resources.SuggestionOperationResource.from_name(name)
    return resources.StudyResource(r.owner_id, r.study_id).name


def _create_study_key(request) -> str:
    # VizierClient always names the study before CreateStudy; an unnamed
    # create routes by owner so create_or_load of the same id stays on one
    # replica.
    return request.study.name or request.parent


# method -> study-key extractor. ListStudies is the fan-out special case.
ROUTING_KEYS: Dict[str, Callable[[Any], str]] = {
    "CreateStudy": _create_study_key,
    "GetStudy": lambda r: r.name,
    "DeleteStudy": lambda r: r.name,
    "SetStudyState": lambda r: r.name,
    "SuggestTrials": lambda r: r.parent,
    "GetOperation": lambda r: _study_of_operation(r.name),
    "CreateTrial": lambda r: r.parent,
    "GetTrial": lambda r: _study_of_trial(r.name),
    "ListTrials": lambda r: r.parent,
    "AddTrialMeasurement": lambda r: _study_of_trial(r.trial_name),
    "CompleteTrial": lambda r: _study_of_trial(r.name),
    "DeleteTrial": lambda r: _study_of_trial(r.name),
    "CheckTrialEarlyStoppingState": lambda r: _study_of_trial(r.trial_name),
    "StopTrial": lambda r: _study_of_trial(r.name),
    "ListOptimalTrials": lambda r: r.parent,
    "UpdateMetadata": lambda r: r.name,
}

# Transport-shaped failures that implicate the REPLICA rather than the
# request. Deadline/timeout errors are deliberately absent: a slow
# computation must not down a healthy replica.
def _is_transport_failure(error: BaseException) -> bool:
    if isinstance(error, ConnectionError):
        return True
    code = getattr(error, "code", None)
    if callable(code):
        try:
            import grpc

            if isinstance(error, grpc.RpcError):
                return code() == grpc.StatusCode.UNAVAILABLE
        except Exception:
            return False
    return False


EndpointLike = Union[Any, Callable[[], Any]]


class RoutedVizierStub:
    """Routes the Vizier RPC surface across replica endpoints."""

    def __init__(
        self,
        endpoints: Mapping[str, EndpointLike],
        *,
        router: Optional[routing.StudyRouter] = None,
        routing_enabled: bool = True,
        on_failure: Optional[Callable[[str, BaseException], None]] = None,
        failure_threshold: int = 2,
        registry: Optional[metrics_lib.MetricsRegistry] = None,
        retry_sink: Optional[Callable[[int], None]] = None,
        barrier: Optional[Callable[[], None]] = None,
    ):
        if not endpoints:
            raise ValueError("RoutedVizierStub needs at least one endpoint.")
        self._endpoint_spec = dict(endpoints)
        self.router = router or routing.StudyRouter(
            list(self._endpoint_spec), routing=routing_enabled
        )
        self._on_failure = on_failure
        self._failure_threshold = max(1, failure_threshold)
        self._retry_sink = retry_sink
        # Topology-transition barrier (ReplicaManager.failover_barrier):
        # called before resolving a route, it briefly parks fresh RPCs
        # while a failover/revive is mid-replay, so requests cannot land
        # on a successor the WAL replay has not populated yet (a NotFound
        # there would read as "study deleted", which no retry fixes).
        self._barrier = barrier
        self._lock = threading.Lock()  # resolved-endpoint + failure tables
        self._resolved: Dict[str, Any] = {}
        self._consecutive_failures: Dict[str, int] = {}
        # Down replicas whose studies ARE served elsewhere (WAL-restored
        # onto successors): a ListStudies fan-out over the live set is
        # still complete with these down.
        self._failed_over: set = set()
        reg = registry or metrics_lib.MetricsRegistry()
        self._requests = reg.counter(
            "vizier_replica_requests", help="RPCs routed per replica."
        )
        self._failures = reg.counter(
            "vizier_replica_failures",
            help="Transport failures observed per replica.",
        )
        self.registry = reg
        for name in ROUTING_KEYS:
            setattr(self, name, self._bind(name))
        # ListStudies is owner-scoped: fan out + merge.
        setattr(self, "ListStudies", self._list_studies)

    # -- endpoint plumbing -------------------------------------------------

    def _endpoint(self, replica_id: str):
        with self._lock:
            resolved = self._resolved.get(replica_id)
        if resolved is not None:
            return resolved
        spec = self._endpoint_spec[replica_id]
        # A zero-arg factory (lazy gRPC connect) vs an already-built
        # stub/servicer: duck-typed on the RPC surface.
        resolved = spec if hasattr(spec, "SuggestTrials") else spec()
        with self._lock:
            self._resolved[replica_id] = resolved
        return resolved

    def invalidate_endpoint(self, replica_id: str) -> None:
        """Drops the cached endpoint (a revived replica reconnects fresh)."""
        with self._lock:
            self._resolved.pop(replica_id, None)
            self._consecutive_failures.pop(replica_id, None)

    def set_endpoint(self, replica_id: str, endpoint: EndpointLike) -> None:
        """Repoints a replica id at a new endpoint (replica restart)."""
        if replica_id not in self._endpoint_spec:
            raise KeyError(f"Unknown replica id: {replica_id!r}")
        with self._lock:
            self._endpoint_spec[replica_id] = endpoint
            self._resolved.pop(replica_id, None)
            self._consecutive_failures.pop(replica_id, None)
            # A restarted replica owns its studies again.
            self._failed_over.discard(replica_id)

    def note_failed_over(self, replica_id: str) -> None:
        """Declares a down replica's studies restored onto successors, so
        a live-replica ``ListStudies`` fan-out counts as complete."""
        with self._lock:
            self._failed_over.add(replica_id)

    def _note_success(self, replica_id: str) -> None:
        with self._lock:
            self._consecutive_failures.pop(replica_id, None)

    def _note_failure(self, replica_id: str, error: BaseException) -> None:
        self._failures.inc(replica=replica_id)
        if self._on_failure is not None:
            # The manager decides (verifies the replica is really dead,
            # marks down, runs failover restore) — synchronously, so the
            # caller's retry already sees the post-failover routing.
            self._on_failure(replica_id, error)
            return
        with self._lock:
            count = self._consecutive_failures.get(replica_id, 0) + 1
            self._consecutive_failures[replica_id] = count
        if count >= self._failure_threshold:
            self.router.mark_down(replica_id)

    # -- RPC surface -------------------------------------------------------

    def _bind(self, method_name: str):
        extract = ROUTING_KEYS[method_name]

        def call(request):
            if self._barrier is not None:
                self._barrier()
            study_key = extract(request)
            replica_id = self.router.replica_for(study_key)
            self._requests.inc(replica=replica_id, method=method_name)
            tracing_lib.add_current_event(
                "router.route", replica=replica_id, method=method_name
            )
            endpoint = self._endpoint(replica_id)
            try:
                response = getattr(endpoint, method_name)(request)
            except BaseException as e:
                if _is_transport_failure(e):
                    self._note_failure(replica_id, e)
                raise
            self._note_success(replica_id)
            return response

        return call

    def _list_studies(self, request):
        if self._barrier is not None:
            # The fan-out honors the topology-transition barrier like any
            # routed RPC: listing mid-replay would observe a half-restored
            # successor (or raise on a corpse the sweep is about to
            # account for) when waiting out the transition returns a
            # complete listing.
            self._barrier()
        live = self.router.live_replicas()
        with self._lock:
            failed_over = set(self._failed_over)
        unaccounted = [
            rid
            for rid in self.router.replica_ids
            if rid not in live and rid not in failed_over
        ]
        if unaccounted:
            # A silent subset would read as "those studies don't exist";
            # fail transport-shaped instead so the caller's retry machinery
            # re-lists once failover has restored the studies (or surfaces
            # a loud error when nothing will).
            raise ConnectionError(
                "ListStudies would be partial: replica(s) "
                f"{', '.join(unaccounted)} are down and their studies have "
                "not been failed over to successors."
            )
        response = vizier_service_pb2.ListStudiesResponse()
        for replica_id in live:
            self._requests.inc(replica=replica_id, method="ListStudies")
            endpoint = self._endpoint(replica_id)
            try:
                part = endpoint.ListStudies(request)
            except BaseException as e:
                if _is_transport_failure(e):
                    self._note_failure(replica_id, e)
                raise
            response.studies.extend(part.studies)
        return response

    # -- best-effort accounting hooks (duck-typed like the servicer) -------

    def record_client_retry(self, amount: int = 1) -> None:
        """Forwards client retry accounting to the tier's stats sink."""
        if self._retry_sink is not None:
            try:
                self._retry_sink(amount)
            except Exception:
                pass

    def stats(self) -> Dict[str, Any]:
        """Router + per-replica request/failure counters (JSON-ready)."""
        per_replica: Dict[str, Dict[str, float]] = {}
        with self._lock:
            failed_over = set(self._failed_over)
        for rid in self.router.replica_ids:
            requests = sum(
                self._requests.value(replica=rid, method=m)
                for m in list(ROUTING_KEYS) + ["ListStudies"]
            )
            per_replica[rid] = {
                "requests": requests,
                "failures": self._failures.value(replica=rid),
                "state": self.router.snapshot()[rid],
                "failed_over": rid in failed_over,
            }
        return {"replicas": per_replica}
