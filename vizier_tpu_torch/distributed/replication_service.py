"""Cross-process replication: the gRPC surface over the standby machinery.

A copy of the JAX package's ``distributed/replication_service.py``.
``replication.py`` delivers shared-nothing durability — streamed standby
logs, epoch fencing, recovery-source selection — in-process: the
``ReplicationPlane``'s ``deliver_fn`` is a Python method call into a
sibling replica's ``StandbyStore``. This module puts the same protocol on
the wire so subprocess replicas (``replica_main``) replicate to each
other over real gRPC (``/vizier_tpu_torch.ReplicationService/...``):

- :class:`ReplicationServicer` — the server body ``replica_main`` hosts
  next to ``VizierService`` (method table in ``service.grpc_stubs``).
  ``DeliverAppends``/``Baseline`` are thin shims over
  ``StandbyStore.append_batch`` (the SAME epoch-fencing code path the
  in-process plane uses, so fencing semantics are proven identical on
  both transports); ``Fence`` raises an origin's epoch without data;
  ``Heartbeat`` renews the manager's lease and piggybacks the fencing/
  resync counters; ``ExportStandby``/``ExportState``/``ApplyRecords``
  are the recovery plumbing a :class:`~vizier_tpu_torch.distributed.
  subprocess_fleet.SubprocessReplicaManager` drives failover and revive
  copy-back through; ``Resync``/``FlushStream`` poke the replica's
  origin-side streamer.
- :class:`GrpcReplicationLink` — the wire ``deliver_fn``: one more
  implementation of the streamer's delivery contract. Transport faults
  are retried with a bounded, jittered ``reliability.RetryPolicy``
  (connection loss = a reconnect-and-retry, not a stream death); on
  exhaustion the delivery returns ``None`` and the streamer re-baselines
  the successor on its next sight (``vizier_replication_resyncs
  {reason="transport"}``) — the overflow re-baseline generalized to "the
  link died".
- :class:`ReplicaReplicationHost` — the origin side of ONE subprocess
  replica: a liveness-blind rendezvous router over the fleet's replica
  ids (every process computes the same successor sets independently), a
  baseline exporter over the replica's own datastore, and the
  ``ReplicationStreamer`` feeding the link. :class:`ProcessAppendSink`
  is its typed ``PersistentDataStore.on_append`` hook.

Lock order: the servicer's counter lock and the link's stub-cache lock
are leaves; the host's streamer condition is a leaf under the datastore
lock exactly as in the in-process plane (``ProcessAppendSink.submit``
only enqueues). Nothing here calls back into router or store locks while
holding either.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from vizier_tpu_torch.distributed import replication as replication_lib
from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.reliability import retry as retry_lib
from vizier_tpu_torch.service.protos import replication_service_pb2 as _pb
from vizier_tpu_torch.testing import netchaos as netchaos_lib

_logger = logging.getLogger(__name__)

Record = replication_lib.Record


def records_to_proto(records: Sequence[Record], out) -> None:
    """Appends ``(seq, opcode, payload)`` tuples to a repeated
    ``ReplicationRecord`` field."""
    for seq, opcode, payload in records:
        out.add(seq=seq, opcode=opcode, payload=payload)


def records_from_proto(field) -> List[Record]:
    return [(r.seq, r.opcode, r.payload) for r in field]


def _is_transport_failure(error: BaseException) -> bool:
    """Transport-shaped failures worth a reconnect-and-retry."""
    if isinstance(error, ConnectionError):
        return True
    try:
        import grpc
    except Exception:  # pragma: no cover - the fleet's hosts have grpc
        return False
    if isinstance(error, grpc.FutureTimeoutError):
        return True
    if isinstance(error, grpc.RpcError):
        code = error.code() if hasattr(error, "code") else None
        return code in (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
        )
    return False


class ReplicationServicer:
    """The ``vizier_tpu_torch.ReplicationService`` server body.

    Wraps one replica's receiver-side :class:`~vizier_tpu_torch.distributed.
    replication.StandbyStore`, its datastore (for the recovery plumbing),
    and — when the replica also streams — its origin-side
    :class:`ReplicaReplicationHost`. Methods take ``(request, context)``
    so they serve both through ``grpc_stubs.add_replication_servicer_to_
    server`` and in-process (context ``None``).
    """

    def __init__(
        self,
        replica_id: str,
        standby: replication_lib.StandbyStore,
        *,
        datastore=None,
        host: Optional["ReplicaReplicationHost"] = None,
    ):
        self.replica_id = replica_id
        self._standby = standby
        self._datastore = datastore
        self._host = host
        # Leaf lock: the fenced-rejection counter only (the standby store
        # and datastore serialize themselves).
        self._lock = threading.Lock()
        self._fenced_rejections = 0

    @property
    def fenced_rejections(self) -> int:
        with self._lock:
            return self._fenced_rejections

    # -- standby-log write protocol ----------------------------------------

    def _deliver(self, request, reset: bool):
        accepted, value = self._standby.append_batch(
            request.origin,
            request.epoch,
            records_from_proto(request.records),
            reset=reset,
            baseline_seq=request.baseline_seq,
        )
        if not accepted and value > request.epoch:
            # A stale generation of the origin tried to write behind a
            # fence — the split-brain write the epoch protocol exists to
            # reject. Counted (and surfaced via Heartbeat) so a
            # partition-then-heal run can assert fencing over the wire.
            with self._lock:
                self._fenced_rejections += 1
        return _pb.DeliverAppendsResponse(accepted=accepted, value=value)

    def DeliverAppends(self, request, context=None):
        del context
        return self._deliver(request, reset=request.reset)

    def Baseline(self, request, context=None):
        del context
        return self._deliver(request, reset=True)

    def Fence(self, request, context=None):
        del context
        self._standby.fence(request.origin, request.epoch)
        if self._host is not None and request.origin == self.replica_id:
            # Fencing a replica's OWN origin means a newer generation of
            # it exists somewhere: stop streaming rather than wait for the
            # first rejected delivery.
            self._host.fence()
        return _pb.FenceResponse(epoch=self._standby.epoch(request.origin))

    # -- lease renewal ------------------------------------------------------

    def Heartbeat(self, request, context=None):
        del request, context
        seq = 0
        if self._datastore is not None:
            try:
                seq = int(self._datastore.seq)
            except Exception:
                seq = 0
        return _pb.HeartbeatResponse(
            replica_id=self.replica_id,
            seq=seq,
            fenced_rejections=self.fenced_rejections,
            resyncs=self._host.resyncs if self._host is not None else 0,
        )

    # -- recovery plumbing ---------------------------------------------------

    def ExportStandby(self, request, context=None):
        del context
        view = self._standby.view_for(request.origin)
        response = _pb.ExportStandbyResponse(
            present=view is not None,
            epoch=self._standby.epoch(request.origin),
        )
        if view is not None:
            response.baseline_seq = view.baseline_seq
            records_to_proto(view.records, response.records)
        return response

    def ExportState(self, request, context=None):
        del context
        response = _pb.ExportStateResponse()
        if self._datastore is None:
            return response
        seq, records = self._datastore.export_with_seq()
        response.seq = seq
        wanted = set(request.studies)
        for opcode, payload in records:
            if wanted and wal_lib.study_key_of(opcode, payload) not in wanted:
                continue
            response.records.add(seq=seq, opcode=opcode, payload=payload)
        return response

    def ApplyRecords(self, request, context=None):
        del context
        applied = 0
        if self._datastore is not None:
            # Applying through the datastore re-logs (and re-replicates)
            # each record: a failover/copy-back handoff is durable on the
            # receiving replica's own disk the moment this RPC returns.
            for record in request.records:
                wal_lib.apply_record(
                    self._datastore, record.opcode, record.payload
                )
                applied += 1
        return _pb.ApplyRecordsResponse(applied=applied)

    # -- streamer pokes ------------------------------------------------------

    def Resync(self, request, context=None):
        del context
        if self._host is None:
            return _pb.ResyncResponse(requested=False)
        self._host.request_resync(request.successor)
        return _pb.ResyncResponse(requested=True)

    def FlushStream(self, request, context=None):
        del context
        if self._host is None:
            return _pb.FlushStreamResponse(flushed=True)
        timeout = request.timeout_secs or 10.0
        return _pb.FlushStreamResponse(flushed=self._host.flush(timeout))


# -- the wire deliver_fn ------------------------------------------------------


class GrpcReplicationLink:
    """Streamer deliveries over gRPC, with bounded reconnect-and-retry.

    One link per replica process; ``deliver`` matches the
    ``ReplicationStreamer`` delivery contract exactly, so the wire is just
    one more ``deliver_fn``. A transport fault (connection refused, server
    restarting, a netchaos drop) is retried on the policy's jittered
    backoff — gRPC's channel reconnects underneath — and on exhaustion the
    delivery reports ``None``: the streamer marks the successor unsynced
    and re-baselines it on next sight, so a dead link costs a resync,
    never a wedged stream or a silent gap.
    """

    def __init__(
        self,
        endpoints: Mapping[str, str],
        *,
        src_id: str = "client",
        retry_attempts: int = 3,
        retry_base_delay_secs: float = 0.05,
        retry_max_delay_secs: float = 0.5,
        connect_timeout_secs: float = 1.0,
        down_cooldown_secs: float = 2.0,
        seed: Optional[int] = None,
        netchaos: Optional[netchaos_lib.NetChaos] = None,
    ):
        self._endpoints = dict(endpoints)
        self._connect_timeout = connect_timeout_secs
        # Dead-peer cooldown: a peer that just failed transport-shaped is
        # skipped (fast ConnectionError, no connect wait) until the
        # cooldown passes. Without it, one dead successor stalls the
        # streamer's single-threaded delivery loop for a full
        # connect-timeout x retries on EVERY batch — starving the LIVE
        # successors of exactly the records a failover needs (observed:
        # the fence beat a stalled stream and acked writes lost the race).
        self._down_cooldown = down_cooldown_secs
        # netchaos seam: every RPC is traffic on the (src_id -> peer)
        # link of the fault schedule.
        self.src_id = src_id
        self._netchaos: Optional[netchaos_lib.NetChaos] = netchaos
        self._retry = retry_lib.RetryPolicy(
            max_attempts=max(1, retry_attempts),
            base_delay_secs=retry_base_delay_secs,
            max_delay_secs=retry_max_delay_secs,
            is_retryable=_is_transport_failure,
            rng=random.Random(seed),
        )
        self._lock = threading.Lock()  # leaf: stub cache + cooldowns only
        self._stubs: Dict[str, object] = {}
        self._down_until: Dict[str, float] = {}

    def set_endpoint(self, replica_id: str, endpoint: str) -> None:
        """Repoints a peer (its process restarted on a new port)."""
        with self._lock:
            self._endpoints[replica_id] = endpoint
            self._stubs.pop(replica_id, None)
            self._down_until.pop(replica_id, None)

    def clear_cooldown(self, replica_id: str) -> None:
        """Forgets a peer's dead-peer cooldown (a revive just restarted
        it; the next probe must try immediately, not wait out the old
        failure)."""
        with self._lock:
            self._down_until.pop(replica_id, None)

    def _check_cooldown(self, replica_id: str) -> None:
        with self._lock:
            until = self._down_until.get(replica_id, 0.0)
        if time.monotonic() < until:
            raise ConnectionError(
                f"replication link to {replica_id} in dead-peer cooldown"
            )

    def _note_outcome(self, replica_id: str, ok: bool) -> None:
        with self._lock:
            if ok:
                self._down_until.pop(replica_id, None)
            else:
                self._down_until[replica_id] = (
                    time.monotonic() + self._down_cooldown
                )

    def _stub(self, replica_id: str):
        with self._lock:
            stub = self._stubs.get(replica_id)
        if stub is not None:
            return stub
        from vizier_tpu_torch.service import grpc_stubs

        endpoint = self._endpoints[replica_id]
        stub = grpc_stubs.create_replication_stub(
            endpoint, timeout=self._connect_timeout
        )
        with self._lock:
            self._stubs[replica_id] = stub
        return stub

    def _rpc(self, replica_id: str, method: str, request):
        """One attempt, routed through the netchaos link schedule. A
        duplicate strike runs the RPC twice (at-least-once delivery; the
        epoch/seq protocol on the receiver deduplicates) and promises the
        caller the SECOND copy's outcome."""
        if self._netchaos is not None:
            duplicate = self._netchaos.strike(self.src_id, replica_id)
            if duplicate:
                try:
                    getattr(self._stub(replica_id), method)(request)
                except Exception:
                    pass
        return getattr(self._stub(replica_id), method)(request)

    def call(self, replica_id: str, method: str, request):
        """One control RPC with the link's retry/reconnect policy.

        The bounded retry loop is inlined (the policy supplies the
        jittered backoff schedule) rather than routed through
        ``RetryPolicy.call``, so the netchaos leaf lock is the only lock
        the RPC path takes under whatever the caller holds.
        """
        self._check_cooldown(replica_id)
        attempts = max(1, self._retry.max_attempts)
        for attempt in range(attempts):
            try:
                response = self._rpc(replica_id, method, request)
            except BaseException as e:
                transport = _is_transport_failure(e)
                if attempt == attempts - 1 or not transport:
                    self._note_outcome(replica_id, ok=not transport)
                    raise
                delay = self._retry.delay_for_attempt(attempt)
                if delay > 0:
                    self._retry.sleep_fn(delay)
                continue
            self._note_outcome(replica_id, ok=True)
            return response
        raise AssertionError("unreachable")  # pragma: no cover

    def call_once(self, replica_id: str, method: str, request):
        """One control RPC with NO retries (heartbeat probes: a missed
        probe must cost one interval, not a retry storm — the lease
        already tolerates ``timeout / interval`` consecutive misses)."""
        self._check_cooldown(replica_id)
        try:
            response = self._rpc(replica_id, method, request)
        except BaseException as e:
            self._note_outcome(replica_id, ok=not _is_transport_failure(e))
            raise
        self._note_outcome(replica_id, ok=True)
        return response

    def deliver(
        self,
        successor: str,
        origin: str,
        epoch: int,
        records: Sequence[Record],
        reset: bool,
        baseline_seq: int,
    ) -> Optional[Tuple[bool, int]]:
        request = _pb.DeliverAppendsRequest(
            origin=origin,
            epoch=epoch,
            reset=reset,
            baseline_seq=baseline_seq,
        )
        records_to_proto(records, request.records)
        method = "Baseline" if reset else "DeliverAppends"
        try:
            response = self.call(successor, method, request)
        except Exception as e:
            # Unreachable after bounded retries: report None so the
            # streamer re-baselines when the successor returns.
            if not _is_transport_failure(e):
                _logger.warning(
                    "Replication delivery %s -> %s failed non-transport: %s",
                    origin,
                    successor,
                    e,
                )
            return None
        return bool(response.accepted), int(response.value)


class ProcessAppendSink:
    """The typed ``PersistentDataStore.on_append`` target of a subprocess
    replica: the cross-process sibling of ``replication.AppendSink``.

    A class (not a closure) for the same reason: the store-lock →
    streamer-condition chain the hook creates is named by the ctor
    annotation.
    """

    def __init__(self, host: "ReplicaReplicationHost"):
        self._host: "ReplicaReplicationHost" = host

    def submit(self, seq: int, opcode: int, payload: bytes) -> None:
        self._host.submit(seq, opcode, payload)


class ReplicaReplicationHost:
    """The origin side of one subprocess replica's replication.

    Owns the process-local rendezvous router (liveness-blind, over the
    fleet's full id set, so every process independently computes the SAME
    per-study successor sets), the baseline exporter over the replica's
    own datastore, and the ``ReplicationStreamer`` whose deliveries ride
    ``GrpcReplicationLink``. The epoch comes from the process arguments:
    a revive restarts the process with the fenced epoch, so the fresh
    generation's first baseline announces it everywhere.
    """

    def __init__(
        self,
        replica_id: str,
        replica_ids: Sequence[str],
        *,
        datastore,
        link: GrpcReplicationLink,
        factor: int = 2,
        epoch: int = 1,
        queue_size: int = 4096,
        batch_max: int = 64,
        repair_interval_secs: float = 0.5,
        registry=None,
    ):
        self.replica_id = replica_id
        self._factor = max(1, factor)
        self._datastore = datastore
        self._link = link
        self._router = routing.StudyRouter(sorted(set(replica_ids)))
        self._resync_counter = None
        self._lag_gauge = None
        if registry is not None:
            self._resync_counter = registry.counter(
                "vizier_replication_resyncs",
                help="Standby-log re-baselines, per origin and reason.",
            )
            self._lag_gauge = registry.gauge(
                "vizier_replication_lag",
                help="Appended-but-unacked standby records per origin.",
            )
        self._streamer = replication_lib.ReplicationStreamer(
            replica_id,
            epoch,
            successors_fn=self._successors,
            deliver_fn=link.deliver,
            baseline_fn=self._baseline,
            queue_size=queue_size,
            batch_max=batch_max,
            repair_interval_secs=repair_interval_secs,
            on_lag=self._record_lag,
            on_resync=self._record_resync,
        )

    # -- streamer plumbing ---------------------------------------------------

    def _successors(self, study_key: str) -> List[str]:
        return self._router.successors(study_key, self.replica_id, self._factor)

    def _baseline(self, successor: str) -> Tuple[int, List[Record]]:
        seq, records = self._datastore.export_with_seq()
        out: List[Record] = []
        for opcode, payload in records:
            if successor and successor not in self._successors(
                wal_lib.study_key_of(opcode, payload)
            ):
                continue
            out.append((seq, opcode, payload))
        return seq, out

    def _record_lag(self, origin: str, lag: int) -> None:
        if self._lag_gauge is not None:
            self._lag_gauge.set(float(lag), origin=origin)

    def _record_resync(self, origin: str, successor: str, reason: str) -> None:
        del successor
        if self._resync_counter is not None:
            self._resync_counter.inc(origin=origin, reason=reason)

    # -- surface -------------------------------------------------------------

    def sink(self) -> ProcessAppendSink:
        return ProcessAppendSink(self)

    def submit(self, seq: int, opcode: int, payload: bytes) -> None:
        self._streamer.submit(seq, opcode, payload)

    def request_resync(self, successor: str) -> None:
        self._streamer.request_resync(successor)

    def flush(self, timeout_secs: float = 10.0) -> bool:
        return self._streamer.flush(timeout_secs)

    def fence(self) -> None:
        """Stops the streamer: a newer generation of this origin exists
        (a ``Fence`` RPC named our own id). The process keeps serving its
        other surfaces, but nothing it appends replicates any more —
        exactly the zombie posture a partitioned-away replica must take."""
        self._streamer.close()

    @property
    def fenced(self) -> bool:
        return self._streamer.fenced

    @property
    def resyncs(self) -> int:
        return self._streamer.resyncs

    @property
    def epoch(self) -> int:
        return self._streamer.epoch

    def lag(self) -> int:
        return self._streamer.lag()

    def close(self) -> None:
        self._streamer.close()
