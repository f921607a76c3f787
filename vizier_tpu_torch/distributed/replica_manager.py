"""``ReplicaManager``: an in-process sharded Vizier tier with failover.

A copy of the JAX package's ``distributed/replica_manager.py``. The shared
Pythia runs its designers on ``device``: CUDA unless the caller asks for
the CPU (it raises at construction without a GPU, as ``device.resolve``
does).

N ``VizierServicer`` replicas — each owning its shard of the study
population and (optionally) a per-replica snapshot+WAL directory — behind
one :class:`~vizier_tpu_torch.distributed.router_stub.RoutedVizierStub`. All
replicas feed ONE shared ``PythiaServicer``: the designer cache, request
coalescer, and cross-study batch executor are fleet-wide, so suggestion
compute batches across replicas exactly as it batches across studies on a
single server. The shared Pythia reads trials back through the router too,
so its view follows failover automatically.

Failure model:

- A dead replica (``kill_replica`` in chaos runs, a crashed process in
  real life) surfaces as transport errors on its RPCs. The routed stub
  reports them to :meth:`_on_endpoint_failure`; the manager verifies the
  replica is really dead (a chaos-injected fault on a live replica is NOT
  a failover trigger — the client retry handles it), marks it down, and
  **lifts the dead replica's studies onto their rendezvous successors**.
  With WAL replication armed (``VIZIER_TORCH_DISTRIBUTED_REPLICATION``, the
  default on a WAL-backed tier) the records come from the successors'
  own **standby logs** (``distributed/replication.py``) — no shared
  filesystem needed; the dead replica's local WAL is consulted only as a
  fallback and wins only when strictly longer (longest-valid-prefix by
  sequence number, per study). Without replication the dead replica's
  local WAL is replayed. Applying through the successors' datastores
  re-logs (and re-replicates) every record — the handoff itself is
  durable. The failing RPC then re-raises; the caller's reliability
  retries land on the successor.
- **Concurrent multi-replica failure**: one ``fail_over`` call sweeps
  EVERY currently-dead replica — all of them are marked down in the
  router first (so no successor choice can land on another corpse), then
  each is restored in deterministic id order with routing re-resolved
  between steps, all under one topology transition (fresh RPCs park on
  the barrier for the whole sweep).
- ``revive_replica`` rebuilds a replica from its own WAL (restart warm,
  corruption-quarantined); if its studies were failed over meanwhile,
  they are copied back from the successors before the replica is marked
  up. With replication the handback is safe under live traffic: the
  cutover is **epoch-fenced** (every standby store rejects appends from
  the dead generation's streamer before the copy-back starts), fresh
  RPCs drain through the existing failover barrier, and in-flight RPCs
  on the live successors are drained before their state is exported.

Lock order: ``ReplicaManager._lock`` guards the replica/failover tables
only; WAL replay and datastore writes run OUTSIDE it (the failover path
serializes on ``_failover_lock`` instead, which never nests inside
``_lock``). The replication plane's streamer/standby locks are leaves
below both (see ``replication.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from vizier_tpu_torch.distributed import config as config_lib
from vizier_tpu_torch.distributed import replication as replication_lib
from vizier_tpu_torch.distributed import router_stub
from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.observability import fleet as fleet_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.service import ram_datastore

_logger = logging.getLogger(__name__)


class ReplicaDownError(ConnectionError):
    """RPC reached a dead replica (transport-shaped, classified transient)."""


class _TransitionGate:
    """The tier's topology-transition latch, shared by the manager (which
    raises/lowers it around failover replay and revive copy-back), the
    routed stub's ``failover_barrier``, and every replica's ``enter()``.

    Admission checks the gate UNDER its condition and registers the RPC
    in-flight before releasing it, so there is no window where a request
    has passed the barrier but is not yet visible to a drain — the race
    that let a write land on a study copy mid-handback.
    """

    def __init__(self):
        self.cond = threading.Condition()
        self.count = 0  # transitions in progress


class _ReplicaEndpoint:
    """The callable surface of one replica; raises when the replica is dead."""

    def __init__(self, replica: "Replica"):
        self._replica = replica

    def __getattr__(self, name: str):
        attr = getattr(self._replica.servicer, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def call(*args, **kwargs):
            self._replica.enter()
            try:
                return attr(*args, **kwargs)
            finally:
                self._replica.leave()

        return call


class Replica:
    """One shard: servicer + datastore (+ WAL directory when persistent)."""

    def __init__(
        self,
        replica_id: str,
        servicer,
        datastore,
        wal_dir: Optional[str],
        standby: Optional[replication_lib.StandbyStore] = None,
    ):
        self.replica_id = replica_id
        self.servicer = servicer
        self.datastore = datastore
        self.wal_dir = wal_dir
        # Receiver side of WAL replication: the standby logs this replica
        # holds for the origins it is a rendezvous successor of.
        self.standby: Optional[replication_lib.StandbyStore] = standby
        self.alive = True
        self.endpoint = _ReplicaEndpoint(self)
        # Manager-shared per-thread RPC depth (set by the manager): lets
        # the failover barrier exempt threads already inside an endpoint
        # call (their nested routed reads must not wait on a drain that is
        # waiting on them).
        self.thread_depth = threading.local()
        # In-flight RPC accounting, per thread: failover drains these
        # before reading the WAL (a dead replica's in-flight RPCs keep
        # appending until they return — replaying before they finish
        # silently drops writes the client already observed).
        self._inflight_cond = threading.Condition()
        self._inflight: Dict[int, int] = {}
        # The tier's transition gate (set by the manager): admission
        # parks while a failover replay / revive copy-back is mid-flight
        # and registers in-flight atomically with the gate check.
        self.gate: Optional[_TransitionGate] = None
        # Set by fail_over: called (outside the condition) whenever an
        # in-flight RPC leaves a dead replica, so writes it appended after
        # the failover replay (it was admitted alive and kept executing —
        # including the self-triggered-failover edge where a dispatch
        # inside the RPC tripped the failover itself) are caught up onto
        # the successors before the RPC's response reaches the client.
        self.on_drained = None

    def enter(self, timeout_secs: float = 30.0) -> None:
        """Admits one RPC (liveness check + in-flight count, atomically).

        Fresh RPCs (thread depth 0) first wait out any topology
        transition UNDER the gate's condition and register in-flight
        before releasing it — a request can never slip between "passed
        the barrier" and "visible to a drain". Threads already inside an
        endpoint call pass straight through (the drain is waiting on
        exactly those threads; parking their nested reads would deadlock
        it). Bounded: after ``timeout_secs`` the request proceeds and at
        worst degrades through the reliability layer.
        """
        tid = threading.get_ident()
        gate = self.gate
        if gate is not None and getattr(self.thread_depth, "n", 0) == 0:
            deadline = time.monotonic() + timeout_secs
            with gate.cond:
                while gate.count > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    gate.cond.wait(remaining)
                self._admit(tid)
        else:
            self._admit(tid)
        self.thread_depth.n = getattr(self.thread_depth, "n", 0) + 1

    def _admit(self, tid: int) -> None:
        with self._inflight_cond:
            if not self.alive:
                raise ReplicaDownError(f"replica {self.replica_id} is down")
            self._inflight[tid] = self._inflight.get(tid, 0) + 1

    def leave(self) -> None:
        tid = threading.get_ident()
        self.thread_depth.n = getattr(self.thread_depth, "n", 1) - 1
        with self._inflight_cond:
            count = self._inflight.get(tid, 0) - 1
            if count <= 0:
                self._inflight.pop(tid, None)
            else:
                self._inflight[tid] = count
            self._inflight_cond.notify_all()
            callback = self.on_drained if not self.alive else None
        if callback is not None:
            callback()

    def wait_quiesced(self, timeout_secs: float) -> bool:
        """Blocks until no OTHER thread has an RPC in flight (the calling
        thread's own nested RPC must not deadlock its own failover — a
        self-triggered failover from inside a dispatch is the rare edge
        the timeout also backstops). Returns False on timeout."""
        deadline = time.monotonic() + timeout_secs
        me = threading.get_ident()
        with self._inflight_cond:
            while any(tid != me for tid in self._inflight):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True


class ReplicaManager:
    """Builds, health-checks, and fails over an in-process replica fleet."""

    def __init__(
        self,
        num_replicas: Optional[int] = None,
        *,
        config: Optional[config_lib.DistributedConfig] = None,
        wal_root: Optional[str] = None,
        policy_factory=None,
        serving_config=None,
        reliability_config=None,
        device="cuda",
    ):
        import dataclasses

        from vizier_tpu_torch.reliability import config as reliability_config_lib
        from vizier_tpu_torch.service import pythia_service, vizier_service

        self.config = config or config_lib.DistributedConfig.from_env()
        self._num_replicas = max(1, num_replicas or self.config.num_replicas)
        self._wal_root = wal_root if wal_root is not None else self.config.wal_root
        replica_ids = [f"replica-{i}" for i in range(self._num_replicas)]
        self.router = routing.StudyRouter(
            replica_ids, routing=self.config.routing
        )

        # In-process replicas run the synchronous Pythia dispatch: the
        # manager (not a per-request watchdog thread) owns wedged-replica
        # semantics here, and the thread-per-suggest the deadline path
        # spawns is measurable overhead at tier throughput. Everything
        # else (retries, breaker, fallback) keeps its configured state.
        base_reliability = (
            reliability_config or reliability_config_lib.ReliabilityConfig.from_env()
        )
        replica_reliability = dataclasses.replace(
            base_reliability, deadlines=self.config.replica_deadlines
        )

        # One Pythia for the whole fleet; its trial reads route like any
        # other client so failover moves its view too. Constructed first
        # (the replicas need it), connected to the router stub below.
        self._pythia = pythia_service.PythiaServicer(
            None,
            policy_factory,
            serving_config=serving_config,
            reliability_config=base_reliability,
            device=device,
        )
        registry = self._pythia.serving_runtime.stats.registry
        self._failovers = registry.counter(
            "vizier_replica_failovers", help="Replica failovers performed."
        )
        self._restored = registry.counter(
            "vizier_replica_restored_studies",
            help="Studies lifted onto successors during failover.",
        )
        self._recovery_source = registry.counter(
            "vizier_replica_recovery_source",
            help="Failover recovery sources chosen, per study "
            "(standby log vs local WAL).",
        )

        self._lock = threading.Lock()  # replica + failover bookkeeping only
        # One per-thread RPC-depth record shared by every replica: the
        # failover barrier exempts threads already inside an endpoint call.
        self._thread_depth = threading.local()
        # Topology transitions in progress (failover replay / revive
        # copy-back): fresh RPCs park on the gate until zero — checked
        # both at the routed stub (failover_barrier) and atomically at
        # replica admission (Replica.enter).
        self._gate = _TransitionGate()
        # Shared-nothing WAL replication: active on multi-replica
        # WAL-backed tiers unless switched off. The plane owns the
        # per-origin streamers; standby stores hang off each Replica.
        self._replication: Optional[replication_lib.ReplicationPlane] = None
        if (
            self._wal_root
            and self.config.replication
            and self._num_replicas > 1
        ):
            self._replication = replication_lib.ReplicationPlane(
                factor=self.config.replication_factor,
                queue_size=self.config.replication_queue,
                batch_max=self.config.replication_batch,
                router=self.router,
                get_replica=self._replica_or_none,
                registry=registry,
            )

        self._replicas: Dict[str, Replica] = {}
        for rid in replica_ids:
            self._replicas[rid] = self._build_replica(
                rid, vizier_service, replica_reliability
            )
        if self._replication is not None:
            # Streamers start AFTER every replica exists: their initial
            # baseline sync reads peers through self._replicas.
            for rid in replica_ids:
                self._replication.start_streamer(rid)

        self._stub = router_stub.RoutedVizierStub(
            {rid: r.endpoint for rid, r in self._replicas.items()},
            router=self.router,
            on_failure=self._on_endpoint_failure,
            registry=registry,
            retry_sink=self._record_retries,
            barrier=self.failover_barrier,
        )
        self._pythia.connect_to_vizier(self._stub)

        # Failover serialization (never nests inside self._lock).
        self._failover_lock = threading.Lock()
        self._failed_over: set = set()
        # replica_id -> WAL records already replayed onto successors
        # (late-write catch-up baseline; see _catch_up_late_writes).
        self._replayed_records: Dict[str, int] = {}
        # replica_id -> highest mutation seq replayed onto successors
        # (the replication path's catch-up watermark).
        self._replayed_seq: Dict[str, int] = {}
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    # -- construction helpers ---------------------------------------------

    def _build_replica(self, replica_id, vizier_service_mod, reliability):
        wal_dir = None
        standby = None
        if self._wal_root:
            wal_dir = os.path.join(self._wal_root, replica_id)
            on_append = None
            if self._replication is not None:
                # The typed sink resolves the origin's CURRENT streamer
                # per call, so revives swap streamers without rebuilding
                # the datastore hook.
                on_append = replication_lib.AppendSink(
                    replica_id, self._replication
                )
                # Receiver side: reload whatever standby logs this
                # replica already holds for its peers (restart warm).
                standby = replication_lib.StandbyStore(wal_dir)
            datastore = wal_lib.PersistentDataStore(
                wal_dir,
                snapshot_interval=self.config.snapshot_interval,
                fsync=self.config.wal_fsync,
                on_append=on_append,
            )
        else:
            datastore = ram_datastore.NestedDictRAMDataStore()
        servicer = vizier_service_mod.VizierServicer(
            datastore=datastore, reliability_config=reliability
        )
        # Tag the replica's request spans so a fleet dump can split one
        # process's span ring back into per-replica files.
        servicer.replica_id = replica_id
        servicer.set_pythia(self._pythia)
        replica = Replica(
            replica_id, servicer, datastore, wal_dir, standby=standby
        )
        replica.thread_depth = self._thread_depth
        replica.gate = self._gate
        return replica

    def _replica_or_none(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(replica_id)

    def _record_retries(self, amount: int) -> None:
        self._pythia.serving_runtime.stats.increment("retries", amount)

    # -- public surface ----------------------------------------------------

    @property
    def stub(self) -> router_stub.RoutedVizierStub:
        """The drop-in service stub clients (and the shared Pythia) use."""
        return self._stub

    @property
    def pythia(self):
        return self._pythia

    def replica(self, replica_id: str) -> Replica:
        with self._lock:
            return self._replicas[replica_id]

    def replica_ids(self) -> List[str]:
        return list(self.router.replica_ids)

    def serving_stats(self) -> dict:
        """Fleet stats: shared-Pythia counters + router + per-replica."""
        stats = dict(self._pythia.serving_stats())
        stats["router"] = self.router.snapshot()
        stats["replicas"] = self._stub.stats()["replicas"]
        stats["failovers"] = int(
            sum(
                self._failovers.value(**dict(key))
                for key in self._failovers.label_keys()
            )
        )
        stats["restored_studies"] = int(self._restored.value())
        stats["recovery_sources"] = {
            dict(key).get("source", ""): int(
                self._recovery_source.value(**dict(key))
            )
            for key in self._recovery_source.label_keys()
        }
        if self._replication is not None:
            stats["replication"] = self.replication_stats()
        return stats

    @property
    def replication_active(self) -> bool:
        """True when WAL appends stream to standby logs (shared-nothing
        failover + epoch-fenced revive are in force)."""
        return self._replication is not None

    def flush_replication(self, replica_id: str, timeout_secs: float = 10.0) -> bool:
        """Drains a replica's replication streamer (chaos harnesses call
        this before destroying its disk, modelling the acked-replication
        durability point). No-op without replication."""
        if self._replication is None:
            return True
        return self._replication.flush_origin(replica_id, timeout_secs)

    def _standby_views_for(
        self, origin: str
    ) -> Tuple[List[str], List[replication_lib.StandbyView]]:
        """Every LIVE replica's standby view for ``origin`` (+ holders)."""
        holders: List[str] = []
        views: List[replication_lib.StandbyView] = []
        for rid in self.router.replica_ids:
            if rid == origin:
                continue
            replica = self._replica_or_none(rid)
            if replica is None or replica.standby is None or not replica.alive:
                continue
            view = replica.standby.view_for(origin)
            if view is not None:
                holders.append(rid)
                views.append(view)
        return holders, views

    def recovery_plan(
        self, origin: str, wal_dir: Optional[str], *, min_seq: int = 0
    ) -> replication_lib.RecoveryPlan:
        """The per-study recovery-source selection for a dead origin:
        live standby logs vs its local WAL, longest-valid-prefix by
        sequence number (``replication.plan_recovery``)."""
        local_records: List[Tuple[int, int, bytes]] = []
        local_torn = False
        if wal_dir:
            local_records, local_torn = wal_lib.read_directory_with_seqs(
                wal_dir
            )
        holders, views = self._standby_views_for(origin)
        plane = self._replication
        return replication_lib.plan_recovery(
            origin,
            local_records,
            local_torn,
            views,
            min_seq=min_seq,
            successors_fn=lambda study: plane.successors_for(study, origin),
            holders=holders,
        )

    def _fence_standby(self, origin: str, epoch: int) -> None:
        """Revive cutover: every live replica's standby store rejects
        deliveries from streamer epochs below ``epoch`` from now on."""
        for rid in self.router.replica_ids:
            replica = self._replica_or_none(rid)
            if replica is not None and replica.standby is not None and replica.alive:
                replica.standby.fence(origin, epoch)

    def replication_stats(self) -> dict:
        """Replication-plane observability: factor, per-holder standby
        depths, per-origin streamer lag/resync/drop counters."""
        plane = self._replication
        if plane is None:
            return {}
        return {
            "factor": plane.factor,
            "standby_depths": plane.record_depths(),
            "origins": plane.streamer_stats(),
        }

    def prometheus_text(self) -> str:
        return self._pythia.prometheus_text()

    def dump_observability(self, out_dir: str) -> Dict[str, List[str]]:
        """Writes the fleet's observability dumps into ``out_dir``.

        The in-process tier shares one span ring; this splits it back into
        per-replica ``<replica>-spans.jsonl`` files (request spans carry a
        ``replica`` attribute) plus a ``client-spans.jsonl`` for
        unattributed spans, and writes the shared registry snapshot and
        the flight-recorder event list — the exact file layout subprocess
        replicas produce via ``replica_main --obs-dump-dir``, so
        ``observability.fleet`` merges either deployment the same way.
        """
        tracer = tracing_lib.get_tracer()
        by_source: Dict[str, List[dict]] = {}
        for span in tracer.finished_spans():
            data = span.to_dict()
            source = (data.get("attributes") or {}).get("replica") or "client"
            by_source.setdefault(source, []).append(data)
        written: Dict[str, List[str]] = {"spans": [], "other": []}
        for source, spans in sorted(by_source.items()):
            written["spans"].append(
                fleet_lib.write_spans(out_dir, source, spans)
            )
        paths = fleet_lib.dump_process(
            out_dir,
            "fleet",
            registry=self._pythia.serving_runtime.metrics,
            recorder=recorder_lib.get_recorder(),
        )
        written["other"] = sorted(paths.values())
        return written

    def shutdown(self) -> None:
        self.stop_health_loop()
        if self._replication is not None:
            self._replication.close()
        self._pythia.shutdown()
        with self._lock:
            replicas = list(self._replicas.values())
        for replica in replicas:
            close = getattr(replica.datastore, "close", None)
            if close is not None:
                close()
            if replica.standby is not None:
                replica.standby.close()

    # -- topology-transition barrier ---------------------------------------

    def failover_barrier(self, timeout_secs: float = 30.0) -> None:
        """Routed-stub hook: parks fresh RPCs while a failover replay or
        revive copy-back is mid-flight, so no request can land on a
        successor the replay has not populated yet (NotFound there reads
        as "study deleted" — no retry fixes it). Threads already inside an
        endpoint call pass straight through: the failover drain is waiting
        on exactly those threads, and parking their nested reads would
        deadlock the drain. Bounded: after ``timeout_secs`` the request
        proceeds and at worst degrades through the reliability layer."""
        if getattr(self._thread_depth, "n", 0) > 0:
            return
        deadline = time.monotonic() + timeout_secs
        with self._gate.cond:
            while self._gate.count > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._gate.cond.wait(remaining)

    def _begin_transition(self) -> None:
        with self._gate.cond:
            self._gate.count += 1

    def _end_transition(self) -> None:
        with self._gate.cond:
            self._gate.count -= 1
            self._gate.cond.notify_all()

    # -- chaos / lifecycle -------------------------------------------------

    def kill_replica(self, replica_id: str) -> None:
        """Simulates a replica crash: every subsequent RPC to it fails.

        Detection and failover happen through the normal channels (a
        failed RPC's failure hook, or the health loop) — exactly as they
        would for a crashed process.
        """
        self.replica(replica_id).alive = False
        recorder_lib.get_recorder().record(
            None, "replica_killed", replica=replica_id
        )

    def fail_over(self, replica_id: str) -> int:
        """Marks dead replicas down and lifts their studies onto successors.

        One call sweeps EVERY currently-dead, not-yet-failed-over replica
        (concurrent multi-replica failure): all corpses are marked down in
        the router FIRST — a successor choice must never land on another
        dead replica — then each is restored in deterministic id order,
        with routing re-resolved between steps, under one topology
        transition. Returns the number of studies restored across the
        sweep. Idempotent; a no-op for replicas that already failed over.
        """
        # Fast path WITHOUT the failover lock: an RPC thread whose nested
        # router read trips over the dead replica mid-failover must return
        # immediately, not queue behind the in-progress failover that is
        # draining it (the drain below waits for exactly such threads).
        with self._lock:
            if replica_id in self._failed_over:
                return 0
        completed: List[dict] = []
        total_restored = 0
        with self._failover_lock:
            with self._lock:
                if replica_id in self._failed_over:
                    return 0
                if self._replicas[replica_id].alive:
                    # Either caller misuse (no kill first) or, under load,
                    # a concurrent revive won the failover lock between
                    # this caller observing the replica dead and getting
                    # here — the replica is serving again, nothing to do.
                    return 0
                dead = sorted(
                    rid
                    for rid, r in self._replicas.items()
                    if not r.alive and rid not in self._failed_over
                )
                self._failed_over.update(dead)
            for rid in dead:
                self.router.mark_down(rid)
            self._begin_transition()  # fresh RPCs park until replay lands
            try:
                for rid in dead:
                    with self._lock:
                        replica = self._replicas[rid]
                    # Late-write catch-up hook first (any leave() from
                    # here on serializes behind this failover via
                    # _failover_lock), then drain in-flight RPCs before
                    # reading the logs: an RPC admitted while the replica
                    # was alive may still be appending; replaying a
                    # prefix would hand successors a store missing writes
                    # the client already saw (NotFound on the very next
                    # CompleteTrial).
                    replica.on_drained = (
                        lambda r=replica: self._catch_up_late_writes(r)
                    )
                    if not replica.wait_quiesced(30.0):
                        _logger.warning(
                            "Failing over %s with RPCs still in flight "
                            "after 30s; their writes catch up when they "
                            "drain.",
                            replica.replica_id,
                        )
                    restored, successors, sources, rearm = (
                        self._restore_replica(replica)
                    )
                    if replica.wal_dir:
                        # Its studies now live on successors: a
                        # live-replica ListStudies fan-out is complete
                        # again. RAM-only replicas stay unaccounted —
                        # their studies are gone, and listings keep
                        # failing loudly rather than silently shrinking.
                        self._stub.note_failed_over(rid)
                    total_restored += restored
                    completed.append(
                        {
                            "replica": rid,
                            "restored": restored,
                            "successors": sorted(successors),
                            "sources": sources,
                            "rearm": rearm,
                        }
                    )
            finally:
                self._end_transition()
        # Counter updates (and the recorder append) outside the failover
        # lock: metric locks must not nest under tier mutexes (the serving
        # stack's lock-order convention).
        for entry in completed:
            self._failovers.inc(replica=entry["replica"])
            self._restored.inc(entry["restored"])
            for source, count in entry["sources"].items():
                self._recovery_source.inc(count, source=source)
            # Structured failover event: with just the vizier_replica_*
            # counters, the fleet's topology history was gone the moment
            # the numbers were read — the recorder keeps who died, when,
            # which successors took its studies, how many moved, and
            # which recovery source (standby log vs local WAL) won.
            recorder_lib.get_recorder().record(
                None,
                "replica_failover",
                replica=entry["replica"],
                successors=entry["successors"],
                restored_studies=entry["restored"],
                recovery_sources=entry["sources"],
            )
        self._rearm_speculation(
            [study for entry in completed for study in entry["rearm"]]
        )
        return total_restored

    def _restore_replica(self, replica: Replica):
        """Dispatches to the standby-log or local-WAL restore path.

        Returns ``(restored, successor_ids, source_counts,
        rearm_studies)`` where ``rearm_studies`` are restored studies
        with >= 1 completed trial (speculative re-arm candidates).
        """
        if self._replication is not None:
            return self._restore_from_standby(replica)
        studies, successors, replayed = self._restore_from_wal(replica)
        with self._lock:
            self._replayed_records[replica.replica_id] = replayed
        sources = {"local": len(studies)} if studies else {}
        rearm = [
            study
            for study in sorted(studies)
            if self._has_completed_trials(
                self.replica(self.router.replica_for(study)), study
            )
        ]
        return len(studies), successors, sources, rearm

    def _restore_from_standby(self, replica: Replica):
        """Replays a dead replica's studies from the best available
        source per study: its successors' standby logs, or its local WAL
        when that is present and strictly longer (shared-nothing
        failover — the local disk is an optimization, not a dependency).
        """
        plane = self._replication
        # Drain the origin's streamer first: in-process, everything its
        # in-flight RPCs appended before the quiesce is still in the
        # bounded queue — what a real fleet would have acked already.
        plane.flush_origin(replica.replica_id)
        plan = self.recovery_plan(replica.replica_id, replica.wal_dir)
        if plan.local_torn:
            _logger.warning(
                "Local WAL of %s carried a torn/corrupt suffix; recovery "
                "compares its valid prefix against the standby logs.",
                replica.replica_id,
            )
        successors: set = set()
        rearm: List[str] = []
        for item in plan.studies:
            successor = self.replica(self.router.replica_for(item.study))
            # Applying through the successor's datastore re-logs (and
            # re-replicates) each record: the handoff is durable and the
            # standby copies follow the new owner.
            for opcode, payload in item.records:
                wal_lib.apply_record(successor.datastore, opcode, payload)
            successors.add(successor.replica_id)
            if self._has_completed_trials(successor, item.study):
                rearm.append(item.study)
        with self._lock:
            self._replayed_seq[replica.replica_id] = plan.max_seq
        return len(plan.studies), successors, plan.source_counts(), rearm

    def _restore_from_wal(self, replica: Replica) -> Tuple[set, set, int]:
        """Replays a dead replica's WAL into its successors' datastores
        (the pre-replication shared-filesystem path).

        Returns ``(studies, successor_ids, records_replayed)``.
        """
        if not replica.wal_dir:
            # RAM-only replica: its studies are lost until recreated.
            return set(), set(), 0
        records, torn = wal_lib.read_directory(replica.wal_dir)
        if torn:
            _logger.warning(
                "Dropped a torn WAL tail while failing over %s.",
                replica.replica_id,
            )
        # Studies whose history net-resolves to deletion contribute
        # nothing: replaying a revive-handback tombstone onto the study's
        # live copy elsewhere would destroy it (see plan_recovery).
        final_delete: Dict[str, bool] = {}
        for opcode, payload in records:
            study_key = wal_lib.study_key_of(opcode, payload)
            final_delete[study_key] = opcode == wal_lib.DELETE_STUDY
        studies: set = set()
        successors: set = set()
        for opcode, payload in records:
            study_key = wal_lib.study_key_of(opcode, payload)
            if final_delete[study_key]:
                continue
            successor_id = self.router.replica_for(study_key)
            successor = self.replica(successor_id)
            # Applying through the successor's datastore re-logs each
            # record into the successor's own WAL: the handoff is durable.
            wal_lib.apply_record(successor.datastore, opcode, payload)
            studies.add(study_key)
            successors.add(successor_id)
        return studies, successors, len(records)

    @staticmethod
    def _has_completed_trials(successor: Replica, study: str) -> bool:
        """True when the restored study has >= 1 completed trial on its
        new owner (it exists and is worth a speculative pre-compute)."""
        from vizier_tpu_torch.service.protos import study_pb2

        try:
            states = successor.datastore.trial_states(study)
        except Exception:
            return False  # deleted study (tombstone replayed) or racing
        return any(
            state == study_pb2.Trial.SUCCEEDED for _tid, state in states
        )

    def _rearm_speculation(self, studies: List[str]) -> None:
        """Re-arms the speculative trigger on the successors: one
        pre-compute per restored study with completed trials, so a
        replica loss does not zero the speculative hit rate until organic
        completions rebuild it. Runs OUTSIDE the failover lock (the
        engine enqueue takes serving-side locks)."""
        engine = getattr(
            self._pythia.serving_runtime, "speculative_engine", None
        )
        if engine is None or not engine.bound or not studies:
            return
        stats = self._pythia.serving_runtime.stats
        for study in studies:
            try:
                self._pythia.notify_trial_event(study)
                stats.increment("speculative_rearms")
            except Exception as e:  # re-arm is best-effort
                _logger.debug("Speculative re-arm of %s failed: %s", study, e)

    def _catch_up_late_writes(self, replica: Replica) -> None:
        """Replays WAL records a dead replica appended AFTER its failover.

        The self-triggered-failover edge: an RPC in flight on the dying
        replica can itself trip the failover (a nested routed read hits
        the corpse) and then keep executing — its writes land in the dead
        WAL after the replay read. ``Replica.leave`` calls this when the
        last such RPC drains, so the tail reaches the successors before
        the RPC's response reaches the client. Idempotent and serialized
        with failover/revive via ``_failover_lock``.
        """
        with self._failover_lock:
            if self._replication is not None:
                caught_up = self._catch_up_from_standby(replica)
            else:
                caught_up = self._catch_up_from_wal(replica)
        if caught_up:
            recorder_lib.get_recorder().record(
                None,
                "replica_failover_catchup",
                replica=replica.replica_id,
                records=caught_up,
            )

    def _catch_up_from_wal(self, replica: Replica) -> int:
        """Local-WAL late-write tail (record-count watermark)."""
        with self._lock:
            start = self._replayed_records.get(replica.replica_id)
        if start is None or not replica.wal_dir:
            return 0  # failover incomplete or RAM-only: nothing to do
        records, _torn = wal_lib.read_directory(replica.wal_dir)
        tail = records[start:]
        if not tail:
            return 0
        for opcode, payload in tail:
            study_key = wal_lib.study_key_of(opcode, payload)
            successor = self.replica(self.router.replica_for(study_key))
            wal_lib.apply_record(successor.datastore, opcode, payload)
        with self._lock:
            self._replayed_records[replica.replica_id] = len(records)
        return len(tail)

    def _catch_up_from_standby(self, replica: Replica) -> int:
        """Standby-log late-write tail (sequence-number watermark): a
        late write streamed through the dead replica's still-current
        streamer epoch, so the standby logs already hold it — replay
        just the records past the failover's watermark onto the current
        owners."""
        with self._lock:
            watermark = self._replayed_seq.get(replica.replica_id)
        if watermark is None:
            return 0  # failover incomplete: the replay will include it
        plane = self._replication
        plane.flush_origin(replica.replica_id)
        plan = self.recovery_plan(
            replica.replica_id, replica.wal_dir, min_seq=watermark
        )
        caught_up = 0
        for item in plan.studies:
            successor = self.replica(self.router.replica_for(item.study))
            for opcode, payload in item.records:
                wal_lib.apply_record(successor.datastore, opcode, payload)
            caught_up += len(item.records)
        if caught_up:
            with self._lock:
                self._replayed_seq[replica.replica_id] = max(
                    watermark, plan.max_seq
                )
        return caught_up

    def revive_replica(self, replica_id: str) -> None:
        """Restarts a replica warm from its WAL and routes its studies back.

        Studies that failed over while it was down are copied back from
        their interim successors (and deleted there so the owner is unique
        again); studies DELETED while it was down exist on no successor
        and are deleted from the rebuilt store too, not resurrected from
        its stale WAL.

        With replication armed the handback is an **epoch-fenced cutover**
        that is safe under live traffic: (1) every live standby store is
        fenced to the new origin epoch, so a stale streamer — an RPC that
        outlived the dead generation — can no longer scribble over the
        handed-back state; (2) fresh RPCs drain through the existing
        failover barrier for the duration; (3) in-flight RPCs on the live
        successors are drained before their state is exported, so the
        copy-back sees a quiescent snapshot. Without replication the
        pre-existing contract stands: the caller quiesces traffic for the
        handback window.
        """
        from vizier_tpu_torch.reliability import config as reliability_config_lib
        from vizier_tpu_torch.service import vizier_service
        import dataclasses

        # Serialize with fail_over (and the late-write catch-up): a revive
        # racing an in-flight failover would copy back from successors the
        # WAL replay is still populating — partial state marked up, the
        # rest of the replay stranded on the successors.
        with self._failover_lock:
            with self._lock:
                old = self._replicas[replica_id]
                was_failed_over = replica_id in self._failed_over
            if old.alive:
                return
            self._begin_transition()  # fresh RPCs park during copy-back
            try:
                if self._replication is not None:
                    # Fence first: from here on, deliveries from the dead
                    # generation's streamer are rejected everywhere, even
                    # before the fresh streamer announces the new epoch.
                    new_epoch = self._replication.epoch_of(replica_id) + 1
                    self._fence_standby(replica_id, new_epoch)
                    self._replication.close_origin(replica_id)
                    # Live-traffic drain: fresh RPCs are parked on the
                    # barrier; wait out the in-flight ones on the live
                    # successors so the copy-back exports quiescent state.
                    with self._lock:
                        live = [
                            r
                            for rid, r in self._replicas.items()
                            if rid != replica_id and r.alive
                        ]
                    for other in live:
                        if not other.wait_quiesced(10.0):
                            _logger.warning(
                                "Reviving %s with RPCs still in flight on "
                                "%s after 10s.",
                                replica_id,
                                other.replica_id,
                            )
                close = getattr(old.datastore, "close", None)
                if close is not None:
                    close()
                standby_close = getattr(old.standby, "close", None)
                if standby_close is not None:
                    standby_close()
                reliability = dataclasses.replace(
                    reliability_config_lib.ReliabilityConfig.from_env(),
                    deadlines=self.config.replica_deadlines,
                )
                fresh = self._build_replica(
                    replica_id, vizier_service, reliability
                )
                if was_failed_over:
                    self._copy_back_from_successors(fresh)
                with self._lock:
                    self._replicas[replica_id] = fresh
                    self._failed_over.discard(replica_id)
                    self._replayed_records.pop(replica_id, None)
                    self._replayed_seq.pop(replica_id, None)
                # _ReplicaEndpoint objects are bound per Replica; repoint
                # the stub.
                self._stub.set_endpoint(replica_id, fresh.endpoint)
                self.router.mark_up(replica_id)
                if self._replication is not None:
                    # The fresh streamer (epoch == the fence) baselines
                    # its successors from the handed-back state — and the
                    # other origins proactively re-baseline the revived
                    # replica's standby logs, which went stale (or were
                    # lost with its disk) while it was down.
                    self._replication.start_streamer(replica_id)
                    self._replication.resync_into(replica_id)
            finally:
                self._end_transition()
        recorder_lib.get_recorder().record(
            None,
            "replica_revive",
            replica=replica_id,
            was_failed_over=was_failed_over,
            epoch_fenced=self._replication is not None,
        )

    def _copy_back_from_successors(self, fresh: Replica) -> None:
        """Moves studies the revived replica will own back from successors.

        Successor CURRENT state, not WAL history, is what comes back — so
        after the copy, any study the revived replica rebuilt from its own
        (stale) WAL that exists on NO live successor was deleted while the
        replica was down, and is deleted from the fresh store too rather
        than resurrected.

        Routing is LIVENESS-AWARE as of the post-revive world (live
        replicas plus the one coming up): with several replicas down at
        once, a study whose liveness-blind first choice is still dead
        must come back to the revived replica when that is where live
        traffic will route it — leaving it on the interim successor would
        strand it unreachable until the true owner returns.
        """
        revived_id = fresh.replica_id
        with self._lock:
            others = [
                r
                for rid, r in self._replicas.items()
                if rid != revived_id and r.alive
            ]
        reachable = {revived_id} | {r.replica_id for r in others}

        def routes_to_revived(study_key: str) -> bool:
            for rid in self.router.ranking(study_key):
                if rid in reachable:
                    return rid == revived_id
            return False

        on_successors: set = set()
        for successor in others:
            inner = getattr(successor.datastore, "_inner", successor.datastore)
            moved: set = set()
            for opcode, payload in wal_lib.export_records(inner):
                study_key = wal_lib.study_key_of(opcode, payload)
                on_successors.add(study_key)
                if not routes_to_revived(study_key):
                    continue
                wal_lib.apply_record(fresh.datastore, opcode, payload)
                moved.add(study_key)
            for study_key in moved:
                try:
                    successor.datastore.delete_study(study_key)
                except Exception:  # already gone / never fully copied
                    pass
        fresh_inner = getattr(fresh.datastore, "_inner", fresh.datastore)
        for opcode, payload in wal_lib.export_records(fresh_inner):
            if opcode != wal_lib.CREATE_STUDY:
                continue
            study_key = wal_lib.study_key_of(opcode, payload)
            if study_key in on_successors or not routes_to_revived(
                study_key
            ):
                continue
            try:
                fresh.datastore.delete_study(study_key)
            except Exception:  # pragma: no cover - already gone
                pass

    # -- failure detection -------------------------------------------------

    def _on_endpoint_failure(self, replica_id: str, error: BaseException) -> None:
        """Routed-stub failure hook. Verifies the replica is actually dead
        before failing over: a chaos-injected transport fault on a LIVE
        replica is the retry layer's job, not a topology change."""
        del error
        replica = self.replica(replica_id)
        if replica.alive:
            return
        self.fail_over(replica_id)

    def check_health(self) -> Dict[str, str]:
        """One health sweep: fails over dead replicas, returns the map."""
        with self._lock:
            replicas = list(self._replicas.values())
            failed_over = set(self._failed_over)
        for replica in replicas:
            if not replica.alive and replica.replica_id not in failed_over:
                self.fail_over(replica.replica_id)
        return self.router.snapshot()

    def start_health_loop(self, interval_secs: float = 1.0) -> None:
        """Background health sweeps (idempotent start)."""
        with self._lock:
            if self._health_thread is not None:
                return
            self._health_stop.clear()
            self._health_thread = threading.Thread(
                target=self._health_loop,
                args=(interval_secs,),
                daemon=True,
                name="vizier-replica-health",
            )
            self._health_thread.start()

    def stop_health_loop(self) -> None:
        with self._lock:
            thread = self._health_thread
            self._health_thread = None
        if thread is not None:
            self._health_stop.set()
            thread.join(timeout=5)

    def _health_loop(self, interval_secs: float) -> None:
        while not self._health_stop.wait(interval_secs):
            try:
                self.check_health()
            except Exception as e:  # sweep must never kill the loop
                _logger.warning("Health sweep failed: %s", e)
