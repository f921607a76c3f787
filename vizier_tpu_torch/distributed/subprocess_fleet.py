"""Lease-based management of a SUBPROCESS replica fleet.

A copy of the JAX package's ``distributed/subprocess_fleet.py``. It spawns
``python -m vizier_tpu_torch.distributed.replica_main`` (and, with the
compute tier, ``pythia_server_main``) with ``--device``: ``cuda`` unless
the caller asks for the CPU, resolved in the manager first so a host
without a GPU raises before any child starts.

``ReplicaManager`` (replica_manager.py) health-checks replicas by poking
objects in its own address space — which proves nothing about the failure
modes a real fleet has: crashed processes, partitions, slow links. This
module manages replicas that are real OS processes (``replica_main``)
reached only over gRPC, with the failure-detection and recovery planes
crossing the process/network boundary:

- **Lease-based failure detection.** The manager polls each replica's
  ``Heartbeat`` RPC (the ``ReplicationService`` surface) every
  ``heartbeat_interval_s``; a success renews that replica's lease. A
  replica whose lease runs out — crashed, wedged, or partitioned away —
  is declared dead and failed over. A *slow* replica keeps renewing:
  delays shorter than ``lease_timeout_s`` never trigger failover. A
  replica whose PROCESS is observed dead (a transport failure plus a
  reaped pid) is declared immediately, matching the in-process manager's
  verify-then-failover contract.
- **Fence-first failover over the wire.** Failover bumps the dead
  origin's epoch and ``Fence``\\ s every reachable replica BEFORE reading
  any standby log, so a partitioned-but-alive origin (a "zombie") whose
  in-flight appends arrive after the cutover is rejected by the fenced
  standby stores — no split-brain write wins, and the rejections are
  observable (``HeartbeatResponse.fenced_rejections``). Recovery then
  reuses the in-process planner verbatim: ``ExportStandby`` collects every
  live holder's view, :func:`replication.plan_recovery` picks the
  longest-valid-prefix source per study (the corpse's local WAL is
  consulted only when its process is dead and its directory readable),
  and ``ApplyRecords`` applies each study's records through the new
  owner's datastore — re-logged and re-replicated, so the handoff is
  durable the moment the RPC returns.
- **Revive = fenced process restart + copy-back.** The old generation is
  fenced out everywhere, the process restarts warm over its own WAL
  directory ON ITS OLD PORT (peer endpoint strings stay valid; gRPC
  channels reconnect) with ``--replication-epoch`` = the fence, studies
  that failed over meanwhile are copied back through
  ``ExportState``/``ApplyRecords`` and deleted from their interim
  owners, studies deleted while it was down are not resurrected from its
  stale WAL, and every other origin's streamer re-baselines the revived
  replica's standby logs (``Resync``).
- **Network fault injection.** An optional ``testing.netchaos.NetChaos``
  schedule wraps the manager's control links and the routed client
  links, so partitions/drops/delays between driver and fleet travel the
  exact production failure path (``ConnectionError``-shaped → reliability
  retries → routed-stub failure hook). Inter-replica links can be fault-
  injected inside each replica via ``VIZIER_TORCH_NETCHAOS``.

Lock order: ``_lock`` guards the replica/lease/failover tables only;
all RPCs and WAL reads run outside it (failover serializes on
``_failover_lock``, which never nests inside ``_lock``). The lease
table's lock is a leaf.
"""

from __future__ import annotations

import logging
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from vizier_tpu_torch.distributed import config as config_lib
from vizier_tpu_torch.distributed import replication as replication_lib
from vizier_tpu_torch.distributed import replication_service as repl_service
from vizier_tpu_torch.distributed import router_stub
from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.service.protos import replication_service_pb2 as _pb

_logger = logging.getLogger(__name__)

# Fleet-member id of the shared compute server (disaggregated compute
# tier). One per fleet: the whole point is fleet-wide batch fusion.
COMPUTE_ID = "compute-0"


def _pick_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LeaseTable:
    """Per-replica heartbeat leases (leaf lock: dict bookkeeping only).

    A lease is granted/renewed with the wall-free monotonic clock and
    expires ``timeout_s`` later. Expiry is a *statement about silence*,
    not about the process: a partitioned-but-alive replica expires too —
    which is exactly when fencing must keep its late writes out.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._expiry: Dict[str, float] = {}

    def renew(self, replica_id: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expiry[replica_id] = now + self.timeout_s

    def drop(self, replica_id: str) -> None:
        with self._lock:
            self._expiry.pop(replica_id, None)

    def remaining(self, replica_id: str) -> float:
        with self._lock:
            expiry = self._expiry.get(replica_id)
        if expiry is None:
            return 0.0
        return max(0.0, expiry - time.monotonic())

    def expired(self, replica_id: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            expiry = self._expiry.get(replica_id)
        return expiry is not None and now >= expiry

    def snapshot(self) -> Dict[str, float]:
        """replica -> seconds of lease remaining (observability)."""
        now = time.monotonic()
        with self._lock:
            return {
                rid: round(max(0.0, expiry - now), 3)
                for rid, expiry in sorted(self._expiry.items())
            }


class StaleRouteError(ConnectionError):
    """A topology transition completed while this RPC was parked: its
    pre-transition route may be stale (the study may have moved), so the
    call fails transport-shaped and the client's retry re-routes through
    the fresh topology."""


class _ClientGate:
    """Driver-side topology-transition gate with in-flight accounting.

    The cross-process sibling of the in-process ``_TransitionGate`` +
    ``Replica.enter`` pair: every outbound RPC registers in-flight
    ATOMICALLY with the open-gate check (no window where a request has
    passed the barrier but is invisible to a drain), and a transition
    (failover replay, revive copy-back) first waits out the in-flight
    set before touching fleet state. An RPC that had to PARK on the gate
    raises :class:`StaleRouteError` instead of proceeding — its route was
    resolved against the pre-transition topology.
    """

    def __init__(self):
        self.cond = threading.Condition()
        self.transitions = 0
        self.inflight = 0

    def admit(self, timeout_secs: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_secs
        with self.cond:
            if self.transitions == 0:
                self.inflight += 1
                return
            while self.transitions > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.cond.wait(remaining)
            raise StaleRouteError(
                "topology transition completed while this RPC was parked; "
                "retry to re-route"
            )

    def leave(self) -> None:
        with self.cond:
            self.inflight -= 1
            self.cond.notify_all()

    def begin(self) -> None:
        with self.cond:
            self.transitions += 1

    def wait_drained(self, timeout_secs: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_secs
        with self.cond:
            while self.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cond.wait(remaining)
        return True

    def end(self) -> None:
        with self.cond:
            self.transitions -= 1
            self.cond.notify_all()

    def wait_open(self, timeout_secs: float) -> None:
        deadline = time.monotonic() + timeout_secs
        with self.cond:
            while self.transitions > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self.cond.wait(remaining)


class _GatedEndpoint:
    """Endpoint proxy registering every RPC with the client gate."""

    def __init__(self, inner, gate: _ClientGate):
        self._inner = inner
        self._gate = gate

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr):
            return attr
        gate = self._gate

        def call(*args, **kwargs):
            gate.admit()
            try:
                return attr(*args, **kwargs)
            finally:
                gate.leave()

        return call


class _ReplicaProcess:
    """One spawned ``replica_main`` and its addressing."""

    def __init__(self, replica_id: str, port: int, wal_dir: str):
        self.replica_id = replica_id
        self.port = port
        self.wal_dir = wal_dir
        self.endpoint = f"localhost:{port}"
        self.proc: Optional[subprocess.Popen] = None
        self.log_path = os.path.join(
            os.path.dirname(wal_dir), f"{replica_id}.log"
        )

    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class SubprocessReplicaManager:
    """Spawns, leases, fails over, and revives a ``replica_main`` fleet."""

    def __init__(
        self,
        num_replicas: Optional[int] = None,
        *,
        config: Optional[config_lib.DistributedConfig] = None,
        wal_root: str,
        netchaos=None,
        lease_timeout_s: Optional[float] = None,
        heartbeat_interval_s: Optional[float] = None,
        child_env: Optional[Dict[str, str]] = None,
        obs_dump_dir: str = "",
        start_health_loop: bool = True,
        spawn_timeout_s: float = 60.0,
        compute_tier: bool = False,
        device="cuda",
    ):
        from vizier_tpu_torch import device as device_lib

        # The children's --device; resolving it here raises without a GPU
        # before anything is spawned.
        self.device = device_lib.resolve(device).type
        self.config = config or config_lib.DistributedConfig.from_env()
        self._num_replicas = max(2, num_replicas or self.config.num_replicas)
        self._wal_root = wal_root
        self._netchaos = netchaos
        self._child_env = dict(child_env or {})
        self._obs_dump_dir = obs_dump_dir
        self._spawn_timeout_s = spawn_timeout_s
        self.lease = LeaseTable(
            lease_timeout_s
            if lease_timeout_s is not None
            else self.config.lease_timeout_s
        )
        self._heartbeat_interval_s = (
            heartbeat_interval_s
            if heartbeat_interval_s is not None
            else self.config.heartbeat_interval_s
        )

        replica_ids = [f"replica-{i}" for i in range(self._num_replicas)]
        self.router = routing.StudyRouter(replica_ids, routing=self.config.routing)

        # Replica/lease/failover bookkeeping only; RPCs never run under it.
        self._lock = threading.Lock()
        self._failover_lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaProcess] = {}
        self._declared_dead: set = set()
        self._failed_over: set = set()
        self._epochs: Dict[str, int] = {rid: 1 for rid in replica_ids}
        self._failovers = 0
        self._restored_studies = 0
        self._recovery_sources: Dict[str, int] = {}
        self._heartbeat_stats: Dict[str, Dict[str, int]] = {}

        # Barrier + in-flight accounting: fresh client RPCs park while a
        # failover replay / revive copy-back is mid-flight, register
        # in-flight atomically with the gate check, and transitions drain
        # the in-flight set before touching fleet state (the in-process
        # passed-barrier-but-invisible-to-drain race, client-side).
        self._gate = _ClientGate()

        ports = [_pick_port() for _ in replica_ids]
        for rid, port in zip(replica_ids, ports):
            self._replicas[rid] = _ReplicaProcess(
                rid, port, os.path.join(wal_root, rid)
            )
        self._peers_arg = ",".join(
            f"{rid}={rec.endpoint}" for rid, rec in self._replicas.items()
        )

        # Disaggregated compute tier: one shared Pythia compute server the
        # whole fleet dispatches to (distributed.compute_tier). A fleet
        # member for leasing/failover purposes, but it owns no studies —
        # its "failover" is just a respawn, with frontends riding their
        # local-Pythia fallback through the gap.
        self._compute: Optional[_ReplicaProcess] = None
        self._compute_restarts = 0
        if compute_tier:
            self._compute = _ReplicaProcess(
                COMPUTE_ID, _pick_port(), os.path.join(wal_root, COMPUTE_ID)
            )

        # Control plane: the replication surface of every replica (plus
        # the compute server's Heartbeat-only surface), with bounded
        # transport retries and the netchaos manager-side links.
        control_endpoints = {
            rid: rec.endpoint for rid, rec in self._replicas.items()
        }
        if self._compute is not None:
            control_endpoints[COMPUTE_ID] = self._compute.endpoint
        self._control = repl_service.GrpcReplicationLink(
            control_endpoints,
            src_id="manager",
            netchaos=netchaos,
            connect_timeout_secs=5.0,
        )

        records = list(self._replicas.values())
        if self._compute is not None:
            records.append(self._compute)
        try:
            if self._compute is not None:
                self._spawn_compute(self._compute)
            for rid in replica_ids:
                self._spawn(self._replicas[rid], epoch=1)
            self._await_ready(records)
        except BaseException:
            # A child that failed to start must not leave its siblings
            # running behind a manager that never came up.
            for rec in records:
                if rec.running():
                    rec.proc.kill()
                    rec.proc.wait(timeout=10)
            raise
        # Leases begin only once every child has said READY: a slow import
        # must not read as a death.
        for rid in replica_ids:
            self.lease.renew(rid)
        if self._compute is not None:
            self.lease.renew(COMPUTE_ID)

        self._stub = router_stub.RoutedVizierStub(
            {
                rid: self._endpoint_factory(rid)
                for rid in replica_ids
            },
            router=self.router,
            on_failure=self._on_endpoint_failure,
            barrier=self.failover_barrier,
        )

        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        if start_health_loop:
            self.start_health_loop()

    # -- spawning ------------------------------------------------------------

    def _endpoint_factory(self, replica_id: str):
        def factory():
            from vizier_tpu_torch.service import grpc_stubs

            with self._lock:
                endpoint = self._replicas[replica_id].endpoint
            stub = grpc_stubs.create_vizier_stub(endpoint)
            if self._netchaos is not None:
                stub = self._netchaos.wrap_stub(stub, "client", replica_id)
            return _GatedEndpoint(stub, self._gate)

        return factory

    def _spawn(self, rec: _ReplicaProcess, *, epoch: int) -> None:
        args = [
            sys.executable,
            "-m",
            "vizier_tpu_torch.distributed.replica_main",
            "--replica-id",
            rec.replica_id,
            "--port",
            str(rec.port),
            "--wal-dir",
            rec.wal_dir,
            "--peers",
            self._peers_arg,
            "--replication-factor",
            str(self.config.replication_factor),
            "--replication-epoch",
            str(epoch),
            "--device",
            self.device,
        ]
        if self._compute is not None:
            args += ["--compute-endpoint", self._compute.endpoint]
        if self._obs_dump_dir:
            args += ["--obs-dump-dir", self._obs_dump_dir]
        self._popen(rec, args)

    def _spawn_compute(self, rec: _ReplicaProcess) -> None:
        args = [
            sys.executable,
            "-m",
            "vizier_tpu_torch.distributed.pythia_server_main",
            "--server-id",
            rec.replica_id,
            "--port",
            str(rec.port),
            "--frontends",
            self._peers_arg,
            "--device",
            self.device,
        ]
        if self._obs_dump_dir:
            args += ["--obs-dump-dir", self._obs_dump_dir]
        self._popen(rec, args)

    def _popen(self, rec: _ReplicaProcess, args: List[str]) -> None:
        os.makedirs(self._wal_root, exist_ok=True)
        log = open(rec.log_path, "ab")
        try:
            rec.proc = subprocess.Popen(
                args,
                stdout=subprocess.PIPE,
                stderr=log,
                text=True,
                env={**os.environ, **self._child_env},
            )
        finally:
            log.close()

    def _await_ready(self, records: Sequence[_ReplicaProcess]) -> None:
        """Waits for each child's ``READY <endpoint>`` line, all within one
        ``spawn_timeout_s`` deadline (a child that hangs before printing
        cannot block the manager past it)."""
        deadline = time.monotonic() + self._spawn_timeout_s
        for rec in records:
            line = ""
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                ready, _, _ = select.select(
                    [rec.proc.stdout], [], [], min(remaining, 0.5)
                )
                if not ready:
                    continue
                raw = rec.proc.stdout.readline()
                if not raw:
                    break  # EOF: the child exited before READY
                line = raw.strip()
                if line:
                    break
            if not line.startswith("READY "):
                raise RuntimeError(
                    f"{rec.replica_id} failed to start (got {line!r}); "
                    f"see {rec.log_path}"
                )
            endpoint = line.split(" ", 1)[1]
            if endpoint != rec.endpoint:  # pragma: no cover - port pinned
                rec.endpoint = endpoint

    # -- public surface ------------------------------------------------------

    @property
    def stub(self) -> router_stub.RoutedVizierStub:
        return self._stub

    def replica_ids(self) -> List[str]:
        return list(self.router.replica_ids)

    def endpoint_of(self, replica_id: str) -> str:
        with self._lock:
            return self._replicas[replica_id].endpoint

    def owner_of(self, study_name: str) -> str:
        return self.router.replica_for(study_name)

    def is_alive(self, replica_id: str) -> bool:
        with self._lock:
            rec = self._replicas[replica_id]
            declared = replica_id in self._declared_dead
        return rec.running() and not declared

    @property
    def replication_active(self) -> bool:
        return True  # subprocess tiers always stream (peers + WAL dirs)

    def serving_stats(self) -> dict:
        with self._lock:
            stats = {
                "failovers": self._failovers,
                "restored_studies": self._restored_studies,
                "recovery_sources": dict(self._recovery_sources),
                "replication": {
                    "factor": self.config.replication_factor,
                    "fenced_rejections": sum(
                        s.get("fenced_rejections", 0)
                        for s in self._heartbeat_stats.values()
                    ),
                    "resyncs": sum(
                        s.get("resyncs", 0)
                        for s in self._heartbeat_stats.values()
                    ),
                    "heartbeats": {
                        rid: dict(s)
                        for rid, s in sorted(self._heartbeat_stats.items())
                    },
                },
            }
        stats["router"] = self.router.snapshot()
        stats["replicas"] = self._stub.stats()["replicas"]
        stats["leases"] = self.lease.snapshot()
        if self._compute is not None:
            with self._lock:
                restarts = self._compute_restarts
            stats["compute_tier"] = {
                "endpoint": self._compute.endpoint,
                "alive": self._compute.running(),
                "restarts": restarts,
            }
        return stats

    def shutdown(self, grace_s: float = 10.0) -> None:
        self.stop_health_loop()
        with self._lock:
            records = list(self._replicas.values())
        if self._compute is not None:
            records.append(self._compute)
        for rec in records:
            if rec.running():
                rec.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace_s
        for rec in records:
            if rec.proc is None:
                continue
            try:
                rec.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rec.proc.kill()
                rec.proc.wait(timeout=5)
        from vizier_tpu_torch.service import grpc_stubs

        for rec in records:
            grpc_stubs.close_channel(rec.endpoint)

    # -- failure detection ---------------------------------------------------

    def start_health_loop(self) -> None:
        with self._lock:
            if self._health_thread is not None:
                return
            self._health_stop.clear()
            self._health_thread = threading.Thread(
                target=self._health_loop,
                daemon=True,
                name="vizier-subprocess-health",
            )
            self._health_thread.start()

    def stop_health_loop(self) -> None:
        with self._lock:
            thread = self._health_thread
            self._health_thread = None
        if thread is not None:
            self._health_stop.set()
            thread.join(timeout=5)

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self._heartbeat_interval_s):
            try:
                self.check_health()
            except Exception as e:  # a sweep must never kill the loop
                _logger.warning("Subprocess health sweep failed: %s", e)

    def check_health(self) -> Dict[str, str]:
        """One heartbeat sweep: renew leases, fail over expired ones."""
        with self._lock:
            candidates = [
                rid
                for rid in self.router.replica_ids
                if rid not in self._declared_dead
            ]
        for rid in candidates:
            try:
                response = self._control.call_once(
                    rid, "Heartbeat", _pb.HeartbeatRequest(sender="manager")
                )
            except Exception:
                continue  # no renewal; the lease keeps draining
            self.lease.renew(rid)
            with self._lock:
                self._heartbeat_stats[rid] = {
                    "seq": int(response.seq),
                    "fenced_rejections": int(response.fenced_rejections),
                    "resyncs": int(response.resyncs),
                }
        now = time.monotonic()
        for rid in candidates:
            if self.lease.expired(rid, now):
                self._declare_dead(rid, reason="lease_expired")
        self._check_compute_health()
        return self.router.snapshot()

    def _check_compute_health(self) -> None:
        """Compute-server arm of the sweep: renew its lease, and respawn
        it on expiry. No studies live there, so its failover IS the
        respawn — frontends serve from their local fallback in between."""
        if self._compute is None:
            return
        try:
            self._control.call_once(
                COMPUTE_ID, "Heartbeat", _pb.HeartbeatRequest(sender="manager")
            )
        except Exception:
            pass  # no renewal; the lease keeps draining
        else:
            self.lease.renew(COMPUTE_ID)
            return
        if self.lease.expired(COMPUTE_ID):
            recorder_lib.get_recorder().record(
                None,
                "replica_declared_dead",
                replica=COMPUTE_ID,
                reason="lease_expired",
            )
            try:
                self.revive_compute_server()
            except Exception as e:  # next sweep retries
                _logger.warning("Compute-server respawn failed: %s", e)

    def _on_endpoint_failure(self, replica_id: str, error: BaseException) -> None:
        """Routed-stub failure hook. A transport fault alone is NOT death
        (it may be a partition or a chaos drop — the lease decides);
        only an actually-exited process is declared immediately."""
        del error
        with self._lock:
            rec = self._replicas[replica_id]
            declared = replica_id in self._declared_dead
        if declared:
            return
        if rec.proc is not None and rec.proc.poll() is not None:
            self._declare_dead(replica_id, reason="process_exited")

    def _declare_dead(self, replica_id: str, *, reason: str) -> None:
        with self._lock:
            if replica_id in self._declared_dead:
                return
            self._declared_dead.add(replica_id)
        self.lease.drop(replica_id)
        recorder_lib.get_recorder().record(
            None, "replica_declared_dead", replica=replica_id, reason=reason
        )
        self.fail_over(replica_id)

    # -- topology-transition barrier -----------------------------------------

    def failover_barrier(self, timeout_secs: float = 30.0) -> None:
        """Routed-stub hook: routes are only resolved against an open
        gate (the endpoint proxy re-checks atomically at call time)."""
        self._gate.wait_open(timeout_secs)

    def _begin_transition(self, drain_timeout_s: float = 10.0) -> None:
        self._gate.begin()
        if not self._gate.wait_drained(drain_timeout_s):
            _logger.warning(
                "Topology transition proceeding with client RPCs still "
                "in flight after %.1fs.",
                drain_timeout_s,
            )

    def _end_transition(self) -> None:
        self._gate.end()

    # -- chaos / lifecycle ---------------------------------------------------

    def kill_replica(self, replica_id: str, *, flush: bool = True) -> None:
        """SIGKILLs a replica process (a real crash, not a graceful stop).

        ``flush`` first drains its replication streamer — the acked-
        replication durability point (the in-process tier's
        ``flush_replication`` models the same point): replication is
        asynchronous, so an append acked microseconds before an arbitrary
        SIGKILL may legitimately be in flight; the flush pins the kill to
        the instant where everything the client observed is on the
        successors.
        """
        with self._lock:
            rec = self._replicas[replica_id]
        if flush and rec.running():
            try:
                self._control.call_once(
                    replica_id,
                    "FlushStream",
                    _pb.FlushStreamRequest(timeout_secs=5.0),
                )
            except Exception:
                pass  # dying anyway; recovery plans around the gap
        if rec.running():
            rec.proc.kill()
            try:
                rec.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        recorder_lib.get_recorder().record(
            None, "replica_killed", replica=replica_id
        )

    def has_compute_tier(self) -> bool:
        return self._compute is not None

    def compute_endpoint(self) -> str:
        if self._compute is None:
            raise RuntimeError("This fleet has no compute tier.")
        return self._compute.endpoint

    def compute_is_alive(self) -> bool:
        return self._compute is not None and self._compute.running()

    def kill_compute_server(self) -> None:
        """SIGKILLs the shared compute server (a real crash). Frontends
        degrade to their local Pythia; the health loop (or an explicit
        :meth:`revive_compute_server`) brings the tier back."""
        if self._compute is None:
            raise RuntimeError("This fleet has no compute tier.")
        rec = self._compute
        if rec.running():
            rec.proc.kill()
            try:
                rec.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        recorder_lib.get_recorder().record(
            None, "replica_killed", replica=COMPUTE_ID
        )

    def revive_compute_server(self) -> None:
        """Respawns the compute server on its old port (idempotent: a
        running server is left alone). No fencing and no copy-back — the
        tier is stateless from the fleet's point of view; the shared
        designer cache simply re-warms."""
        if self._compute is None:
            raise RuntimeError("This fleet has no compute tier.")
        rec = self._compute
        with self._failover_lock:
            if rec.running():
                return
            self._spawn_compute(rec)
            self._await_ready([rec])
            # Evict the manager-side channel stuck in reconnect backoff;
            # each FRONTEND evicts its own channel via the RemotePythiaStub
            # cooldown/reconnect path — close_channel here only fixes this
            # process's cache.
            from vizier_tpu_torch.service import grpc_stubs

            grpc_stubs.close_channel(rec.endpoint)
            self._control.set_endpoint(COMPUTE_ID, rec.endpoint)
            self.lease.renew(COMPUTE_ID)
            with self._lock:
                self._compute_restarts += 1
        recorder_lib.get_recorder().record(
            None, "replica_revive", replica=COMPUTE_ID, was_failed_over=False
        )

    def partition_replica(self, replica_id: str) -> None:
        """Severs every driver-side link to ``replica_id`` (netchaos):
        heartbeats stop renewing its lease and client RPCs fail transport-
        shaped — the replica itself keeps running (the zombie regime)."""
        if self._netchaos is None:
            raise RuntimeError("partition_replica needs a NetChaos schedule.")
        self._netchaos.partition(replica_id)
        recorder_lib.get_recorder().record(
            None, "replica_partitioned", replica=replica_id
        )

    def heal_partition(self, replica_id: str) -> None:
        if self._netchaos is None:
            return
        self._netchaos.heal(replica_id)
        recorder_lib.get_recorder().record(
            None, "replica_partition_healed", replica=replica_id
        )

    def corrupt_wal(self, replica_id: str) -> Dict[str, object]:
        """Flips 16 bytes at the midpoint of the replica's live wal.log
        (the ``wal_corrupt`` severity event, manager-side)."""
        with self._lock:
            rec = self._replicas[replica_id]
        path = os.path.join(rec.wal_dir, wal_lib.LOG_FILE)
        try:
            size = os.path.getsize(path)
        except OSError:
            return {"skipped": "no wal.log"}
        if size < 64:
            return {"skipped": f"log too small ({size} bytes)"}
        offset = size // 2
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(b"\xff" * 16)
        return {"log_bytes": size, "corrupted_at": offset}

    # -- failover -------------------------------------------------------------

    def _live_ids(self) -> List[str]:
        with self._lock:
            return [
                rid
                for rid in self.router.replica_ids
                if rid not in self._declared_dead
            ]

    def _next_epoch(self, origin: str) -> int:
        with self._lock:
            self._epochs[origin] = self._epochs.get(origin, 1) + 1
            return self._epochs[origin]

    def fail_over(self, replica_id: str) -> int:
        """Marks declared-dead replicas down and lifts their studies onto
        successors from the fleet's standby logs, over the wire.

        One call sweeps EVERY declared-dead, not-yet-failed-over replica
        in deterministic id order under one topology transition, exactly
        like the in-process sweep. Idempotent.
        """
        # An EXITED process counts as detected, whether or not a lease
        # has expired yet (the scripted kill→fail_over path, and the
        # "every currently-dead replica" sweep contract: simultaneous
        # multi-kill victims must ALL be corpses to the sweep, or a
        # successor choice — or a standby export — could land on one).
        # Running (possibly partitioned) replicas still wait for their
        # lease to expire.
        newly_declared: List[str] = []
        with self._lock:
            if replica_id in self._failed_over:
                return 0
            for rid, rec in self._replicas.items():
                if (
                    rid not in self._declared_dead
                    and rec.proc is not None
                    and rec.proc.poll() is not None
                ):
                    self._declared_dead.add(rid)
                    newly_declared.append(rid)
        for rid in newly_declared:
            self.lease.drop(rid)
        completed: List[dict] = []
        total_restored = 0
        with self._failover_lock:
            with self._lock:
                if (
                    replica_id in self._failed_over
                    or replica_id not in self._declared_dead
                ):
                    return 0
                dead = sorted(
                    rid
                    for rid in self._declared_dead
                    if rid not in self._failed_over
                )
                self._failed_over.update(dead)
            for rid in dead:
                self.router.mark_down(rid)
            self._begin_transition()
            try:
                for rid in dead:
                    restored, successors, sources = self._restore(rid)
                    self._stub.note_failed_over(rid)
                    total_restored += restored
                    completed.append(
                        {
                            "replica": rid,
                            "restored": restored,
                            "successors": sorted(successors),
                            "sources": sources,
                        }
                    )
            finally:
                self._end_transition()
        with self._lock:
            for entry in completed:
                self._failovers += 1
                self._restored_studies += entry["restored"]
                for source, count in entry["sources"].items():
                    self._recovery_sources[source] = (
                        self._recovery_sources.get(source, 0) + count
                    )
        for entry in completed:
            recorder_lib.get_recorder().record(
                None,
                "replica_failover",
                replica=entry["replica"],
                successors=entry["successors"],
                restored_studies=entry["restored"],
                recovery_sources=entry["sources"],
            )
        return total_restored

    def _restore(self, origin: str) -> Tuple[int, set, Dict[str, int]]:
        """Fence → collect standby views → plan → apply, all over gRPC."""
        live = [rid for rid in self._live_ids() if rid != origin]
        # FENCE FIRST: after this, nothing the origin's stale generation
        # streams can enter any live standby log — the views exported
        # below are final, and a zombie's post-partition appends are
        # rejected (and counted) rather than racing the replay.
        new_epoch = self._next_epoch(origin)
        for rid in live:
            try:
                self._control.call(
                    rid,
                    "Fence",
                    _pb.FenceRequest(origin=origin, epoch=new_epoch),
                )
            except Exception as e:
                _logger.warning("Fence of %s on %s failed: %s", origin, rid, e)
        holders: List[str] = []
        views: List[replication_lib.StandbyView] = []
        for rid in live:
            try:
                response = self._control.call(
                    rid, "ExportStandby", _pb.ExportStandbyRequest(origin=origin)
                )
            except Exception as e:
                _logger.warning(
                    "ExportStandby(%s) from %s failed: %s", origin, rid, e
                )
                continue
            if response.present:
                holders.append(rid)
                views.append(
                    replication_lib.StandbyView(
                        baseline_seq=int(response.baseline_seq),
                        records=repl_service.records_from_proto(
                            response.records
                        ),
                    )
                )
        # The corpse's local WAL is an optimization, not a dependency —
        # and reading the live disk of a PARTITIONED (still-running)
        # origin would be a shared-filesystem cheat, so only an exited
        # process's directory is consulted.
        local_records: List[Tuple[int, int, bytes]] = []
        local_torn = False
        with self._lock:
            rec = self._replicas[origin]
        if not rec.running() and os.path.isdir(rec.wal_dir):
            local_records, local_torn = wal_lib.read_directory_with_seqs(
                rec.wal_dir
            )
        plan = replication_lib.plan_recovery(
            origin,
            local_records,
            local_torn,
            views,
            successors_fn=lambda study: self.router.successors(
                study, origin, self.config.replication_factor
            ),
            holders=holders,
        )
        successors: set = set()
        per_owner: Dict[str, List[replication_lib.Record]] = {}
        for item in plan.studies:
            owner = self.router.replica_for(item.study)
            per_owner.setdefault(owner, []).extend(
                (item.seq, opcode, payload)
                for opcode, payload in item.records
            )
            successors.add(owner)
        for owner, records in sorted(per_owner.items()):
            request = _pb.ApplyRecordsRequest()
            repl_service.records_to_proto(records, request.records)
            self._control.call(owner, "ApplyRecords", request)
        return len(plan.studies), successors, plan.source_counts()

    # -- revive ---------------------------------------------------------------

    def revive_replica(self, replica_id: str) -> None:
        """Fenced process restart + copy-back (safe under live traffic).

        The zombie (if the process still runs — the healed-partition
        case) is killed first: its generation is already fenced out and
        two processes must not share one WAL directory.
        """
        with self._failover_lock:
            with self._lock:
                rec = self._replicas[replica_id]
                was_failed_over = replica_id in self._failed_over
                declared = replica_id in self._declared_dead
            if not declared and rec.running():
                return  # never declared dead: nothing to revive
            if rec.running():
                rec.proc.kill()
                try:
                    rec.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
            new_epoch = self._next_epoch(replica_id)
            for rid in self._live_ids():
                if rid == replica_id:
                    continue
                try:
                    self._control.call(
                        rid,
                        "Fence",
                        _pb.FenceRequest(origin=replica_id, epoch=new_epoch),
                    )
                except Exception:
                    pass
            self._spawn(rec, epoch=new_epoch)
            self._await_ready([rec])
            # The shared channel to this endpoint is sitting in gRPC's
            # TRANSIENT_FAILURE reconnect backoff (every RPC fails fast
            # with the cached refusal until the backoff expires): evict
            # it so the copy-back and fresh client traffic connect to the
            # restarted server immediately.
            from vizier_tpu_torch.service import grpc_stubs

            grpc_stubs.close_channel(rec.endpoint)
            self._control.set_endpoint(replica_id, rec.endpoint)
            self._begin_transition()
            try:
                if was_failed_over:
                    self._copy_back(replica_id)
                with self._lock:
                    self._declared_dead.discard(replica_id)
                    self._failed_over.discard(replica_id)
                self._stub.set_endpoint(
                    replica_id, self._endpoint_factory(replica_id)
                )
                self.router.mark_up(replica_id)
                self.lease.renew(replica_id)
            finally:
                self._end_transition()
            # Every other origin re-baselines the revived replica's
            # standby logs, which went stale while it was down.
            for rid in self._live_ids():
                if rid == replica_id:
                    continue
                try:
                    self._control.call(
                        rid, "Resync", _pb.ResyncRequest(successor=replica_id)
                    )
                except Exception:
                    pass
        recorder_lib.get_recorder().record(
            None,
            "replica_revive",
            replica=replica_id,
            was_failed_over=was_failed_over,
            epoch_fenced=True,
        )

    def _copy_back(self, revived_id: str) -> None:
        """Moves studies the revived replica owns back from their interim
        successors, and deletes net-deleted studies its stale WAL
        resurrected — the in-process ``_copy_back_from_successors``
        contract, executed over ``ExportState``/``ApplyRecords``."""
        live = [rid for rid in self._live_ids() if rid != revived_id]
        reachable = set(live) | {revived_id}

        def routes_to_revived(study_key: str) -> bool:
            for rid in self.router.ranking(study_key):
                if rid in reachable:
                    return rid == revived_id
            return False

        from vizier_tpu_torch.service import grpc_stubs
        from vizier_tpu_torch.service.protos import vizier_service_pb2

        on_successors: set = set()
        for successor in live:
            try:
                state = self._control.call(
                    successor, "ExportState", _pb.ExportStateRequest()
                )
            except Exception as e:
                _logger.warning(
                    "ExportState from %s failed during revive of %s: %s",
                    successor,
                    revived_id,
                    e,
                )
                continue
            moved_records = _pb.ApplyRecordsRequest()
            moved_studies: set = set()
            for record in state.records:
                study_key = wal_lib.study_key_of(record.opcode, record.payload)
                on_successors.add(study_key)
                if not routes_to_revived(study_key):
                    continue
                moved_records.records.add(
                    seq=record.seq, opcode=record.opcode, payload=record.payload
                )
                moved_studies.add(study_key)
            if moved_studies:
                self._control.call(revived_id, "ApplyRecords", moved_records)
                # Delete from the interim owner DIRECTLY (not routed: the
                # router already maps these studies to the revived
                # replica).
                with self._lock:
                    endpoint = self._replicas[successor].endpoint
                vstub = grpc_stubs.create_vizier_stub(endpoint)
                for study_key in sorted(moved_studies):
                    try:
                        vstub.DeleteStudy(
                            vizier_service_pb2.DeleteStudyRequest(
                                name=study_key
                            )
                        )
                    except Exception:
                        pass  # already gone / never fully copied
        # Studies the revived replica rebuilt from its own (stale) WAL
        # that exist on NO live successor were deleted while it was down:
        # delete them rather than resurrect.
        try:
            state = self._control.call(
                revived_id, "ExportState", _pb.ExportStateRequest()
            )
        except Exception:
            return
        with self._lock:
            endpoint = self._replicas[revived_id].endpoint
        vstub = grpc_stubs.create_vizier_stub(endpoint)
        for record in state.records:
            if record.opcode != wal_lib.CREATE_STUDY:
                continue
            study_key = wal_lib.study_key_of(record.opcode, record.payload)
            if study_key in on_successors or not routes_to_revived(study_key):
                continue
            try:
                vstub.DeleteStudy(
                    vizier_service_pb2.DeleteStudyRequest(name=study_key)
                )
            except Exception:  # pragma: no cover - already gone
                pass
