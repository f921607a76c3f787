"""The loadgen driver: a virtual-client pool running a scenario against a
real serving target.

The port's copy of the JAX package's ``loadgen/driver.py``. One :func:`run`
call takes an expanded :class:`~vizier_tpu_torch.loadgen.models.Scenario`
and drives it end to end through a REAL stack — the in-process
``VizierServicer`` + shared Pythia, an N-replica ``ReplicaManager`` tier
behind the routed stub, or a fleet of ``replica_main`` processes — with the
scenario's serving planes (batching, speculation, SLO, admission, flight
recorder) armed through their ``VIZIER_TORCH_*`` switches for exactly the
duration of the run. Nothing here stubs the serving path: suggestions come
from the same policy factory, designer cache, coalescer, batch executor,
and surrogate auto-switch production requests use, so a soak failure is a
serving failure. The designers run on ``device`` (CUDA unless the caller
asks for the CPU).

``transport="runtime"`` serves the same studies without the Vizier service
and its protobuf messages: straight into one ``ServingRuntime`` through
``ServingRuntime.serve_suggest``, the Pythia servicer's own order
(coalescing, speculative serve check, admission gate, breaker and the
client's deadline, then the policy, the fallback), each study's trials held
in an ``InRamPolicySupporter``. That is how a host without protobuf and gRPC
drives the scenario; it has no replicas, so the replica events of the track
are recorded as skipped, and its chaos windows strike through
``ChaosDesigner`` (the designer-side seam) instead of the service stub.

Per-request outcomes (latency, speculative-hit stamp, fallback stamp,
errors) are recorded keyed by trace_id into the flight recorder and
returned as :class:`RequestRecord` rows; per-study trajectories and
best-so-far curves feed the report's regret-parity and bit-identity checks.
The scripted event track fires at deterministic completed-trial counts:
replica kill/revive, simultaneous ``multi_kill``, fleet-wide
``rolling_restart``, mid-file ``wal_corrupt``, and chaos fault windows via
``testing/chaos.py``. With WAL replication armed (the default on the
replica tier) revives run under LIVE traffic — the epoch-fenced cutover +
the tier's own failover barrier replace the loadgen driver's external drain gate,
which is kept only for replication-off runs.

The mesh plane (``PlaneConfig.mesh``, ``VIZIER_TORCH_MESH=1`` in the
overlay) carves the run's devices into the executor's placements, as the
JAX package's does; on one card, or on the CPU, that is one placement
(:func:`mesh_stamp` records what was built).

Protobuf, gRPC and the service client are imported inside the targets and
functions that use them, so the records, :func:`scenario_env`,
:class:`LoadgenPolicyFactory` and the runtime transport import without them.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.reliability import config as reliability_config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import fallback as fallback_lib
from vizier_tpu_torch.reliability import retry as retry_lib
from vizier_tpu_torch.serving import admission as admission_lib
from vizier_tpu_torch.serving import speculative as speculative_lib
from vizier_tpu_torch.testing import chaos as chaos_lib

TRANSPORTS = ("service", "runtime")


@dataclasses.dataclass
class RequestRecord:
    """One driven request's outcome (what the report tables roll up)."""

    study_index: int
    kind: str
    tenant: str
    op: str  # "suggest" | "complete"
    latency_s: float
    trace_id: Optional[str] = None
    speculative_hit: bool = False
    fallback: bool = False
    # The admission plane served this request quasi-random (degraded-mode
    # stamp in trial metadata).
    degraded: bool = False
    error: Optional[str] = None

    @property
    def shed(self) -> bool:
        """Client-visible shed: the request failed with the admission
        plane's RESOURCE_EXHAUSTED marker after retries were exhausted
        (absorbed sheds surface in the controller snapshot instead)."""
        return self.error is not None and errors_lib.is_resource_exhausted(
            self.error
        )

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StudyOutcome:
    """One study's end state after the soak."""

    spec: models.StudySpec
    completed: int = 0
    expected: int = 0
    listed_completed: int = -1  # post-run verification sweep (list_trials)
    trajectory: Tuple = ()
    best_curve: Tuple = ()
    error: Optional[str] = None

    @property
    def final_best(self) -> Optional[float]:
        return self.best_curve[-1] if self.best_curve else None

    @property
    def lost(self) -> bool:
        """True when the fleet dropped state for this study: driven
        completions that the post-run trial listing cannot account for."""
        return self.listed_completed < self.spec.preseed + self.completed


@dataclasses.dataclass
class SoakResult:
    """Everything one arm's run produced (input to ``report.py``)."""

    arm: str
    scenario_fingerprint: str
    records: List[RequestRecord]
    outcomes: Dict[int, StudyOutcome]
    events_fired: List[Dict[str, object]]
    serving_stats: Dict[str, object]
    slo: Dict[str, object]
    wall_s: float
    wal_root: Optional[str] = None
    recorder_event_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    # The admission controller's snapshot (per-tenant sheds/admits,
    # overload state, transitions); {"enabled": False} with the plane off.
    admission: Dict[str, object] = dataclasses.field(default_factory=dict)
    # Open-loop releases delayed by the runaway client cap (0 = the run
    # was truly open-loop end to end).
    open_loop_capped: int = 0
    # How the mesh plane ran (:func:`mesh_stamp`).
    mesh: Dict[str, object] = dataclasses.field(default_factory=dict)
    # The run's chaos monkey: per-site calls, faults and latencies.
    chaos_counts: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

    def lost_studies(self) -> List[int]:
        return sorted(i for i, o in self.outcomes.items() if o.lost)

    def errored_studies(self) -> List[int]:
        return sorted(
            i for i, o in self.outcomes.items() if o.error is not None
        )


def scenario_env(config: models.ScenarioConfig) -> Dict[str, str]:
    """The env-switch overlay a scenario runs under (patched around the
    run, restored after): the planes plus the scenario-scoped surrogate
    boundary, so a soak process needs no ambient environment setup. The
    JAX package's overlay, each ``VIZIER_*`` switch under the port's
    ``VIZIER_TORCH_*`` name."""
    planes = config.planes
    env = {
        "VIZIER_TORCH_BATCHING": "1" if planes.batching else "0",
        "VIZIER_TORCH_SPECULATIVE": "1" if planes.speculative else "0",
        "VIZIER_TORCH_MESH": "1" if planes.mesh else "0",
        "VIZIER_TORCH_SLO": "1" if planes.slo else "0",
        "VIZIER_TORCH_FLIGHT_RECORDER": "1" if planes.recorder else "0",
        "VIZIER_TORCH_SPARSE_THRESHOLD": str(config.sparse_threshold),
        "VIZIER_TORCH_SPARSE_INDUCING": str(config.sparse_inducing),
        "VIZIER_TORCH_SPARSE_HYSTERESIS": "2",
    }
    if planes.slo:
        # Manual evaluation cadence: the loadgen driver evaluates at deterministic
        # completion counts instead of a wall-clock sampler thread.
        env["VIZIER_TORCH_SLO_EVAL_INTERVAL_S"] = "0"
        env["VIZIER_TORCH_SLO_WINDOWS"] = "30,600"
        env["VIZIER_TORCH_SLO_SUGGEST_P99_MS"] = str(config.p99_budget_ms)
    if planes.speculative:
        env["VIZIER_TORCH_SPECULATIVE_WORKERS"] = "2"
    env["VIZIER_TORCH_ADMISSION"] = "1" if planes.admission else "0"
    if planes.admission:
        if config.admission_weights:
            # The controller keys tenants by study OWNER id: map the
            # scenario tenant names through the loadgen owner prefix.
            env["VIZIER_TORCH_ADMISSION_WEIGHTS"] = ",".join(
                f"{models.tenant_owner(tenant)}:{weight:g}"
                for tenant, weight in config.admission_weights
            )
        if config.admission_max_inflight:
            env["VIZIER_TORCH_ADMISSION_MAX_INFLIGHT"] = str(
                config.admission_max_inflight
            )
        if config.admission_tenant_inflight:
            env["VIZIER_TORCH_ADMISSION_TENANT_INFLIGHT"] = str(
                config.admission_tenant_inflight
            )
        if config.admission_degraded_floor:
            env["VIZIER_TORCH_ADMISSION_DEGRADED_FLOOR"] = str(
                config.admission_degraded_floor
            )
        if config.admission_window_s:
            env["VIZIER_TORCH_ADMISSION_WINDOW_S"] = str(config.admission_window_s)
        if config.admission_retry_after_ms:
            env["VIZIER_TORCH_ADMISSION_RETRY_AFTER_MS"] = str(
                config.admission_retry_after_ms
            )
    return env


def mesh_stamp(
    config: models.ScenarioConfig, device, executor: Optional[Any]
) -> Dict[str, object]:
    """How the scenario's mesh plane ran: the placements of the run's
    ``executor``. ``None`` stands for a run with no executor in this
    process (batching off, or replicas in other processes, each building
    its own placements from the overlay), which reports none.

    The JAX package's acceptance soak arms the mesh on its one host device,
    which builds one placement; the port does the same on one card. With one
    placement the executor's scheduler runs every flush, as without the
    mesh: a placement worker beside it doubled the GP suggest p50 of
    ``soak_config()`` on an H100 (PERF.md §6).
    """
    if not config.planes.mesh:
        return {"armed": False, "placements": 0}
    placements = executor.placements() if executor is not None else []
    return {"armed": True, "placements": len(placements), "device": str(device)}


def loadgen_reliability() -> reliability_config_lib.ReliabilityConfig:
    """Soak-speed reliability: full machinery, compressed backoffs (the
    soak measures fleet behavior, not wall-clock sleeps). Attempts are
    provisioned for the fault rate the chaos windows inject: at the default
    10% transport-fault probability, 3 attempts lose ~1e-3 of RPCs to
    consecutive faults — a thousands-of-requests soak would flake on its
    own injected noise; 6 attempts put exhaustion at ~1e-6, so a lost study
    means a real fleet bug again."""
    return reliability_config_lib.ReliabilityConfig(
        retry_max_attempts=6,
        retry_base_delay_secs=0.01,
        retry_max_delay_secs=0.1,
        breaker_window_secs=0.5,
        breaker_cooldown_secs=0.2,
    )


class LoadgenPolicyFactory:
    """The service's own policy factory, made per-study deterministic.

    GP algorithms keep the full serving path (designer cache, warm ARD,
    surrogate auto-switch — ``DefaultPolicyFactory`` with the runtime, its
    designers on ``device``) while the scenario injects a per-study
    ``rng_seed`` plus its designer economics (trimmed acquisition sweep /
    ARD budget) through the factory's kwargs hook; RANDOM_SEARCH gets a
    per-study seeded designer so baseline trajectories are reproducible
    too. With ``chaos`` every GP designer is wrapped in a
    ``ChaosDesigner`` striking from that monkey. Thread-safe: the per-call
    injection rides a thread-local around the delegate call.
    """

    def __init__(
        self,
        scenario: models.Scenario,
        *,
        device: device_lib.DeviceLike = "cuda",
        chaos: Optional[chaos_lib.ChaosMonkey] = None,
    ):
        self._scenario = scenario
        self._device = device
        self._chaos = chaos
        self._seed_by_study = {s.name: s.seed for s in scenario.studies}
        self._local = threading.local()
        self._base = None
        self._lock = threading.Lock()

    def bind_runtime(self, serving_runtime) -> None:
        """Connects the serving runtime (built by the target's Pythia)."""
        from vizier_tpu_torch.service import policy_factory as policy_factory_lib

        with self._lock:
            base = policy_factory_lib.DefaultPolicyFactory(
                serving_runtime=serving_runtime, device=self._device
            )
            original = base._gp_designer_kwargs

            def kwargs_hook():
                kwargs = original()
                extra = getattr(self._local, "gp_kwargs", None)
                if extra:
                    kwargs.update(extra)
                return kwargs

            base._gp_designer_kwargs = kwargs_hook
            if self._chaos is not None:
                original_policy = base._gp_policy
                chaos = self._chaos

                def policy_hook(supporter, factory, study_name, problem=None):
                    return original_policy(
                        supporter, chaos_lib.chaos_designer_factory(factory, chaos), study_name,
                        problem=problem,
                    )

                base._gp_policy = policy_hook
            self._base = base

    def _require_base(self):
        with self._lock:
            if self._base is None:
                self.bind_runtime(None)
            return self._base

    def _gp_overrides(self, study_name: str) -> Dict[str, object]:
        config = self._scenario.config
        kwargs: Dict[str, object] = {}
        seed = self._seed_by_study.get(study_name)
        if seed is not None:
            kwargs["rng_seed"] = seed
        if config.acquisition_evals:
            kwargs["max_acquisition_evaluations"] = config.acquisition_evals
        if config.ard_restarts:
            kwargs["ard_restarts"] = config.ard_restarts
        if config.ard_maxiter:
            from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib

            # Captured once per layout and replayed, as the JAX package
            # compiles its loop once per shape.
            kwargs["ard_optimizer"] = lbfgs_lib.AdamOptimizer(
                maxiter=config.ard_maxiter, device=self._device, cuda_graph=True
            )
            kwargs["warm_start_min_trials"] = 0
        return kwargs

    def __call__(self, problem, algorithm, supporter, study_name):
        base = self._require_base()
        algo = (algorithm or "DEFAULT").upper()
        seed = self._seed_by_study.get(study_name)
        if algo == "RANDOM_SEARCH" and seed is not None:
            from vizier_tpu_torch.algorithms import designer_policy
            from vizier_tpu_torch.designers import random as random_designer

            return designer_policy.DesignerPolicy(
                supporter,
                lambda p, **kw: random_designer.RandomDesigner(
                    p.search_space, seed=seed
                ),
            )
        self._local.gp_kwargs = self._gp_overrides(study_name)
        try:
            return base(problem, algorithm, supporter, study_name)
        finally:
            self._local.gp_kwargs = None


# -- targets ---------------------------------------------------------------


class _ServiceStudies:
    """Study creation and listing through a Vizier service stub (the
    protobuf targets)."""

    def open_study(self, spec: models.StudySpec, config: vz.StudyConfig, reliability, monkey):
        """Creates the study and returns its ``VizierClient``, both through
        the chaos-wrapped stub."""
        from vizier_tpu_torch.service import proto_converters as pc
        from vizier_tpu_torch.service import vizier_client
        from vizier_tpu_torch.service.protos import vizier_service_pb2

        stub = chaos_lib.ChaosServiceStub(self.stub, monkey)
        parent = spec.name.rsplit("/studies/", 1)[0]
        # CreateStudy goes straight to the stub (VizierClient has no
        # create-by-resource-name), so it needs its own transient-retry
        # wrap — a chaos fault or a mid-failover routing error here must
        # behave like it does on every other RPC.
        retry_lib.RetryPolicy.from_config(reliability, seed=spec.seed).call(
            lambda: stub.CreateStudy(
                vizier_service_pb2.CreateStudyRequest(
                    parent=parent, study=pc.study_to_proto(config, spec.name)
                )
            )
        )
        return vizier_client.VizierClient(
            stub, spec.name, f"loadgen-{spec.tenant}", reliability=reliability
        )

    def list_trials(self, study_name: str, reliability) -> List[vz.Trial]:
        from vizier_tpu_torch.service import vizier_client

        client = vizier_client.VizierClient(
            self.stub, study_name, "loadgen-verify", reliability=reliability
        )
        return client.list_trials()


class _InProcessTarget(_ServiceStudies):
    """One VizierServicer + shared Pythia (the single-node stack)."""

    supports_replicas = False
    replication_active = False

    def __init__(self, scenario: models.Scenario, reliability, factory, device):
        from vizier_tpu_torch.service import pythia_service, vizier_service

        self._servicer = vizier_service.VizierServicer(
            reliability_config=reliability
        )
        self._pythia = pythia_service.PythiaServicer(
            self._servicer, factory, reliability_config=reliability, device=device
        )
        factory.bind_runtime(self._pythia.serving_runtime)
        self._servicer.set_pythia(self._pythia)
        self.wal_root = None

    @property
    def stub(self):
        return self._servicer

    @property
    def runtime(self):
        return self._pythia.serving_runtime

    def serving_stats(self) -> dict:
        return self._pythia.serving_stats()

    def owner_of(self, study_name: str) -> Optional[str]:
        return None

    def replica_ids(self) -> List[str]:
        return []

    def kill_replica(self, replica_id: str) -> None:
        raise RuntimeError("kill_replica needs the replicas target.")

    revive_replica = kill_replica
    fail_over = kill_replica
    is_alive = kill_replica
    corrupt_wal = kill_replica

    def shutdown(self) -> None:
        self._pythia.shutdown()


class _ReplicaTarget(_ServiceStudies):
    """An N-replica WAL-backed ``ReplicaManager`` tier."""

    supports_replicas = True

    def __init__(self, scenario: models.Scenario, reliability, factory, device):
        from vizier_tpu_torch.distributed import ReplicaManager

        self.wal_root = tempfile.mkdtemp(prefix="vizier-torch-loadgen-wal-")
        self._manager = ReplicaManager(
            scenario.config.replicas,
            wal_root=self.wal_root,
            policy_factory=factory,
            reliability_config=reliability,
            device=device,
        )
        factory.bind_runtime(self._manager.pythia.serving_runtime)

    @property
    def stub(self):
        return self._manager.stub

    @property
    def runtime(self):
        return self._manager.pythia.serving_runtime

    def serving_stats(self) -> dict:
        return self._manager.serving_stats()

    @property
    def replication_active(self) -> bool:
        """True when the tier streams WAL appends to standby logs — the
        regime where kill/revive are safe under live traffic (failover
        barrier + epoch fence) and the loadgen driver needs no external gate."""
        return self._manager.replication_active

    def owner_of(self, study_name: str) -> str:
        return self._manager.router.replica_for(study_name)

    def replica_ids(self) -> List[str]:
        return self._manager.replica_ids()

    def is_alive(self, replica_id: str) -> bool:
        return self._manager.replica(replica_id).alive

    def kill_replica(self, replica_id: str) -> None:
        self._manager.kill_replica(replica_id)

    def fail_over(self, replica_id: str) -> int:
        return self._manager.fail_over(replica_id)

    def revive_replica(self, replica_id: str) -> None:
        self._manager.revive_replica(replica_id)

    def corrupt_wal(self, replica_id: str) -> Dict[str, object]:
        """Deterministically flips 16 bytes at the midpoint of the
        replica's live wal.log (the mid-log corruption a ``wal_corrupt``
        event injects). A later restart of the replica must quarantine
        the now-unreadable suffix and recover it from standby logs."""
        replica = self._manager.replica(replica_id)
        if not replica.wal_dir:
            return {"skipped": "no wal dir"}
        path = os.path.join(replica.wal_dir, "wal.log")
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

    def shutdown(self) -> None:
        self._manager.shutdown()


class _DetachedRuntime:
    """Runtime shim for targets whose serving runtimes live in OTHER
    processes: the loadgen driver cannot reach a subprocess replica's SLO engine,
    admission controller or batch executor, so those report sections and
    the mesh stamp's placements come back empty (each replica dumps its own
    via ``--obs-dump-dir`` instead)."""

    slo_engine = None
    batch_executor = None

    def slo_report(self) -> Dict[str, object]:
        return {}

    def admission_snapshot(self) -> Dict[str, object]:
        return {"enabled": False}


class _SubprocessTarget(_ServiceStudies):
    """An N-replica fleet of REAL ``replica_main`` processes behind the
    lease-based ``SubprocessReplicaManager`` (cross-process standby
    replication over gRPC; kill = SIGKILL, revive = fenced restart +
    copy-back over the wire), each started with ``--device``. The
    scenario's env overlay is inherited by the child processes, so the
    serving planes arm inside each replica; per-study designer seeding does
    NOT cross the process boundary — parity/bit-identity assertions are
    waived for this target (the in-process arms carry that evidence)."""

    supports_replicas = True
    replication_active = True
    supports_compute_tier = False

    def __init__(
        self,
        scenario: models.Scenario,
        reliability,
        factory,
        device,
        compute_tier: bool = False,
    ):
        from vizier_tpu_torch.distributed import subprocess_fleet

        del reliability  # replicas configure their own from the env
        del factory  # subprocess replicas build their own policy factory
        self.wal_root = tempfile.mkdtemp(prefix="vizier-torch-loadgen-subproc-")
        self._manager = subprocess_fleet.SubprocessReplicaManager(
            scenario.config.replicas,
            wal_root=self.wal_root,
            compute_tier=compute_tier,
            device=device,
        )
        self.runtime = _DetachedRuntime()

    @property
    def stub(self):
        return self._manager.stub

    def serving_stats(self) -> dict:
        return self._manager.serving_stats()

    def owner_of(self, study_name: str) -> str:
        return self._manager.owner_of(study_name)

    def replica_ids(self) -> List[str]:
        return self._manager.replica_ids()

    def is_alive(self, replica_id: str) -> bool:
        return self._manager.is_alive(replica_id)

    def kill_replica(self, replica_id: str) -> None:
        self._manager.kill_replica(replica_id)

    def fail_over(self, replica_id: str) -> int:
        return self._manager.fail_over(replica_id)

    def revive_replica(self, replica_id: str) -> None:
        self._manager.revive_replica(replica_id)

    def corrupt_wal(self, replica_id: str) -> Dict[str, object]:
        return self._manager.corrupt_wal(replica_id)

    def shutdown(self) -> None:
        self._manager.shutdown()


class _SharedComputeTarget(_SubprocessTarget):
    """The subprocess fleet PLUS one shared Pythia compute server: every
    frontend replica is spawned with ``--compute-endpoint`` pointed at the
    tier, so their Suggest/EarlyStop traffic crosses the remote hop and
    fuses in ONE batch executor. Killing the compute server must lose
    zero studies — frontends degrade to their local minimal Pythia until
    the manager's health loop (or a scripted revive event) restarts it."""

    supports_compute_tier = True

    def __init__(self, scenario: models.Scenario, reliability, factory, device):
        super().__init__(scenario, reliability, factory, device, compute_tier=True)

    def compute_is_alive(self) -> bool:
        return self._manager.compute_is_alive()

    def kill_compute_server(self) -> None:
        self._manager.kill_compute_server()

    def revive_compute_server(self) -> None:
        self._manager.revive_compute_server()


class _RuntimeStudy:
    """One study of the runtime transport: its config, its trials (an
    ``InRamPolicySupporter``) and its cached policy."""

    def __init__(self, name: str, config: vz.StudyConfig):
        from vizier_tpu_torch.pythia import local_policy_supporters

        self.name = name
        self.config = config
        self.supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid=name)
        # The config incarnation's identity in the speculative fingerprint
        # and the coalescing key.
        self.spec_bytes = f"{name}|{config.algorithm}".encode()
        self.config_hash = speculative_lib.config_digest(self.spec_bytes)
        self.policy = None

    def fingerprint(self) -> speculative_lib.FrontierFingerprint:
        trials = self.supporter.GetTrials()
        return speculative_lib.make_fingerprint(
            self.spec_bytes,
            [t.id for t in trials if t.status == vz.TrialStatus.COMPLETED],
            [t.id for t in trials if t.status == vz.TrialStatus.ACTIVE],
        )


class _RuntimeClient:
    """The ``VizierClient`` calls the loadgen driver makes, served by a
    :class:`_RuntimeTarget`."""

    def __init__(self, target: "_RuntimeTarget", study: _RuntimeStudy, reliability, seed: int):
        self._target = target
        self._study = study
        self._reliability = reliability
        self._retry = retry_lib.RetryPolicy.from_config(reliability, seed=seed)

    def create_trial(self, trial: vz.Trial) -> vz.Trial:
        supporter = self._study.supporter
        supporter.AddTrials([trial])
        return supporter.GetTrials(trial_ids=[len(supporter.trials)])[0]

    def complete_trial(self, trial_id: int, measurement: vz.Measurement) -> vz.Trial:
        return self._target.complete(self._study, trial_id, measurement)

    def get_suggestions(self, count: int) -> List[vz.Trial]:
        # Transient errors (an admission shed) are retried as the service
        # client retries them, each attempt carrying the client's default
        # deadline as the request's wire budget.
        reliability = self._reliability

        def attempt():
            deadline = (
                deadline_lib.Deadline.from_budget(reliability.default_deadline_secs)
                if reliability.deadlines_on
                else deadline_lib.Deadline.none()
            )
            return self._target.suggest(self._study, count, deadline)

        return self._retry.call(attempt)


class _RuntimeTarget:
    """The runtime transport: every study served straight into one
    ``ServingRuntime`` through :meth:`ServingRuntime.serve_suggest`, the
    Pythia servicer's own order without protobuf (coalescing, speculative
    serve check, admission gate, breaker and deadline, the policy, the
    quasi-random fallback), with the service hop's latency observation and
    recorder events. No replicas. ``runtime`` serves in place of one built
    from the environment (a caller that arms its planes itself)."""

    supports_replicas = False
    replication_active = False

    def __init__(self, scenario: Optional[models.Scenario], reliability, factory, device,
                 runtime=None):
        from vizier_tpu_torch.serving import runtime as runtime_lib

        del scenario
        self._runtime_lib = runtime_lib
        self.runtime = runtime or runtime_lib.ServingRuntime(
            reliability=reliability, device=device)
        factory.bind_runtime(self.runtime)
        self._factory = factory
        self._studies: Dict[str, _RuntimeStudy] = {}
        self._lock = threading.Lock()
        self.wal_root = None
        self.runtime.bind_speculative(
            self._speculative_fingerprint, self._speculative_compute, runtime_lib.accept_guarded
        )

    def _study(self, study_name: str) -> _RuntimeStudy:
        with self._lock:
            return self._studies[study_name]

    def open_study(self, spec: models.StudySpec, config: vz.StudyConfig, reliability, monkey):
        del monkey  # the chaos windows strike through the designers
        study = _RuntimeStudy(spec.name, config)
        with self._lock:
            self._studies[spec.name] = study
        return _RuntimeClient(self, study, reliability, spec.seed)

    def list_trials(self, study_name: str, reliability) -> List[vz.Trial]:
        del reliability
        return self._study(study_name).supporter.GetTrials()

    # -- the Pythia servicer's order -----------------------------------------

    def _policy(self, study: _RuntimeStudy):
        if study.policy is not None:
            return study.policy
        policy = self._factory(
            study.config.to_problem(), study.config.algorithm, study.supporter, study.name
        )
        if policy.should_be_cached:
            study.policy = policy
        return policy

    def _serve(self, study: _RuntimeStudy, count: int, max_trial_id: int, deadline_secs: float):
        """One suggest through ``serve_suggest``, as the servicer's
        ``_suggest_coalesced`` makes it."""
        from vizier_tpu_torch.pythia import policy as policy_lib
        from vizier_tpu_torch.serving import coalescer as coalescer_lib

        runtime_lib = self._runtime_lib

        def prepare():
            policy = self._policy(study)
            descriptor = study.supporter.study_descriptor()
            return lambda: policy.suggest(
                policy_lib.SuggestRequest(study_descriptor=descriptor, count=count)
            )

        def fallback(reason: str):
            return fallback_lib.suggest_fallback(
                study.config.to_problem(),
                count,
                study_name=study.name,
                max_trial_id=max_trial_id,
                reason=reason,
            )

        return self.runtime.serve_suggest(
            study.name,
            count,
            key=coalescer_lib.suggest_key(
                study.name, study.config_hash, study.config.algorithm, max_trial_id, count
            ),
            fingerprint=study.fingerprint,
            prepare=prepare,
            fallback=fallback,
            respond=lambda outcome: outcome,
            stamp=runtime_lib.stamp_speculative_hit,
            succeeded=lambda outcome: outcome.error is None,
            deadline_secs=deadline_secs,
            clone=runtime_lib.clone_guarded,
        )

    def _speculative_fingerprint(self, study_name: str):
        study = self._study(study_name)
        return study.fingerprint(), study.supporter.study_descriptor().max_trial_id

    def _speculative_compute(self, study_name: str, count: int, max_trial_id: int):
        """A speculative job through the live path, as the servicer's
        ``_speculative_compute`` sends it (no deadline: nobody waits)."""
        return self._serve(self._study(study_name), count, max_trial_id, 0.0)

    def suggest(self, study: _RuntimeStudy, count: int, deadline) -> List[vz.Trial]:
        runtime = self.runtime
        tracer = tracing_lib.get_tracer()
        t0 = time.perf_counter()
        # 0 on the wire means no deadline, so a budget already spent at send
        # time travels negative, as the service client sends it.
        budget = -1e-3 if deadline.expired else deadline.wire_budget()
        with tracer.span("pythia.suggest", study=study.name, count=count) as span:
            outcome = self._serve(
                study, count, study.supporter.study_descriptor().max_trial_id, budget
            )
            trace_id = getattr(span, "trace_id", None)
        elapsed = time.perf_counter() - t0
        tenant = (
            admission_lib.tenant_of(study.name) if runtime.admission is not None else None
        )
        runtime.observe_suggest_latency("service", elapsed, trace_id=trace_id, tenant=tenant)
        runtime.observe_suggest_latency("pythia", elapsed, trace_id=trace_id)
        recorder_lib.get_recorder().record(
            study.name, "suggest", trace_id=trace_id, duration_secs=round(elapsed, 6),
            error=outcome.error is not None,
        )
        if outcome.error is not None:
            raise outcome.error
        if outcome.decision is not None:
            study.supporter.SendMetadata(outcome.decision.metadata)
        return study.supporter.AddSuggestions(outcome.suggestions)

    def complete(self, study: _RuntimeStudy, trial_id: int, measurement: vz.Measurement) -> vz.Trial:
        (trial,) = study.supporter.GetTrials(trial_ids=[trial_id])
        trial.complete(measurement)
        self.runtime.notify_trial_event(study.name)
        recorder_lib.get_recorder().record(study.name, "complete", trial=trial_id)
        return trial

    def serving_stats(self) -> dict:
        return self.runtime.snapshot()

    def owner_of(self, study_name: str) -> Optional[str]:
        return None

    def replica_ids(self) -> List[str]:
        return []

    def kill_replica(self, replica_id: str) -> None:
        raise RuntimeError("kill_replica needs the replicas target.")

    revive_replica = kill_replica
    fail_over = kill_replica
    is_alive = kill_replica
    corrupt_wal = kill_replica

    def shutdown(self) -> None:
        self.runtime.shutdown()


def _build_target(scenario, reliability, factory, device, transport):
    if transport == "runtime":
        return _RuntimeTarget(scenario, reliability, factory, device)
    if scenario.config.target == "replicas":
        return _ReplicaTarget(scenario, reliability, factory, device)
    if scenario.config.target == "subprocess":
        return _SubprocessTarget(scenario, reliability, factory, device)
    if scenario.config.target == "shared_compute":
        return _SharedComputeTarget(scenario, reliability, factory, device)
    return _InProcessTarget(scenario, reliability, factory, device)


# -- traffic gate + event engine -------------------------------------------


class _TrafficGate:
    """Drain gate for handback windows: ``quiesce`` blocks new requests
    and waits for in-flight ones; ``resume`` reopens. ``revive_replica``
    is not a transactional migration (see ReplicaManager docs), so the
    driver models what a production rollout would do: drain, hand back,
    resume."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._paused = False

    def __enter__(self):
        with self._cond:
            while self._paused:
                self._cond.wait()
            self._active += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._active -= 1
            self._cond.notify_all()
        return False

    def quiesce(self) -> None:
        with self._cond:
            self._paused = True
            while self._active > 0:
                self._cond.wait()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()


class _EventEngine:
    """Fires the scripted track at deterministic completed-trial counts.

    Exactly-once: whichever worker's completion crosses an event's
    threshold fires it (under a lock, outside the request gate). Kill is
    fire-and-forget — detection/failover runs through the normal channels;
    revive drains traffic first via the gate.
    """

    def __init__(
        self,
        scenario: models.Scenario,
        target,
        monkey: chaos_lib.ChaosMonkey,
        gate: _TrafficGate,
    ):
        self._scenario = scenario
        self._target = target
        self._monkey = monkey
        self._gate = gate
        self._lock = threading.Lock()
        self._pending = sorted(
            scenario.events, key=lambda e: (e.at_completed, e.kind)
        )
        self._resolved: Dict[str, str] = {}
        self.fired: List[Dict[str, object]] = []

    def _resolve_replica(self, arg: str, kind: str) -> Optional[str]:
        if arg.startswith("owner:"):
            # A kill's resolution is remembered so the paired revive
            # targets the replica that actually died — after failover the
            # router resolves the owner to the SUCCESSOR, not the corpse.
            if kind != "kill_replica" and arg in self._resolved:
                return self._resolved[arg]
            index = int(arg.split(":", 1)[1])
            spec = next(
                (s for s in self._scenario.studies if s.index == index),
                self._scenario.studies[0],
            )
            replica = self._target.owner_of(spec.name)
            if kind == "kill_replica" and replica is not None:
                self._resolved[arg] = replica
            return replica
        return arg or None

    def on_completed(self, total_completed: int) -> None:
        with self._lock:
            due = [
                e for e in self._pending if e.at_completed <= total_completed
            ]
            if not due:
                return
            self._pending = [
                e for e in self._pending if e.at_completed > total_completed
            ]
        for event in due:
            self._fire(event, total_completed)

    def _revive(self, replica: str) -> None:
        """Hands a replica back. With replication armed the cutover is
        epoch-fenced and fresh RPCs drain through the tier's own failover
        barrier — live traffic keeps flowing; without it the loadgen driver
        models a production rollout: drain via the external gate, hand
        back, resume."""
        if getattr(self._target, "replication_active", False):
            self._target.revive_replica(replica)
            return
        self._gate.quiesce()
        try:
            self._target.revive_replica(replica)
        finally:
            self._gate.resume()

    def _distinct_owners(self, count: int) -> List[str]:
        """The first ``count`` distinct LIVE owners in study-index order
        (deterministic under any concurrency)."""
        owners: List[str] = []
        for spec in self._scenario.studies:
            replica = self._target.owner_of(spec.name)
            if (
                replica is not None
                and replica not in owners
                and self._target.is_alive(replica)
            ):
                owners.append(replica)
            if len(owners) >= count:
                break
        return owners

    def _fire(self, event: models.EventSpec, at: int) -> None:
        record: Dict[str, object] = {
            "kind": event.kind,
            "scheduled_at": event.at_completed,
            "fired_at": at,
            "arg": event.arg,
        }
        try:
            if event.kind == "chaos_on":
                self._monkey.failure_prob = self._scenario.config.chaos_fault_prob
            elif event.kind == "chaos_off":
                self._monkey.failure_prob = 0.0
            elif event.kind == "kill_replica":
                replica = self._resolve_replica(event.arg, event.kind)
                record["replica"] = replica
                if replica is None or not self._target.supports_replicas:
                    record["skipped"] = "no replica tier"
                else:
                    self._target.kill_replica(replica)
            elif event.kind == "revive_replica":
                replica = self._resolve_replica(event.arg, event.kind)
                record["replica"] = replica
                if replica is None or not self._target.supports_replicas:
                    record["skipped"] = "no replica tier"
                else:
                    self._revive(replica)
            elif event.kind == "multi_kill":
                if not self._target.supports_replicas:
                    record["skipped"] = "no replica tier"
                else:
                    count = int(event.arg or "2")
                    victims = self._distinct_owners(count)
                    record["replicas"] = victims
                    if len(victims) < count:
                        record["skipped"] = (
                            f"only {len(victims)} live owners"
                        )
                    else:
                        # SIMULTANEOUS: all victims are dead before any
                        # failover runs, so the sweep must re-route
                        # around every corpse (the concurrent
                        # multi-failure path). One fail_over call sweeps
                        # them all, deterministically.
                        for replica in victims:
                            self._target.kill_replica(replica)
                        record["restored"] = self._target.fail_over(
                            victims[0]
                        )
            elif event.kind == "rolling_restart":
                if not self._target.supports_replicas:
                    record["skipped"] = "no replica tier"
                else:
                    # Revive already-dead replicas FIRST (multi_kill
                    # victims): restarting the last live replica while
                    # others are still down would leave zero live
                    # replicas mid-roll.
                    replicas = self._target.replica_ids()
                    dead = [
                        r for r in replicas if not self._target.is_alive(r)
                    ]
                    for replica in dead:
                        self._target.fail_over(replica)  # ensure swept
                        self._revive(replica)
                    restarted = []
                    for replica in replicas:
                        if replica in dead:
                            continue  # already cycled above
                        self._target.kill_replica(replica)
                        self._target.fail_over(replica)
                        self._revive(replica)
                        restarted.append(replica)
                    record["revived_first"] = dead
                    record["restarted"] = restarted
            elif event.kind == "kill_compute":
                if not getattr(self._target, "supports_compute_tier", False):
                    record["skipped"] = "no compute tier"
                else:
                    self._target.kill_compute_server()
                    record["compute_alive"] = self._target.compute_is_alive()
            elif event.kind == "revive_compute":
                if not getattr(self._target, "supports_compute_tier", False):
                    record["skipped"] = "no compute tier"
                else:
                    self._target.revive_compute_server()
                    record["compute_alive"] = self._target.compute_is_alive()
            elif event.kind == "wal_corrupt":
                replica = self._resolve_replica(event.arg, event.kind)
                record["replica"] = replica
                if replica is None or not self._target.supports_replicas:
                    record["skipped"] = "no replica tier"
                else:
                    record["corruption"] = self._target.corrupt_wal(replica)
        except Exception as e:  # a failed event is a finding, not a crash
            record["error"] = f"{type(e).__name__}: {e}"
        self.fired.append(record)


# -- the loadgen driver ------------------------------------------------------------


def _study_config(spec: models.StudySpec, dim: int) -> vz.StudyConfig:
    config = vz.StudyConfig(algorithm=spec.algorithm)
    for d in range(dim):
        config.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    config.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    return config


def _is_speculative_hit(metadata) -> bool:
    return (
        metadata.ns(speculative_lib.SPECULATIVE_NAMESPACE).get(
            speculative_lib.SPECULATIVE_KEY
        )
        == speculative_lib.SPECULATIVE_HIT_VALUE
    )


class _Run:
    """Mutable state shared by the worker pool for one arm."""

    def __init__(self, scenario: models.Scenario, target, monkey, recorder):
        self.scenario = scenario
        self.target = target
        self.monkey = monkey
        self.recorder = recorder
        self.gate = _TrafficGate()
        self.events = _EventEngine(scenario, target, monkey, self.gate)
        self.records: List[RequestRecord] = []
        self.outcomes: Dict[int, StudyOutcome] = {}
        self.completed_total = 0
        self.lock = threading.Lock()
        self.start = time.perf_counter()
        self.next_index = 0
        # Open-loop releases that hit the runaway client cap (the report
        # surfaces this: a capped run is no longer purely open-loop).
        self.open_loop_capped = 0

    def record(self, row: RequestRecord) -> None:
        with self.lock:
            self.records.append(row)

    def completion(self) -> int:
        with self.lock:
            self.completed_total += 1
            total = self.completed_total
        if (
            self.scenario.config.planes.slo
            and total % 25 == 0
            and self.target.runtime.slo_engine is not None
        ):
            self.target.runtime.slo_engine.evaluate()
        self.events.on_completed(total)
        return total

    def pop_spec(self) -> Optional[models.StudySpec]:
        """Closed-loop dispatch (``time_scale=0``): workers pull the next
        study in arrival ORDER as soon as they free up. Real arrival
        pacing (``time_scale>0``) runs through the open-loop pacer in
        :func:`run` instead — a busy worker pool must not delay an
        arrival."""
        with self.lock:
            if self.next_index >= len(self.scenario.studies):
                return None
            spec = self.scenario.studies[self.next_index]
            self.next_index += 1
        return spec


def _run_study(run: _Run, spec: models.StudySpec, reliability) -> StudyOutcome:
    scenario = run.scenario
    outcome = StudyOutcome(spec=spec, expected=spec.budget)
    tracer = tracing_lib.get_tracer()
    try:
        # Every mutating call runs inside the traffic gate: the revive
        # event's handback window quiesces ALL writes, not just the suggest
        # loop (a study created on a successor mid-copy-back would strand
        # there).
        with run.gate:
            client = run.target.open_study(
                spec, _study_config(spec, scenario.config.dim), reliability, run.monkey
            )
        for params, value in scenario.preseed_points(spec):
            with run.gate:
                created = client.create_trial(vz.Trial(parameters=params))
                client.complete_trial(
                    created.id, vz.Measurement(metrics={"obj": value})
                )
        trajectory: List[Tuple] = []
        best_curve: List[float] = []
        best = float("-inf")
        for step in range(spec.budget):
            with run.gate, tracer.span(
                "loadgen.request",
                study=spec.name,
                kind=spec.kind,
                tenant=spec.tenant,
            ) as span:
                ctx = tracer.current_context()
                trace_id = ctx.trace_id if ctx is not None else None
                t0 = time.perf_counter()
                try:
                    (trial,) = client.get_suggestions(1)
                except Exception as e:
                    latency = time.perf_counter() - t0
                    span.add_event("loadgen.suggest_failed")
                    run.record(
                        RequestRecord(
                            spec.index,
                            spec.kind,
                            spec.tenant,
                            "suggest",
                            latency,
                            trace_id=trace_id,
                            error=f"{type(e).__name__}: {e}",
                        )
                    )
                    raise
                latency = time.perf_counter() - t0
                hit = _is_speculative_hit(trial.metadata)
                fellback = fallback_lib.is_fallback_suggestion(trial.metadata)
                degraded = (
                    trial.metadata.ns(admission_lib.ADMISSION_NAMESPACE).get(
                        admission_lib.ADMISSION_KEY
                    )
                    == admission_lib.ADMISSION_VALUE
                )
                run.record(
                    RequestRecord(
                        spec.index,
                        spec.kind,
                        spec.tenant,
                        "suggest",
                        latency,
                        trace_id=trace_id,
                        speculative_hit=hit,
                        fallback=fellback,
                        degraded=degraded,
                    )
                )
                run.recorder.record(
                    spec.name,
                    "loadgen_outcome",
                    op="suggest",
                    traffic_kind=spec.kind,
                    tenant=spec.tenant,
                    step=step,
                    latency_ms=round(latency * 1e3, 3),
                    speculative_hit=hit,
                    fallback=fellback,
                )
                parameters = {
                    name: float(value)
                    for name, value in trial.parameters.as_dict().items()
                }
                trajectory.append(
                    tuple(
                        sorted(
                            (name, round(value, 12))
                            for name, value in parameters.items()
                        )
                    )
                )
                objective = scenario.objective(spec, parameters)
                best = max(best, objective)
                best_curve.append(best)
                t1 = time.perf_counter()
                client.complete_trial(
                    trial.id, vz.Measurement(metrics={"obj": objective})
                )
                run.record(
                    RequestRecord(
                        spec.index,
                        spec.kind,
                        spec.tenant,
                        "complete",
                        time.perf_counter() - t1,
                        trace_id=trace_id,
                    )
                )
            outcome.completed += 1
            run.completion()
            if (
                scenario.config.think_time_s > 0
                and spec.kind in models.GP_KINDS
            ):
                # The evaluation window: real trials take time to
                # evaluate, which is exactly what gives the speculative
                # pre-compute room to land before the next suggest.
                time.sleep(scenario.config.think_time_s)
        outcome.trajectory = tuple(trajectory)
        outcome.best_curve = tuple(best_curve)
    except Exception as e:
        outcome.error = f"{type(e).__name__}: {e}"
    return outcome


def _normalize_admission(snapshot: Dict[str, object]) -> Dict[str, object]:
    """Maps the controller's owner-keyed per-tenant dicts back to scenario
    tenant names (``loadgen-hot`` → ``hot``) so report tables join."""
    out = dict(snapshot)
    for field in (
        "inflight",
        "admits_by_tenant",
        "sheds_by_tenant",
        "degraded_by_tenant",
    ):
        table = out.get(field)
        if isinstance(table, dict):
            out[field] = {
                models.owner_tenant(owner): value
                for owner, value in table.items()
            }
    return out


def _verification_sweep(run: _Run, reliability) -> None:
    """Post-run completeness check: every study's trials must all be
    accounted for through the (possibly failed-over) serving tier."""
    for spec in run.scenario.studies:
        outcome = run.outcomes.get(spec.index)
        if outcome is None:
            continue
        try:
            trials = run.target.list_trials(spec.name, reliability)
            outcome.listed_completed = sum(
                1 for t in trials if t.status == vz.TrialStatus.COMPLETED
            )
        except Exception as e:
            outcome.listed_completed = -1
            if outcome.error is None:
                outcome.error = f"verify: {type(e).__name__}: {e}"


def _paced_release(run_state: "_Run", scenario, run_one, start) -> List[threading.Thread]:
    """The open-loop pacer: sleeps to each study's scheduled arrival and
    starts it on a fresh client thread. Returns the started threads.

    The only backpressure is ``open_loop_max_clients`` — a pure runaway
    cap (default 128): when it binds, the release blocks until a study
    finishes, which is recorded in the run's event log so a saturated
    report can't silently pass as open-loop.
    """
    config = scenario.config
    cap = max(1, config.open_loop_max_clients)
    slots = threading.Semaphore(cap)
    threads: List[threading.Thread] = []
    capped = 0

    def paced(spec):
        try:
            run_one(spec)
        finally:
            slots.release()

    for spec in scenario.studies:
        release = start + spec.arrival_s * config.time_scale
        delay = release - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if not slots.acquire(blocking=False):
            capped += 1
            slots.acquire()
        thread = threading.Thread(
            target=paced, args=(spec,), name=f"loadgen-open-{spec.index}"
        )
        threads.append(thread)
        thread.start()
    run_state.open_loop_capped = capped
    return threads


def run(
    scenario: models.Scenario,
    *,
    arm: str = "engine",
    only_indices: Optional[Set[int]] = None,
    device: device_lib.DeviceLike = "cuda",
    transport: str = "service",
) -> SoakResult:
    """Drives one arm of the scenario and returns its :class:`SoakResult`.

    The scenario's env overlay (planes + surrogate boundary) is patched
    around the run and restored after; the global tracer and flight
    recorder are swapped for fresh ones so the run's observability is
    self-contained. ``device`` is where the designers run (CUDA unless
    the caller asks for the CPU); ``transport`` is "service" (the Vizier
    service and its protobuf messages, on the config's target) or
    "runtime" (one ``ServingRuntime``, no protobuf; see the module
    docstring).
    """
    import unittest.mock

    if transport not in TRANSPORTS:
        raise ValueError(f"Unknown transport {transport!r}; expected one of {TRANSPORTS}.")
    device = device_lib.resolve(device)
    config = scenario.config
    if only_indices is not None:
        scenario = models.Scenario(
            config,
            [s for s in scenario.studies if s.index in only_indices],
            scenario.events,
        )
    env_patch = unittest.mock.patch.dict(
        "os.environ", scenario_env(config)
    )
    env_patch.start()
    prev_tracer = tracing_lib.set_tracer(tracing_lib.Tracer(max_spans=65536))
    prev_recorder = recorder_lib.set_recorder(None)
    target = None
    reliability = loadgen_reliability()
    try:
        recorder = recorder_lib.get_recorder()
        monkey = chaos_lib.ChaosMonkey(
            seed=config.seed, failure_prob=0.0
        )
        factory = LoadgenPolicyFactory(
            scenario, device=device, chaos=monkey if transport == "runtime" else None
        )
        target = _build_target(scenario, reliability, factory, device, transport)
        mesh = mesh_stamp(config, device, target.runtime.batch_executor)
        run_state = _Run(scenario, target, monkey, recorder)

        def run_one(spec: models.StudySpec) -> None:
            outcome = _run_study(run_state, spec, reliability)
            with run_state.lock:
                run_state.outcomes[spec.index] = outcome

        def worker():
            while True:
                spec = run_state.pop_spec()
                if spec is None:
                    return
                run_one(spec)

        start = time.perf_counter()
        if config.time_scale > 0:
            # OPEN LOOP: release each study at its scheduled arrival
            # instant on its own client thread, whether or not the fleet
            # is keeping up — a busy pool never delays an arrival, so
            # suggest latency under saturation measures real queueing
            # (the MLPerf-loadgen "server" shape). ``concurrency`` does
            # not gate dispatch here; ``open_loop_max_clients`` is only a
            # runaway safety cap.
            threads = _paced_release(run_state, scenario, run_one, start)
        else:
            threads = [
                threading.Thread(target=worker, name=f"loadgen-client-{i}")
                for i in range(max(1, config.concurrency))
            ]
            for t in threads:
                t.start()
        for t in threads:
            t.join()
        # Any events still pending at drain (trial volume fell short of a
        # threshold — e.g. an errored study) fire now so the track always
        # completes and the revive/copy-back is always exercised.
        run_state.events.on_completed(1 << 62)
        if config.planes.slo and target.runtime.slo_engine is not None:
            target.runtime.slo_engine.evaluate()
        _verification_sweep(run_state, reliability)
        wall = time.perf_counter() - start
        recorder_kinds: Dict[str, int] = {}
        for event in recorder.events():
            recorder_kinds[event["kind"]] = (
                recorder_kinds.get(event["kind"], 0) + 1
            )
        return SoakResult(
            arm=arm,
            scenario_fingerprint=scenario.fingerprint(),
            records=run_state.records,
            outcomes=run_state.outcomes,
            events_fired=run_state.events.fired,
            serving_stats=target.serving_stats(),
            slo=target.runtime.slo_report(),
            wall_s=round(wall, 3),
            wal_root=target.wal_root,
            recorder_event_kinds=dict(sorted(recorder_kinds.items())),
            admission=_normalize_admission(
                target.runtime.admission_snapshot()
            ),
            open_loop_capped=run_state.open_loop_capped,
            mesh=mesh,
            chaos_counts=monkey.counts(),
        )
    finally:
        if target is not None:
            target.shutdown()
        tracing_lib.set_tracer(prev_tracer)
        recorder_lib.set_recorder(prev_recorder)
        env_patch.stop()


def run_reference(
    scenario: models.Scenario,
    indices: Optional[Sequence[int]] = None,
    *,
    device: device_lib.DeviceLike = "cuda",
    transport: str = "service",
) -> SoakResult:
    """The sequential reference arm: the parity cohort's studies, one
    client, in-process target, every plane gated off, no chaos, no events
    — the seed-path ground truth the engine is compared against."""
    cohort = (
        set(indices)
        if indices is not None
        else {s.index for s in scenario.parity_cohort()}
    )
    ref_config = dataclasses.replace(
        scenario.config,
        target="inprocess",
        concurrency=1,
        planes=models.PlaneConfig.gated_off(),
        chaos_fault_prob=0.0,
        think_time_s=0.0,
        time_scale=0.0,
    )
    reference = models.Scenario(
        ref_config,
        [s for s in scenario.studies if s.index in cohort],
        (),
    )
    return run(reference, arm="reference", device=device, transport=transport)


def run_gated_off(
    scenario: models.Scenario,
    indices: Optional[Sequence[int]] = None,
    *,
    device: device_lib.DeviceLike = "cuda",
    transport: str = "service",
) -> SoakResult:
    """The engine with every plane gated off, same cohort as the
    reference: bit-identity between this arm and the reference is the
    proof that the loadgen engine itself perturbs nothing."""
    cohort = (
        set(indices)
        if indices is not None
        else {s.index for s in scenario.parity_cohort()}
    )
    gated_config = dataclasses.replace(
        scenario.config,
        target="inprocess",
        planes=models.PlaneConfig.gated_off(),
        chaos_fault_prob=0.0,
        think_time_s=0.0,
        time_scale=0.0,
    )
    gated = models.Scenario(
        gated_config,
        [s for s in scenario.studies if s.index in cohort],
        (),
    )
    return run(gated, arm="gated_off", device=device, transport=transport)
