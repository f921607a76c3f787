"""The single source of truth for every ``VIZIER_TORCH_*`` switch.

The port's copy of the JAX package's ``analysis/registry.py``, over the
port's own switches. Every environment variable the port reads (and every
reserved ``VIZIER_*`` constant that is *not* an environment variable) is
declared here with its owner and its doc file. The ``env_registry`` pass
fails any ``os.environ`` read, direct or through the helpers below, of a
name missing from this table, and any declared switch that its doc file
does not mention.

Runtime code reads switches through :func:`env_on` / :func:`env_int` /
:func:`env_float` / :func:`env_str` (re-exported by ``utils/env.py``),
which raise on undeclared names, so a mistyped switch fails loudly instead
of reading a variable nobody sets.

Stdlib-only: config modules all over the port import this, and the
analysis suite runs without torch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

PREFIX = "VIZIER_TORCH_"

# Declaration kinds:
#   "flag"     — boolean-ish on/off switch ("0"/"false"/"" = off);
#   "int"      — integer-valued;
#   "float"    — float-valued;
#   "str"      — free-form string (paths, names);
#   "constant" — a reserved VIZIER_* Python constant that is NOT an
#                environment variable (reading it from os.environ is a
#                violation).
_KINDS = ("flag", "int", "float", "str", "constant")

# Where every switch is documented (generated from this table by
# :func:`render_doc`).
DOC = "vizier_tpu_torch/analysis/SWITCHES.md"


@dataclasses.dataclass(frozen=True)
class EnvSwitch:
    """One declared ``VIZIER_*`` name."""

    name: str
    kind: str
    owner: str  # owning config class or module
    doc: str  # repo-relative doc path that describes the switch
    description: str
    # Default *as read* ("1" = on unless explicitly disabled). Only
    # meaningful for env kinds; constants have no runtime default.
    default: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"Unknown switch kind {self.kind!r} for {self.name}.")
        if self.kind == "constant":
            if not self.name.startswith("VIZIER_"):
                raise ValueError(f"Constant {self.name!r} must start with VIZIER_.")
        elif not self.name.startswith(PREFIX):
            raise ValueError(f"Switch {self.name!r} must start with {PREFIX}.")


def _switch(name, kind, owner, description, default=""):
    return EnvSwitch(name, kind, owner, DOC, description, default)


SWITCHES: Tuple[EnvSwitch, ...] = (
    # -- observability (ObservabilityConfig) -------------------------------
    _switch("VIZIER_TORCH_OBSERVABILITY", "flag", "ObservabilityConfig",
            "Master switch for tracing, metrics and device-phase timing.", "1"),
    _switch("VIZIER_TORCH_OBSERVABILITY_TRACING", "flag", "ObservabilityConfig",
            "Span tracing on/off (counters stay).", "1"),
    _switch("VIZIER_TORCH_OBSERVABILITY_METRICS", "flag", "ObservabilityConfig",
            "Latency histograms on/off.", "1"),
    _switch("VIZIER_TORCH_OBSERVABILITY_JAX", "flag", "ObservabilityConfig",
            "Designer device-phase timers on CUDA events (each phase waits "
            "for its end event). The name keeps the JAX package's knob.", "1"),
    _switch("VIZIER_TORCH_OBSERVABILITY_SPAN_BUFFER", "int", "ObservabilityConfig",
            "Finished-span ring-buffer size.", "4096"),
    _switch("VIZIER_TORCH_OBSERVABILITY_SPAN_LOG", "str", "ObservabilityConfig",
            "JSON-lines span sink path ('' = ring only)."),
    # -- SLO engine (SloConfig) --------------------------------------------
    _switch("VIZIER_TORCH_SLO", "flag", "SloConfig",
            "Arm the SLO engine: sliding-window error-budget burn rates and "
            "breach handling (opt-in).", "0"),
    _switch("VIZIER_TORCH_SLO_WINDOWS", "str", "SloConfig",
            "Comma-separated sliding windows in seconds.", "60,300"),
    _switch("VIZIER_TORCH_SLO_EVAL_INTERVAL_S", "float", "SloConfig",
            "Background evaluation cadence (0 = manual evaluate() only).", "1.0"),
    _switch("VIZIER_TORCH_SLO_SUGGEST_P99_MS", "float", "SloConfig",
            "Objective: 99% of suggests per hop under this many ms.", "5000.0"),
    _switch("VIZIER_TORCH_SLO_SPECULATIVE_HIT_RATE", "float", "SloConfig",
            "Objective: minimum speculative serve hit rate.", "0.8"),
    _switch("VIZIER_TORCH_SLO_FALLBACK_RATE", "float", "SloConfig",
            "Objective: maximum quasi-random fallback fraction.", "0.05"),
    _switch("VIZIER_TORCH_SLO_SHED_RATE", "float", "SloConfig",
            "Objective: maximum admission-shed fraction of suggests.", "0.05"),
    _switch("VIZIER_TORCH_SLO_DUMP_DIR", "str", "SloConfig",
            "Black-box dump directory for SLO breaches ('' = no dumps)."),
    # -- flight recorder (FlightRecorderConfig) ----------------------------
    _switch("VIZIER_TORCH_FLIGHT_RECORDER", "flag", "FlightRecorderConfig",
            "Per-study flight recorder of lifecycle events (opt-in).", "0"),
    _switch("VIZIER_TORCH_FLIGHT_RECORDER_RING", "int", "FlightRecorderConfig",
            "Events kept per study ring.", "256"),
    _switch("VIZIER_TORCH_FLIGHT_RECORDER_STUDIES", "int", "FlightRecorderConfig",
            "Study rings kept (least recently used evicted past this).", "1024"),
    _switch("VIZIER_TORCH_OBS_DUMP_DIR", "str", "replica_main",
            "Per-replica observability dump directory, written on shutdown."),
    # -- reliability (ReliabilityConfig) -----------------------------------
    _switch("VIZIER_TORCH_RELIABILITY", "flag", "ReliabilityConfig",
            "Master switch for retries, deadlines, breaker and fallback.", "1"),
    _switch("VIZIER_TORCH_RELIABILITY_RETRIES", "flag", "ReliabilityConfig",
            "Retry transient RPC/op failures.", "1"),
    _switch("VIZIER_TORCH_RELIABILITY_DEADLINE", "flag", "ReliabilityConfig",
            "Deadline attachment and propagation.", "1"),
    _switch("VIZIER_TORCH_RELIABILITY_BREAKER", "flag", "ReliabilityConfig",
            "Per-study circuit breaker.", "1"),
    _switch("VIZIER_TORCH_RELIABILITY_FALLBACK", "flag", "ReliabilityConfig",
            "Quasi-random fallback on designer failure.", "1"),
    # -- admission (serving.admission.AdmissionConfig) ---------------------
    _switch("VIZIER_TORCH_ADMISSION", "flag", "AdmissionConfig",
            "Multi-tenant overload protection (opt-in).", "0"),
    _switch("VIZIER_TORCH_ADMISSION_MAX_INFLIGHT", "int", "AdmissionConfig",
            "Fleet-wide cap on concurrent designer computations.", "16"),
    _switch("VIZIER_TORCH_ADMISSION_TENANT_INFLIGHT", "int", "AdmissionConfig",
            "Per-tenant cap on concurrent designer computations.", "8"),
    _switch("VIZIER_TORCH_ADMISSION_WEIGHTS", "str", "AdmissionConfig",
            "Fair-share weights, 'tenant:w,...' (unlisted tenants = 1.0)."),
    _switch("VIZIER_TORCH_ADMISSION_RETRY_AFTER_MS", "float", "AdmissionConfig",
            "Backoff-floor hint stamped into shed errors.", "50"),
    _switch("VIZIER_TORCH_ADMISSION_DEADLINE", "flag", "AdmissionConfig",
            "Deadline-aware rejection.", "1"),
    _switch("VIZIER_TORCH_ADMISSION_DEGRADED", "flag", "AdmissionConfig",
            "Graceful degradation under sustained saturation.", "1"),
    _switch("VIZIER_TORCH_ADMISSION_DEGRADED_FLOOR", "float", "AdmissionConfig",
            "Tenants with weight below this serve quasi-random when degraded.",
            "1.0"),
    _switch("VIZIER_TORCH_ADMISSION_DEGRADE_RATE", "float", "AdmissionConfig",
            "Windowed shed rate at which SHEDDING escalates to DEGRADED.", "0.5"),
    _switch("VIZIER_TORCH_ADMISSION_RECOVER_RATE", "float", "AdmissionConfig",
            "Windowed shed rate below which DEGRADED may recover.", "0.1"),
    _switch("VIZIER_TORCH_ADMISSION_WINDOW_S", "float", "AdmissionConfig",
            "Sliding decision window for the overload state machine.", "5.0"),
    # -- serving (ServingConfig) -------------------------------------------
    _switch("VIZIER_TORCH_SERVING_CACHE", "flag", "ServingConfig",
            "Per-study designer-state cache.", "1"),
    _switch("VIZIER_TORCH_SERVING_WARM_START", "flag", "ServingConfig",
            "Warm-started ARD training.", "1"),
    _switch("VIZIER_TORCH_SERVING_COALESCING", "flag", "ServingConfig",
            "Compute-level request coalescing.", "1"),
    _switch("VIZIER_TORCH_BATCHING", "flag", "ServingConfig",
            "Cross-study batch executor.", "1"),
    _switch("VIZIER_TORCH_BATCH_MAX_SIZE", "int", "ServingConfig",
            "Studies per flush at most.", "8"),
    _switch("VIZIER_TORCH_BATCH_MAX_WAIT_MS", "float", "ServingConfig",
            "Flush window: a bucket's oldest slot waits at most this long.", "4.0"),
    _switch("VIZIER_TORCH_BATCHING_PREWARM", "flag", "ServingConfig",
            "Prewarm a search space's buckets (kernel library, one flush per "
            "bucket, count and batch size, capturing its CUDA graphs) when "
            "its first study arrives.", "0"),
    _switch("VIZIER_TORCH_COMPILE_CACHE_DIR", "str", "ServingConfig",
            "Directory the CUDA kernel library is built into and reused from "
            "across processes ('' = build/ beside the package)."),
    # -- fleet (DistributedConfig, StudyRouter, replica_main) --------------
    _switch("VIZIER_TORCH_DISTRIBUTED", "flag", "DistributedConfig",
            "Study routing across replicas.", "1"),
    _switch("VIZIER_TORCH_DISTRIBUTED_REPLICAS", "int", "DistributedConfig",
            "Replica count.", "4"),
    _switch("VIZIER_TORCH_DISTRIBUTED_WAL_DIR", "str", "DistributedConfig",
            "Write-ahead-log root ('' = in-memory stores)."),
    _switch("VIZIER_TORCH_DISTRIBUTED_SNAPSHOT_INTERVAL", "int", "DistributedConfig",
            "WAL records between snapshots.", "256"),
    _switch("VIZIER_TORCH_DISTRIBUTED_WAL_FSYNC", "flag", "DistributedConfig",
            "fsync every WAL append.", "0"),
    _switch("VIZIER_TORCH_DISTRIBUTED_ROUTE_CACHE_SIZE", "int", "StudyRouter",
            "Routing decisions cached.", "65536"),
    _switch("VIZIER_TORCH_DISTRIBUTED_REPLICATION", "flag", "DistributedConfig",
            "Standby-log replication.", "1"),
    _switch("VIZIER_TORCH_DISTRIBUTED_REPLICATION_FACTOR", "int", "DistributedConfig",
            "Successors per study.", "2"),
    _switch("VIZIER_TORCH_DISTRIBUTED_REPLICATION_QUEUE", "int", "DistributedConfig",
            "Streamer queue bound (overflow costs a re-baseline).", "4096"),
    _switch("VIZIER_TORCH_DISTRIBUTED_REPLICATION_BATCH", "int", "DistributedConfig",
            "Records per delivery at most.", "64"),
    _switch("VIZIER_TORCH_DISTRIBUTED_LEASE_TIMEOUT_S", "float", "DistributedConfig",
            "Heartbeat lease timeout.", "3.0"),
    _switch("VIZIER_TORCH_DISTRIBUTED_HEARTBEAT_INTERVAL_S", "float", "DistributedConfig",
            "Heartbeat interval.", "1.0"),
    _switch("VIZIER_TORCH_NETCHAOS", "str", "replica_main",
            "Seeded per-link network fault schedule inside a replica."),
    _switch("VIZIER_TORCH_COMPUTE_TIER", "flag", "ComputeTierConfig",
            "Route GP compute to a shared compute server (opt-in).", "0"),
    _switch("VIZIER_TORCH_COMPUTE_TIER_ENDPOINT", "str", "ComputeTierConfig",
            "The compute server's host:port."),
    _switch("VIZIER_TORCH_COMPUTE_TIER_FALLBACK", "str", "ComputeTierConfig",
            "What a frontend does when the compute server is down.", "local"),
    _switch("VIZIER_TORCH_COMPUTE_TIER_HEALTH_INTERVAL_S", "float", "ComputeTierConfig",
            "Compute-server health probe interval.", "1.0"),
    # -- speculative pre-compute (SpeculativeConfig) -----------------------
    _switch("VIZIER_TORCH_SPECULATIVE", "flag", "SpeculativeConfig",
            "Speculative pre-compute of the next suggest (opt-in).", "0"),
    _switch("VIZIER_TORCH_SPECULATIVE_WORKERS", "int", "SpeculativeConfig",
            "Speculative worker threads.", "1"),
    _switch("VIZIER_TORCH_SPECULATIVE_MAX_AGE_S", "float", "SpeculativeConfig",
            "Oldest speculation served.", "300.0"),
    _switch("VIZIER_TORCH_SPECULATIVE_ON_FILL", "flag", "SpeculativeConfig",
            "Speculate when a study's pending suggestions are filled.", "0"),
    _switch("VIZIER_TORCH_SPECULATIVE_COUNT_MEMORY", "int", "SpeculativeConfig",
            "Recent request counts remembered per study.", "4"),
    _switch("VIZIER_TORCH_SPECULATIVE_DEBOUNCE_MS", "float", "SpeculativeConfig",
            "Debounce between completions and a speculative job.", "0"),
    # -- surrogates (SurrogateConfig) --------------------------------------
    _switch("VIZIER_TORCH_SPARSE", "flag", "SurrogateConfig",
            "Exact-to-sparse surrogate auto-switch.", "1"),
    _switch("VIZIER_TORCH_SPARSE_THRESHOLD", "int", "SurrogateConfig",
            "Trials at which a study goes sparse.", "512"),
    _switch("VIZIER_TORCH_SPARSE_HYSTERESIS", "int", "SurrogateConfig",
            "Trials below the threshold before a study goes exact again.", "64"),
    _switch("VIZIER_TORCH_SPARSE_INDUCING", "int", "SurrogateConfig",
            "Inducing points of the sparse surrogate.", "128"),
    _switch("VIZIER_TORCH_SPARSE_UCB_PE", "flag", "SurrogateConfig",
            "Sparse surrogate for the UCB-PE designer too.", "1"),
    # -- mesh execution plane (parallel.mesh.MeshConfig) -------------------
    _switch("VIZIER_TORCH_MESH", "flag", "MeshConfig",
            "Mesh execution plane: carve the host's devices into placements the "
            "batch executor schedules buckets over (0 = one scheduler thread; "
            "the loadgen overlay writes it).", "0"),
    _switch("VIZIER_TORCH_MESH_DEVICES", "int", "MeshConfig",
            "Devices the mesh plane may use (0 = all; capped at the host's count).", "0"),
    _switch("VIZIER_TORCH_MESH_SHARD_DEVICES", "int", "MeshConfig",
            "Devices per placement; > 1 splits each flush's study axis over them.", "1"),
    _switch("VIZIER_TORCH_MESH_COORDINATOR", "str", "MeshConfig",
            "torch.distributed (gloo) coordinator address host:port for a multi-host "
            "mesh ('' = single host)."),
    _switch("VIZIER_TORCH_MESH_PROCESSES", "int", "MeshConfig",
            "Process count of the multi-host mesh (its world size).", "0"),
    _switch("VIZIER_TORCH_MESH_PROCESS_ID", "int", "MeshConfig",
            "This process's rank in the multi-host mesh (-1 = unset).", "-1"),
    _switch("VIZIER_TORCH_DISABLE_MESH", "flag", "VizierGPBandit",
            "Opt out of the GP designers' auto-mesh over several devices.", "0"),
    # -- loadgen traffic engine (loadgen.models.ScenarioConfig) ------------
    _switch("VIZIER_TORCH_LOADGEN_SEED", "int", "ScenarioConfig",
            "Scenario seed: the whole workload expansion follows from it.", "0"),
    _switch("VIZIER_TORCH_LOADGEN_SCALE", "float", "ScenarioConfig",
            "Study-count multiplier for the configured scenario.", "1.0"),
    _switch("VIZIER_TORCH_LOADGEN_STUDIES", "int", "ScenarioConfig",
            "Base study count before scaling.", "64"),
    _switch("VIZIER_TORCH_LOADGEN_TARGET", "str", "ScenarioConfig",
            "Serving target: inprocess | replicas | subprocess.", "replicas"),
    _switch("VIZIER_TORCH_LOADGEN_EVENTS", "str", "ScenarioConfig",
            "Scripted event track, kind[:arg]@fraction entries."),
    # -- reserved constants (NOT environment variables) --------------------
    _switch("VIZIER_METHODS", "constant", "service.grpc_stubs",
            "gRPC method table constant in grpc_stubs; never an env var."),
    _switch("VIZIER_SERVICE_NAME", "constant", "service.grpc_stubs",
            "gRPC service name constant in grpc_stubs; never an env var."),
)

BY_NAME: Dict[str, EnvSwitch] = {s.name: s for s in SWITCHES}
if len(BY_NAME) != len(SWITCHES):  # pragma: no cover - declaration bug
    raise RuntimeError("Duplicate VIZIER_* switch declaration.")


def declared(name: str) -> bool:
    return name in BY_NAME


def env_switch_names() -> Tuple[str, ...]:
    """Declared names that are real environment switches (not constants)."""
    return tuple(s.name for s in SWITCHES if s.kind != "constant")


def render_doc() -> str:
    """The text of :data:`DOC`: one row per declared name."""
    lines = [
        "# The port's environment switches",
        "",
        "Generated from `vizier_tpu_torch/analysis/registry.py` by",
        "`python -c 'from vizier_tpu_torch.analysis import registry; "
        "print(registry.render_doc(), end=\"\")'`.",
        "Each switch is read through `vizier_tpu_torch/utils/env.py`, which",
        "raises on a name this table does not declare.",
        "",
        "| Name | Kind | Default | Owner | What it does |",
        "| --- | --- | --- | --- | --- |",
    ]
    for s in SWITCHES:
        default = f"`{s.default}`" if s.default else ""
        lines.append(f"| `{s.name}` | {s.kind} | {default} | {s.owner} | {s.description} |")
    return "\n".join(lines) + "\n"


def _require(name: str) -> EnvSwitch:
    switch = BY_NAME.get(name)
    if switch is None:
        raise KeyError(
            f"Undeclared environment switch {name!r}: declare it in "
            "vizier_tpu_torch/analysis/registry.py (and document it) first."
        )
    if switch.kind == "constant":
        raise KeyError(f"{name!r} is a reserved constant, not an environment switch.")
    return switch


def env_on(name: str, default: Optional[str] = None) -> bool:
    """Boolean switch read: unset -> declared default; "0"/"false"/"" = off."""
    switch = _require(name)
    base = switch.default if default is None else default
    return os.environ.get(name, base) not in ("0", "false", "False", "")


def env_set(name: str) -> bool:
    """True when the switch is set to a truthy value (unset -> False): the read
    of opt-out flags such as ``VIZIER_TORCH_DISABLE_MESH``."""
    return env_on(name, default="0")


def env_int(name: str, default: int) -> int:
    _require(name)
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    _require(name)
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    _require(name)
    return os.environ.get(name, default)
