"""Seeded, deterministic traffic models for the loadgen engine.

The port's copy of the JAX package's ``loadgen/models.py``, the engine's
workload description language. Everything here is a pure function of the
scenario seed, so the same :class:`ScenarioConfig` always expands to the
same :class:`Scenario`, and to the same one the JAX package expands it to
(``tests/test_torch_loadgen.py`` holds the two bit for bit):

- **open-loop arrivals** — a (optionally bursty) Poisson process: study
  arrival times come from exponential inter-arrival draws whose rate is
  modulated by a square burst wave, the MLPerf-loadgen "server" shape
  (requests arrive whether or not the service is keeping up);
- **Zipf study sizes** — per-study trial budgets from a bounded power law
  (most studies tiny, a heavy tail of big ones — the fleet-paper regime,
  arXiv:2408.11527);
- **tenant mix** — weighted tenants stamped on every study, so per-tenant
  outcome tables fall out of the report;
- **program-kind mix** — drawn against ``compute/registry.py``: every
  registered :class:`DesignerProgram` kind (gp_bandit, gp_bandit_sparse,
  gp_ucb_pe, gp_ucb_pe_sparse) can be given traffic, next to the cheap
  ``random``/``quasi_random`` baseline kinds that dominate real fleets.
  Sparse kinds are realized by pre-seeding a study past the (scenario-
  scoped) sparse threshold; crossover studies straddle the threshold
  mid-run so the surrogate auto-switch boundary gets traffic too;
- **a scripted event track** — kill/revive replicas, chaos fault windows
  (via ``testing/chaos.py``), fired at deterministic completed-trial
  counts so a soak's fault schedule is part of its fingerprint.

The scenario :meth:`~Scenario.fingerprint` hashes the full expansion.
:meth:`ScenarioConfig.from_env` reads the port's ``VIZIER_TORCH_LOADGEN_*``
switches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from vizier_tpu_torch.utils import env as env_lib

# Kind → service algorithm string. The four GP kinds are the registered
# compute-IR program kinds (validated against compute/registry.py at
# scenario build); sparse variants are the same algorithms driven past the
# scenario's sparse threshold. ``random``/``quasi_random`` are the cheap
# baseline kinds that make up the bulk of a production mix.
KIND_TO_ALGORITHM: Dict[str, str] = {
    "random": "RANDOM_SEARCH",
    "quasi_random": "QUASI_RANDOM_SEARCH",
    "gp_bandit": "GAUSSIAN_PROCESS_BANDIT",
    "gp_bandit_sparse": "GAUSSIAN_PROCESS_BANDIT",
    "gp_ucb_pe": "DEFAULT",
    "gp_ucb_pe_sparse": "DEFAULT",
}
GP_KINDS = ("gp_bandit", "gp_bandit_sparse", "gp_ucb_pe", "gp_ucb_pe_sparse")
SPARSE_KINDS = ("gp_bandit_sparse", "gp_ucb_pe_sparse")

# Study owner segment per scenario tenant: owners/loadgen-{tenant}/... —
# ALSO the tenant id the admission plane sees (serving.admission.tenant_of
# reads the owner segment), so the loadgen driver maps scenario tenant names
# through this prefix when arming per-tenant weights and normalizes them
# back in controller snapshots.
TENANT_OWNER_PREFIX = "loadgen-"


def tenant_owner(tenant: str) -> str:
    return f"{TENANT_OWNER_PREFIX}{tenant}"


def owner_tenant(owner: str) -> str:
    """The scenario tenant for a study owner id (unknown owners pass
    through unchanged)."""
    if owner.startswith(TENANT_OWNER_PREFIX):
        return owner[len(TENANT_OWNER_PREFIX):]
    return owner

_TARGETS = ("inprocess", "replicas", "subprocess", "shared_compute")
_EVENT_KINDS = (
    "kill_replica",
    "revive_replica",
    "chaos_on",
    "chaos_off",
    # Disaggregated compute tier (target "shared_compute"):
    # kill_compute — SIGKILL the shared Pythia compute server; frontends
    #   must ride their local-Pythia fallback with zero lost studies.
    # revive_compute — respawn it (idempotent: the manager's health loop
    #   may already have brought it back).
    "kill_compute",
    "revive_compute",
    # Severity track (replica tiers with >= 3 replicas):
    # multi_kill — kill N replicas SIMULTANEOUSLY (arg = N, default 2);
    #   the fleet must fail all of them over in one sweep with zero lost
    #   studies (the concurrent-multi-failure path).
    # rolling_restart — kill → fail over → revive every replica in id
    #   order, one at a time, under live traffic (the epoch-fenced
    #   handback path); dead replicas are revived in the same sweep.
    # wal_corrupt — flip bytes mid-file in a replica's live wal.log
    #   (arg = replica id or owner:<study index>); a later restart must
    #   quarantine the suffix and recover the tail from standby logs.
    "multi_kill",
    "rolling_restart",
    "wal_corrupt",
)


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """Which opt-in serving planes a scenario arms (the env switches the
    driver patches around the run). ``gated_off()`` is the sequential-
    reference shape: every plane off, the bit-identical seed path."""

    batching: bool = True
    speculative: bool = True
    mesh: bool = False
    slo: bool = True
    recorder: bool = True
    # Multi-tenant overload protection (serving.admission): fair-share
    # admission + shedding + degradation. Off by default — it is the
    # plane the OVERLOAD_AB scenario A/Bs.
    admission: bool = False

    @classmethod
    def all_on(cls) -> "PlaneConfig":
        return cls(batching=True, speculative=True, mesh=True, slo=True)

    @classmethod
    def gated_off(cls) -> "PlaneConfig":
        return cls(
            batching=False,
            speculative=False,
            mesh=False,
            slo=False,
            recorder=False,
            admission=False,
        )

    def as_dict(self) -> Dict[str, bool]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """One scripted fleet event, fired when the global completed-trial
    count reaches ``at_completed`` (deterministic under any concurrency:
    the counter, not the wall clock, is the trigger)."""

    at_completed: int
    kind: str  # kill_replica | revive_replica | chaos_on | chaos_off
    # kill/revive: "owner:<study index>" (the replica owning that study,
    # resolved at fire time) or a literal replica id ("replica-1").
    arg: str = ""

    def __post_init__(self):
        if self.kind not in _EVENT_KINDS:
            raise ValueError(
                f"Unknown event kind {self.kind!r}; expected one of "
                f"{_EVENT_KINDS}."
            )

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class StudySpec:
    """One study's worth of traffic, fully determined by the scenario."""

    index: int
    name: str  # full study resource name
    tenant: str
    kind: str
    algorithm: str
    budget: int  # suggest→complete round-trips the loadgen driver runs
    preseed: int  # completed trials seeded before the first suggest
    arrival_s: float  # open-loop arrival offset from scenario start
    seed: int  # per-study seed: objective optimum + designer rng

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """The full workload description. Everything the engine does is a
    deterministic function of this config (see :func:`build_scenario`)."""

    name: str = "default"
    seed: int = 0
    num_studies: int = 64
    # Multiplies num_studies (the one-knob way to scale a named scenario
    # up to soak size or down to a CI smoke).
    scale: float = 1.0
    # inprocess: one VizierServicer + shared Pythia. replicas: an
    # N-replica ReplicaManager tier (WAL-backed) behind the routed stub.
    target: str = "replicas"
    replicas: int = 2
    dim: int = 2
    concurrency: int = 4  # virtual clients
    # -- open-loop arrivals ------------------------------------------------
    arrival_rate_per_s: float = 50.0
    burst_factor: float = 4.0  # burst-window rate multiplier
    burst_fraction: float = 0.25  # fraction of each period spent bursting
    burst_period_s: float = 20.0
    # 0 = arrival ORDER only (as fast as the fleet can drain); 1 = real-
    # time pacing; in between scales the schedule. With a nonzero scale
    # the loadgen driver runs OPEN-LOOP: a dedicated pacer releases each study at
    # its scheduled arrival instant on its own client thread, whether or
    # not the fleet is keeping up (the MLPerf-loadgen "server" shape) —
    # arrivals are never gated on a free worker.
    time_scale: float = 0.0
    # Safety cap on concurrently-running open-loop studies; a release that
    # would exceed it queues until one finishes (logged, not silent).
    open_loop_max_clients: int = 128
    # -- study sizes (bounded Zipf) ---------------------------------------
    zipf_alpha: float = 1.1
    min_trials: int = 1
    max_trials: int = 16
    # -- mixes -------------------------------------------------------------
    tenants: Tuple[Tuple[str, float], ...] = (
        ("prod", 8.0),
        ("batch", 3.0),
        ("dev", 1.0),
    )
    kind_mix: Tuple[Tuple[str, float], ...] = (
        ("random", 60.0),
        ("quasi_random", 12.0),
        ("gp_bandit", 1.0),
        ("gp_bandit_sparse", 1.0),
        ("gp_ucb_pe", 1.0),
        ("gp_ucb_pe_sparse", 1.0),
    )
    # Per-tenant kind-mix overrides ((tenant, kind_mix) pairs): studies of
    # an overridden tenant redraw their kind from that tenant's own mix
    # (seeded separately so the base expansion stream is undisturbed) —
    # how the hot-tenant preset makes one tenant compute-heavy while the
    # light tenants stay cheap.
    tenant_kinds: Tuple[Tuple[str, Tuple[Tuple[str, float], ...]], ...] = ()
    # -- surrogate boundary (scenario-scoped VIZIER_TORCH_SPARSE_* overrides)
    sparse_threshold: int = 8
    sparse_inducing: int = 8
    # Force at least one non-sparse GP study to cross the threshold
    # mid-run, so the surrogate-crossover boundary gets traffic.
    ensure_crossover: bool = True
    # -- designer economics (CI/CPU realism knobs) -------------------------
    acquisition_evals: int = 200  # 0 = designer default (the 75k sweep)
    ard_restarts: int = 0  # 0 = designer default
    ard_maxiter: int = 0  # 0 = designer default optimizer
    # Per-trial evaluation think time for GP studies (the window a real
    # evaluation gives the speculative pre-compute to land).
    think_time_s: float = 0.0
    # -- planes + events ---------------------------------------------------
    planes: PlaneConfig = dataclasses.field(default_factory=PlaneConfig)
    # () = the default track from :func:`default_event_track`; parsed
    # tracks come from VIZIER_TORCH_LOADGEN_EVENTS / --events.
    events: Tuple[EventSpec, ...] = ()
    chaos_fault_prob: float = 0.1  # transport-fault rate inside windows
    # -- admission plane (scenario-scoped VIZIER_TORCH_ADMISSION* overrides)
    # Applied only when ``planes.admission``; 0/empty = the switch default.
    admission_weights: Tuple[Tuple[str, float], ...] = ()
    admission_max_inflight: int = 0
    admission_tenant_inflight: int = 0
    admission_degraded_floor: float = 0.0
    admission_window_s: float = 0.0
    admission_retry_after_ms: float = 0.0
    # -- assertions --------------------------------------------------------
    parity_cohort: int = 8  # studies re-run on the sequential reference
    min_speculative_hits: int = 1
    min_hit_rate: float = 0.0
    max_fallback_rate: float = 0.25
    # Fleet shed-rate budget, asserted only while ``planes.admission`` is
    # armed (the default soak runs WITH admission and must not shed under
    # nominal load; the hot_tenant overload preset raises this to 1.0 —
    # shedding the hot tenant is its mechanism).
    max_shed_rate: float = 0.05
    parity_alpha: float = 0.05
    p99_budget_ms: float = 120000.0  # VIZIER_TORCH_SLO_SUGGEST_P99_MS objective

    def __post_init__(self):
        if self.target not in _TARGETS:
            raise ValueError(
                f"Unknown target {self.target!r}; expected one of {_TARGETS}."
            )
        if self.min_trials < 1 or self.max_trials < self.min_trials:
            raise ValueError(
                "Need 1 <= min_trials <= max_trials, got "
                f"[{self.min_trials}, {self.max_trials}]."
            )
        if not self.kind_mix:
            raise ValueError("kind_mix must not be empty.")
        unknown = [k for k, _ in self.kind_mix if k not in KIND_TO_ALGORITHM]
        for _tenant, mix in self.tenant_kinds:
            unknown.extend(k for k, _ in mix if k not in KIND_TO_ALGORITHM)
        if unknown:
            raise ValueError(
                f"Unknown traffic kinds {unknown}; known kinds: "
                f"{sorted(KIND_TO_ALGORITHM)}."
            )

    @property
    def total_studies(self) -> int:
        return max(1, int(round(self.num_studies * self.scale)))

    @classmethod
    def from_env(cls, **overrides) -> "ScenarioConfig":
        """The env-driven scenario (``VIZIER_TORCH_LOADGEN_*``): seed, scale,
        study count, target, and event track, on top of the defaults.
        Explicit ``overrides`` win over the environment."""
        values: Dict[str, object] = dict(
            seed=env_lib.env_int("VIZIER_TORCH_LOADGEN_SEED", 0),
            scale=env_lib.env_float("VIZIER_TORCH_LOADGEN_SCALE", 1.0),
            num_studies=env_lib.env_int("VIZIER_TORCH_LOADGEN_STUDIES", 64),
            target=env_lib.env_str("VIZIER_TORCH_LOADGEN_TARGET", "replicas"),
        )
        track = env_lib.env_str("VIZIER_TORCH_LOADGEN_EVENTS")
        values.update(overrides)
        config = cls(**values)
        if track and "events" not in overrides:
            config = dataclasses.replace(
                config, events=parse_event_track(track, config)
            )
        return config

    def as_dict(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        out["planes"] = self.planes.as_dict()
        out["events"] = [e.as_dict() for e in self.events]
        out["total_studies"] = self.total_studies
        return out


# -- seeded samplers -------------------------------------------------------


def zipf_budgets(
    rng: random.Random, count: int, *, alpha: float, lo: int, hi: int
) -> List[int]:
    """Bounded Zipf draws: P(k) ∝ k^-alpha over [lo, hi], inverse-CDF
    sampled from ``rng`` (deterministic, no numpy dependency)."""
    support = list(range(lo, hi + 1))
    weights = [k ** -alpha for k in support]
    total = sum(weights)
    cumulative, acc = [], 0.0
    for w in weights:
        acc += w / total
        cumulative.append(acc)
    out = []
    for _ in range(count):
        u = rng.random()
        # First bucket whose CDF covers u (support is small: linear scan).
        for k, c in zip(support, cumulative):
            if u <= c:
                out.append(k)
                break
        else:  # float-roundoff tail
            out.append(hi)
    return out


def weighted_choice(
    rng: random.Random, pairs: Sequence[Tuple[str, float]]
) -> str:
    total = sum(w for _, w in pairs)
    u = rng.random() * total
    acc = 0.0
    for name, w in pairs:
        acc += w
        if u <= acc:
            return name
    return pairs[-1][0]


def arrival_times(rng: random.Random, config: ScenarioConfig, count: int) -> List[float]:
    """Open-loop (optionally bursty) Poisson arrival offsets, seconds.

    The rate is a square wave: ``burst_factor`` × the base rate for the
    first ``burst_fraction`` of every ``burst_period_s``, the base rate
    otherwise — a thinning-free construction (the instantaneous rate at
    the current time drives each exponential draw), deterministic in the
    draw sequence.
    """
    times, t = [], 0.0
    base = max(1e-6, config.arrival_rate_per_s)
    for _ in range(count):
        in_burst = (
            config.burst_period_s > 0
            and (t % config.burst_period_s)
            < config.burst_fraction * config.burst_period_s
        )
        rate = base * (config.burst_factor if in_burst else 1.0)
        t += rng.expovariate(rate)
        times.append(t)
    return times


# -- scenario expansion ----------------------------------------------------


def registered_gp_kinds() -> Tuple[str, ...]:
    """The compute-IR program kinds the registry currently serves; the
    scenario build validates GP traffic kinds against this set so a mix
    can never silently name a program that no longer exists."""
    from vizier_tpu_torch.compute import registry as compute_registry

    return compute_registry.kinds()


class Scenario:
    """A fully expanded workload: study specs + events + objectives."""

    def __init__(
        self,
        config: ScenarioConfig,
        studies: List[StudySpec],
        events: Tuple[EventSpec, ...],
    ):
        self.config = config
        self.studies = studies
        self.events = events

    @property
    def total_trials(self) -> int:
        return sum(s.budget for s in self.studies)

    def kinds_present(self) -> List[str]:
        return sorted({s.kind for s in self.studies})

    def crossover_studies(self) -> List[StudySpec]:
        """Studies whose completed-trial count crosses the sparse
        threshold mid-run (surrogate auto-switch boundary traffic)."""
        threshold = self.config.sparse_threshold
        return [
            s
            for s in self.studies
            if s.kind in ("gp_bandit", "gp_ucb_pe")
            and s.preseed < threshold <= s.preseed + s.budget
        ]

    def parity_cohort(self) -> List[StudySpec]:
        """The studies re-run on the sequential reference arm: GP-heavy
        first (regret parity is about the designers, not random search),
        topped up with baseline studies, in index order."""
        gp = [s for s in self.studies if s.kind in GP_KINDS]
        rest = [s for s in self.studies if s.kind not in GP_KINDS]
        cohort = (gp + rest)[: max(1, self.config.parity_cohort)]
        return sorted(cohort, key=lambda s: s.index)

    # -- objectives --------------------------------------------------------

    def optimum(self, spec: StudySpec) -> List[float]:
        rng = random.Random((spec.seed << 8) ^ 0x5EED)
        return [rng.uniform(0.2, 0.8) for _ in range(self.config.dim)]

    def objective(self, spec: StudySpec, parameters: Dict[str, float]) -> float:
        """Seeded sphere (maximize): 0 at the study's hidden optimum.
        Deterministic, so the engine arm and the sequential reference see
        identical objective feedback for identical suggestions."""
        opt = self.optimum(spec)
        return -sum(
            (float(parameters.get(f"x{d}", 0.0)) - opt[d]) ** 2
            for d in range(self.config.dim)
        )

    def preseed_points(
        self, spec: StudySpec
    ) -> List[Tuple[Dict[str, float], float]]:
        """The completed trials seeded before the study's first suggest
        (what pushes sparse-kind studies past the threshold)."""
        rng = random.Random((spec.seed << 8) ^ 0xF00D)
        points = []
        for _ in range(spec.preseed):
            params = {
                f"x{d}": rng.uniform(0.0, 1.0) for d in range(self.config.dim)
            }
            points.append((params, self.objective(spec, params)))
        return points

    # -- provenance --------------------------------------------------------

    def as_dict(self) -> Dict[str, object]:
        return {
            "config": self.config.as_dict(),
            "studies": [s.as_dict() for s in self.studies],
            "events": [e.as_dict() for e in self.events],
        }

    def fingerprint(self) -> str:
        """sha256 over the full deterministic expansion (specs, arrival
        times, events): the identity a soak report stamps and the
        determinism tests pin."""
        payload = json.dumps(self.as_dict(), sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()

    def summary(self) -> Dict[str, object]:
        by_kind: Dict[str, int] = {}
        by_tenant: Dict[str, int] = {}
        for s in self.studies:
            by_kind[s.kind] = by_kind.get(s.kind, 0) + 1
            by_tenant[s.tenant] = by_tenant.get(s.tenant, 0) + 1
        budgets = sorted(s.budget for s in self.studies)
        return {
            "studies": len(self.studies),
            "total_trials": self.total_trials,
            "studies_by_kind": dict(sorted(by_kind.items())),
            "studies_by_tenant": dict(sorted(by_tenant.items())),
            "trial_budget": {
                "min": budgets[0],
                "p50": budgets[len(budgets) // 2],
                "max": budgets[-1],
            },
            "crossover_studies": [s.index for s in self.crossover_studies()],
            "events": [e.as_dict() for e in self.events],
            "last_arrival_s": round(self.studies[-1].arrival_s, 4)
            if self.studies
            else 0.0,
        }


def default_event_track(
    config: ScenarioConfig, total_trials: int
) -> Tuple[EventSpec, ...]:
    """The canonical fleet track.

    2-replica tiers keep the original shape: kill the owner of study 0 at
    ~40% of the trial volume, revive it at ~70%, chaos window over the
    middle decile. Tiers with >= 3 replicas get the SEVERITY track
    instead: a 2-simultaneous ``multi_kill`` at ~35%, a mid-file
    ``wal_corrupt`` of study 0's (post-failover) owner at ~45%, and a
    ``rolling_restart`` of the whole fleet at ~75% — which also revives
    the multi-kill victims and forces the corrupted replica through
    quarantine + standby recovery. Kill/revive only make sense on the
    replica tier."""
    events: List[EventSpec] = []
    if config.chaos_fault_prob > 0:
        events.append(
            EventSpec(max(1, int(total_trials * 0.50)), "chaos_on")
        )
        events.append(
            EventSpec(max(2, int(total_trials * 0.60)), "chaos_off")
        )
    if config.target == "replicas" and config.replicas >= 3:
        events.append(
            EventSpec(max(1, int(total_trials * 0.35)), "multi_kill", "2")
        )
        events.append(
            EventSpec(
                max(2, int(total_trials * 0.45)), "wal_corrupt", "owner:0"
            )
        )
        events.append(
            EventSpec(max(3, int(total_trials * 0.75)), "rolling_restart")
        )
    elif config.target == "replicas" and config.replicas >= 2:
        events.append(
            EventSpec(max(1, int(total_trials * 0.40)), "kill_replica", "owner:0")
        )
        events.append(
            EventSpec(max(2, int(total_trials * 0.70)), "revive_replica", "owner:0")
        )
    if config.target == "shared_compute":
        # The tier's own severity arc: crash the shared compute server
        # mid-run (frontends degrade to local Pythia, zero lost studies),
        # then bring it back under live traffic.
        events.append(
            EventSpec(max(1, int(total_trials * 0.40)), "kill_compute")
        )
        events.append(
            EventSpec(max(2, int(total_trials * 0.70)), "revive_compute")
        )
    return tuple(sorted(events, key=lambda e: (e.at_completed, e.kind)))


def parse_event_track(track: str, config: ScenarioConfig) -> Tuple[EventSpec, ...]:
    """Parses ``VIZIER_TORCH_LOADGEN_EVENTS`` / ``--events``.

    Comma-separated ``kind[:arg]@fraction`` entries, fractions of the
    total trial volume, e.g.::

        kill_replica:owner:0@0.4,revive_replica:owner:0@0.7,chaos_on@0.5,chaos_off@0.6
    """
    scenario = build_scenario(dataclasses.replace(config, events=()))
    total = max(1, scenario.total_trials)
    events = []
    for entry in track.split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, _, frac = entry.rpartition("@")
        if not head:
            raise ValueError(f"Event entry {entry!r} needs kind@fraction.")
        kind, _, arg = head.partition(":")
        at = max(1, int(math.floor(float(frac) * total)))
        events.append(EventSpec(at, kind, arg))
    return tuple(sorted(events, key=lambda e: (e.at_completed, e.kind)))


def build_scenario(config: ScenarioConfig) -> Scenario:
    """Expands a config into the deterministic workload.

    One master ``random.Random(config.seed)`` drives every draw in a
    fixed order (budgets → kinds → tenants → arrivals → per-study seeds),
    so the expansion is reproducible independent of anything the loadgen driver
    later does with it.
    """
    gp_kinds_in_mix = [
        k for k, _ in config.kind_mix if k in GP_KINDS
    ]
    if gp_kinds_in_mix:
        registered = set(registered_gp_kinds())
        missing = [k for k in gp_kinds_in_mix if k not in registered]
        if missing:
            raise ValueError(
                f"kind_mix names unregistered program kinds {missing}; "
                f"registry serves {sorted(registered)}."
            )

    rng = random.Random(config.seed)
    count = config.total_studies
    budgets = zipf_budgets(
        rng,
        count,
        alpha=config.zipf_alpha,
        lo=config.min_trials,
        hi=config.max_trials,
    )
    kinds = [weighted_choice(rng, config.kind_mix) for _ in range(count)]
    # Guarantee every kind in the mix gets at least one study (a small
    # smoke must still cover all registered program kinds): overwrite the
    # tail with one study per missing kind, deterministically.
    mix_kinds = [k for k, w in config.kind_mix if w > 0]
    missing = [k for k in mix_kinds if k not in kinds]
    for offset, kind in enumerate(missing):
        kinds[count - 1 - offset] = kind
    tenants = [weighted_choice(rng, config.tenants) for _ in range(count)]
    if config.tenant_kinds:
        # Per-tenant kind overrides redraw from a DERIVED stream so the
        # base expansion (budgets/kinds/tenants/arrivals/seeds) is
        # byte-identical with the override absent.
        override = {tenant: mix for tenant, mix in config.tenant_kinds}
        kind_rng = random.Random((config.seed << 1) ^ 0x7E4A47)
        for i in range(count):
            mix = override.get(tenants[i])
            if mix is not None:
                kinds[i] = weighted_choice(kind_rng, mix)
    arrivals = arrival_times(rng, config, count)
    study_seeds = [rng.randrange(1 << 31) for _ in range(count)]

    studies: List[StudySpec] = []
    for i in range(count):
        kind = kinds[i]
        preseed = 0
        if kind in SPARSE_KINDS:
            # Born sparse: seeded past the threshold before first suggest.
            preseed = config.sparse_threshold
        elif kind in GP_KINDS:
            # Exact GP studies still need a seeded frontier (a designer
            # with zero completed trials just quasi-randoms); two points
            # keeps them cheap and in one padding bucket.
            preseed = min(2, max(0, config.sparse_threshold - 1))
        name = (
            f"owners/{tenant_owner(tenants[i])}/studies/"
            f"{config.name}-{i:05d}-{kind}"
        )
        studies.append(
            StudySpec(
                index=i,
                name=name,
                tenant=tenants[i],
                kind=kind,
                algorithm=KIND_TO_ALGORITHM[kind],
                budget=budgets[i],
                preseed=preseed,
                arrival_s=round(arrivals[i], 6),
                seed=study_seeds[i],
            )
        )

    if config.ensure_crossover:
        # At least one exact-GP study must straddle the sparse threshold
        # so the crossover boundary gets traffic: stretch the budget of
        # the first candidate that does not already cross.
        threshold = config.sparse_threshold
        candidates = [
            s for s in studies if s.kind in ("gp_bandit", "gp_ucb_pe")
        ]
        if candidates and not any(
            s.preseed < threshold <= s.preseed + s.budget for s in candidates
        ):
            s = candidates[0]
            studies[s.index] = dataclasses.replace(
                s, budget=threshold - s.preseed + 1
            )

    events = config.events or default_event_track(
        config, sum(s.budget for s in studies)
    )
    return Scenario(config, studies, events)


def smoke_config(**overrides) -> ScenarioConfig:
    """The seconds-scale CI scenario: every registered program kind gets
    exactly one tiny study next to a handful of random/quasi-random ones,
    on a 2-replica tier with one kill/revive — small enough for tier-1,
    full-stack enough to catch wiring regressions."""
    values: Dict[str, object] = dict(
        name="smoke",
        num_studies=8,
        max_trials=3,
        replicas=2,
        concurrency=2,
        sparse_threshold=4,
        sparse_inducing=4,
        acquisition_evals=50,
        ard_restarts=2,
        ard_maxiter=10,
        parity_cohort=4,
        chaos_fault_prob=0.0,
        kind_mix=(
            ("random", 3.0),
            ("quasi_random", 1.0),
            ("gp_bandit", 1.0),
            ("gp_bandit_sparse", 1.0),
            ("gp_ucb_pe", 1.0),
            ("gp_ucb_pe_sparse", 1.0),
        ),
        planes=PlaneConfig(
            batching=True, speculative=False, mesh=False, slo=True
        ),
    )
    values.update(overrides)
    return ScenarioConfig(**values)


def hot_tenant_config(**overrides) -> ScenarioConfig:
    """The overload scenario: one tenant with Zipf-head weight floods the
    fleet with GP compute at a saturating open-loop rate while three
    light tenants run occasional GP studies — the traffic shape where a
    serving tier without admission control collapses for everyone.

    Open-loop on purpose (``time_scale=1`` + real arrival pacing): the
    hot tenant's studies keep arriving whether or not the fleet drains,
    so suggest p99 measures queueing truthfully. The admission knobs
    (weights, caps, floor) describe the plane the ON arm arms; the OFF
    arm runs the identical workload with ``planes.admission=False``
    (the JAX package's overload A/B tool drives both).
    """
    values: Dict[str, object] = dict(
        name="hot_tenant",
        num_studies=28,
        min_trials=3,
        max_trials=3,
        target="inprocess",
        replicas=1,
        dim=2,
        concurrency=8,
        # Saturating open-loop arrivals: everything lands inside a few
        # seconds of real time, faster than the ~80 ms default-sweep GP
        # computes drain on one core (load ≈ 3).
        arrival_rate_per_s=12.0,
        burst_factor=1.0,
        time_scale=1.0,
        # One Zipf-head tenant, three light ones: ~4/5 of studies are hot.
        tenants=(
            ("hot", 12.0),
            ("light-a", 1.0),
            ("light-b", 1.0),
            ("light-c", 1.0),
        ),
        # The hot tenant is compute-heavy (all GP); light tenants mix one
        # GP study into cheap baseline traffic.
        kind_mix=(("random", 2.0), ("gp_bandit", 1.0)),
        tenant_kinds=(("hot", (("gp_bandit", 1.0),)),),
        sparse_threshold=64,  # stay exact: the A/B is about admission
        # Designer DEFAULTS (the production 75k-candidate sweep + full
        # ARD budget): the realistic heavy compute the hot tenant floods
        # the fleet with (~80 ms warm on 1-core CPU).
        acquisition_evals=0,
        ard_restarts=0,
        ard_maxiter=0,
        chaos_fault_prob=0.0,
        parity_cohort=4,
        max_fallback_rate=1.0,  # degraded-mode serves ARE the mechanism
        max_shed_rate=1.0,  # shedding the hot tenant IS the mechanism
        planes=PlaneConfig(
            batching=True,
            speculative=False,
            mesh=False,
            slo=True,
            recorder=True,
            admission=True,
        ),
        events=(),
        # The plane under test: light tenants outrank the hot one, whose
        # sub-floor weight routes it to quasi-random under degradation.
        admission_weights=(
            ("hot", 0.5),
            ("light-a", 4.0),
            ("light-b", 4.0),
            ("light-c", 4.0),
        ),
        # Headroom above the sum of plausible light-tenant concurrency so
        # the TOTAL cap never sheds a light tenant; the hot tenant's own
        # cap binds long before it.
        admission_max_inflight=12,
        admission_tenant_inflight=3,
        admission_degraded_floor=1.0,
        # Fast decisions under a seconds-scale flood: degrade within ~1 s
        # of sustained sheds, and pace shed retries widely enough
        # (6 attempts x >= 250 ms) that hot studies survive into the
        # degraded serve instead of exhausting their retry budget.
        admission_window_s=1.0,
        admission_retry_after_ms=250.0,
        # Between the two arms' measured light-tenant p99 (ON ~150 ms,
        # OFF ~1.4-1.7 s on the 1-core container): the plane keeps light
        # tenants inside it, the collapse arm breaches it.
        p99_budget_ms=1000.0,
    )
    values.update(overrides)
    return ScenarioConfig(**values)


def soak_config(**overrides) -> ScenarioConfig:
    """The acceptance-scale scenario: ≥1000 Zipf-sized studies across all
    registered program kinds on a 3-replica tier, speculation + batching
    + mesh + SLO + ADMISSION armed, with the SEVERITY event track
    (2-simultaneous multi_kill + mid-file wal_corrupt + rolling_restart)
    plus the chaos fault window.

    Admission runs armed by default: the soak's
    nominal load must pass UNDER the overload-protection plane — the
    report gates assert the shed rate stays inside ``max_shed_rate`` and
    suggest p99 inside the SLO budget, so a regression that makes the
    plane shed healthy traffic (or a plane bypass that lets p99 collapse)
    fails the default soak, not just ``overload_ab``.
    """
    values: Dict[str, object] = dict(
        name="soak",
        num_studies=1000,
        max_trials=16,
        replicas=3,
        concurrency=8,
        sparse_threshold=8,
        sparse_inducing=8,
        acquisition_evals=100,
        ard_restarts=2,
        ard_maxiter=10,
        think_time_s=0.15,
        parity_cohort=10,
        planes=dataclasses.replace(PlaneConfig.all_on(), admission=True),
        # Nominal-load headroom: the closed-loop client pool (concurrency
        # 8) fits inside the fleet cap, and per-tenant caps sit above any
        # single tenant's plausible concurrency — a shed under this
        # scenario is a plane regression, not load.
        admission_max_inflight=16,
        admission_tenant_inflight=8,
        max_shed_rate=0.05,
    )
    values.update(overrides)
    return ScenarioConfig(**values)
