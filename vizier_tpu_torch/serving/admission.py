"""Multi-tenant overload protection: admission, shedding, degradation.

A copy of the JAX package's ``serving/admission.py``. It is applied at the
Pythia dispatch boundary, the last hop before a designer computation burns
device time, so that no single hot study or tenant can starve everyone
else:

- **per-tenant accounting** — the tenant id is the ``owners/{owner}``
  segment of the study resource name (:func:`tenant_of`), so it rides every
  request for free;
- **bounded in-flight admission** — a global cap plus a per-tenant cap on
  concurrent designer computations. A request over either cap is SHED with
  a typed ``TRANSIENT: RESOURCE_EXHAUSTED`` error carrying a
  ``retry_after_ms=`` hint that :class:`~vizier_tpu_torch.reliability.retry.
  RetryPolicy` honors as a backoff floor. **A shed is not a failure**: it
  never reaches the per-study circuit breaker and never burns a designer
  run;
- **deadline-aware rejection** — a request whose remaining
  ``deadline_secs`` cannot cover the estimated queue wait plus the compute
  p50 (from the live latency histogram) is shed immediately;
- **an overload state machine** — ``healthy → shedding → degraded`` over a
  sliding decision window. Under sustained saturation (windowed shed rate
  over ``degrade_rate``) the controller enters DEGRADED and serves
  *low-priority* tenants (weight below ``degraded_floor``) the seeded
  quasi-random fallback (stamped in trial metadata) while reserving GP
  compute for in-SLO tenants; recovery is hysteretic.

The same controller drives the batch executor's weighted fair share:
per-tenant weights feed the deficit-round-robin slot selection inside the
live lane (``parallel.batch_executor``), and the tenant travels from the
admission gate to the executor on a contextvar (:func:`tenant_scope`).

The clock is injectable (``time_fn``), so one scripted clock drives the
port's controller and the JAX package's to the same decisions. Everything
is opt-in: ``VIZIER_TORCH_ADMISSION=0`` (the default) builds no controller
— the serving path is the one without admission, bit for bit.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, Optional, Tuple

from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.utils import env as env_lib

# Overload states, in escalation order.
HEALTHY = "healthy"
SHEDDING = "shedding"
DEGRADED = "degraded"
_STATE_LEVEL = {HEALTHY: 0, SHEDDING: 1, DEGRADED: 2}

# Decision outcomes.
ADMIT = "admit"
SHED = "shed"
DEGRADE = "degrade"

# Shed reasons (the ``reason=`` token in the typed error, the metric
# label, and the snapshot key).
REASON_TOTAL = "inflight_total"
REASON_TENANT = "inflight_tenant"
REASON_DEADLINE = "deadline_infeasible"

# Trial-metadata stamp for degraded-mode quasi-random serves (next to the
# reliability fallback stamp, so degraded trials stay auditable).
ADMISSION_NAMESPACE = "admission"
ADMISSION_KEY = "degraded"
ADMISSION_VALUE = "quasi_random"

# The tenant the admission gate admitted on this thread of execution;
# the batch executor reads it for fair-share slot accounting.
_TENANT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "vizier_admission_tenant", default=None
)

DEFAULT_TENANT = "default"


def tenant_of(study_name: str) -> str:
    """The tenant id carried by a study resource name.

    The ``owners/{owner}`` segment (``owners/prod/studies/s1`` → ``prod``)
    — the same identity the loadgen tenant mix stamps and the rendezvous
    router hashes. Unparseable names fall into one shared default tenant
    rather than erroring: admission must never fail a request over a
    naming convention.
    """
    if study_name.startswith("owners/"):
        owner = study_name[len("owners/"):].split("/", 1)[0]
        if owner:
            return owner
    return DEFAULT_TENANT


def stamp_degraded(metadata) -> None:
    """``ns "admission": degraded=quasi_random`` on one suggestion's
    metadata, next to the reliability fallback stamp — degraded-mode serves
    stay auditable in trial metadata."""
    metadata.ns(ADMISSION_NAMESPACE)[ADMISSION_KEY] = ADMISSION_VALUE


def current_tenant() -> Optional[str]:
    """The tenant admitted on this thread (None outside an admission
    scope — e.g. speculative jobs, or with admission off)."""
    return _TENANT.get()


@contextlib.contextmanager
def tenant_scope(tenant: str):
    token = _TENANT.set(tenant)
    try:
        yield
    finally:
        _TENANT.reset(token)


class AdmissionShedError(errors_lib.TransientError):
    """A request refused by the admission controller (not a failure:
    carries the RESOURCE_EXHAUSTED + retry-after markers, and must never
    count against a study's circuit breaker)."""


def shed_error(
    tenant: str, reason: str, retry_after_ms: float
) -> AdmissionShedError:
    return AdmissionShedError(
        errors_lib.mark_transient(
            f"{errors_lib.RESOURCE_EXHAUSTED_MARKER}: admission shed "
            f"(tenant={tenant}, reason={reason}, "
            f"{errors_lib.RETRY_AFTER_KEY}{retry_after_ms:g})"
        )
    )


def _parse_weights(raw: str) -> Tuple[Tuple[str, float], ...]:
    """``"prod:8,batch:3,dev:1"`` → weight pairs (bad entries skipped)."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.rpartition(":")
        try:
            weight = float(value)
        except ValueError:
            continue
        if name and weight > 0:
            out.append((name, weight))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the overload-protection plane (``VIZIER_TORCH_ADMISSION*``).

    Off by default: the serving path with ``enabled=False`` is
    the path without admission, bit for bit (no controller object, no
    fair-share reordering, no tenant metric labels).
    """

    enabled: bool = False
    # Concurrent designer computations admitted fleet-wide / per tenant.
    max_inflight: int = 16
    tenant_inflight: int = 8
    # Fair-share weights ((tenant, weight) pairs); unlisted tenants get
    # weight 1.0. Weights drive BOTH the executor's deficit-round-robin
    # quantum and the degraded-mode priority split.
    weights: Tuple[Tuple[str, float], ...] = ()
    # The retry-after hint stamped into shed errors (RetryPolicy backoff
    # floor).
    retry_after_ms: float = 50.0
    # Deadline-aware rejection: shed when remaining deadline < estimated
    # queue wait + compute p50.
    deadline_shed: bool = True
    # Graceful degradation: under sustained saturation, serve tenants
    # with weight < degraded_floor the quasi-random fallback instead of
    # shedding or computing.
    degraded: bool = True
    degraded_floor: float = 1.0
    # State machine: windowed shed rate >= degrade_rate escalates
    # SHEDDING -> DEGRADED; rate <= recover_rate (with in-flight pressure
    # relieved) sustained for window_s de-escalates.
    degrade_rate: float = 0.5
    recover_rate: float = 0.1
    window_s: float = 5.0
    # Minimum windowed decisions before the state machine may escalate.
    min_decisions: int = 10

    def weight(self, tenant: str) -> float:
        for name, weight in self.weights:
            if name == tenant:
                return weight
        return 1.0

    def low_priority(self, tenant: str) -> bool:
        return self.weight(tenant) < self.degraded_floor

    @classmethod
    def from_env(cls) -> "AdmissionConfig":
        return cls(
            enabled=env_lib.env_on("VIZIER_TORCH_ADMISSION", default="0"),
            max_inflight=env_lib.env_int("VIZIER_TORCH_ADMISSION_MAX_INFLIGHT", 16),
            tenant_inflight=env_lib.env_int("VIZIER_TORCH_ADMISSION_TENANT_INFLIGHT", 8),
            weights=_parse_weights(env_lib.env_str("VIZIER_TORCH_ADMISSION_WEIGHTS")),
            retry_after_ms=env_lib.env_float("VIZIER_TORCH_ADMISSION_RETRY_AFTER_MS", 50.0),
            deadline_shed=env_lib.env_on("VIZIER_TORCH_ADMISSION_DEADLINE"),
            degraded=env_lib.env_on("VIZIER_TORCH_ADMISSION_DEGRADED"),
            degraded_floor=env_lib.env_float("VIZIER_TORCH_ADMISSION_DEGRADED_FLOOR", 1.0),
            degrade_rate=env_lib.env_float("VIZIER_TORCH_ADMISSION_DEGRADE_RATE", 0.5),
            recover_rate=env_lib.env_float("VIZIER_TORCH_ADMISSION_RECOVER_RATE", 0.1),
            window_s=env_lib.env_float("VIZIER_TORCH_ADMISSION_WINDOW_S", 5.0),
        )

    @classmethod
    def disabled(cls) -> "AdmissionConfig":
        return cls(enabled=False)

    def as_dict(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        out["weights"] = {name: weight for name, weight in self.weights}
        return out


@dataclasses.dataclass
class Decision:
    """One admission verdict. An ADMIT reserves an in-flight slot that
    the caller must release (use :meth:`AdmissionController.in_flight`)."""

    outcome: str  # ADMIT | SHED | DEGRADE
    tenant: str
    reason: str = ""
    retry_after_ms: float = 0.0
    state: str = HEALTHY

    @property
    def admitted(self) -> bool:
        return self.outcome == ADMIT

    def error(self) -> AdmissionShedError:
        return shed_error(self.tenant, self.reason, self.retry_after_ms)


class AdmissionController:
    """The fleet-wide admission gate + overload state machine.

    Thread model: one leaf lock guards the in-flight counts, the sliding
    decision window, and the state; stats/metric/recorder emissions run
    OUTSIDE it (metrics and the recorder are leaf locks), and the
    injected estimate callables (histogram p50, executor queue depth) are
    called before the lock is taken.
    """

    def __init__(
        self,
        config: AdmissionConfig,
        *,
        stats=None,  # serving.stats.ServingStats
        metrics=None,  # observability.metrics.MetricsRegistry
        recorder=None,  # observability.flight_recorder recorder
        compute_p50_fn: Optional[Callable[[], Optional[float]]] = None,
        queue_depth_fn: Optional[Callable[[], int]] = None,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self.config = config
        self._stats = stats
        self._recorder = recorder
        self._compute_p50 = compute_p50_fn
        self._queue_depth = queue_depth_fn
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._inflight: Dict[str, int] = {}
        self._inflight_total = 0
        # Sliding decision window: (monotonic time, was_shed) pairs.
        self._window: Deque[Tuple[float, bool]] = collections.deque(
            maxlen=4096
        )
        # Hysteresis anchor: the last instant the recovery condition did
        # NOT hold (recovery requires a full window_s of calm after it).
        self._last_pressure_t = time_fn()
        self._sheds_by_tenant: Dict[str, Dict[str, int]] = {}
        self._degraded_by_tenant: Dict[str, int] = {}
        self._admits_by_tenant: Dict[str, int] = {}
        self._transitions: list = []
        self._decisions_gauge = self._inflight_gauge = self._state_gauge = None
        if metrics is not None:
            self._decisions_gauge = metrics.counter(
                "vizier_admission_decisions",
                help="Admission verdicts by tenant and outcome.",
            )
            self._inflight_gauge = metrics.gauge(
                "vizier_admission_inflight",
                help="Admitted in-flight designer computations per tenant.",
            )
            self._state_gauge = metrics.gauge(
                "vizier_admission_state",
                help="Overload state (0 healthy, 1 shedding, 2 degraded).",
            )
            self._state_gauge.set(0.0)

    # -- introspection -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def weight(self, tenant: Optional[str]) -> float:
        """The fair-share weight for DRR quanta (None → default 1.0)."""
        if tenant is None:
            return 1.0
        return self.config.weight(tenant)

    def inflight(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    def shed_rate(self) -> float:
        """Windowed shed fraction (0.0 when the window is empty)."""
        now = self._time()
        with self._lock:
            self._trim_window_locked(now)
            if not self._window:
                return 0.0
            return sum(1 for _, shed in self._window if shed) / len(
                self._window
            )

    def snapshot(self) -> Dict[str, object]:
        """The JSON-ready controller state (soak reports, serving_stats)."""
        with self._lock:
            sheds = {
                tenant: dict(reasons)
                for tenant, reasons in sorted(self._sheds_by_tenant.items())
            }
            out = {
                "enabled": self.config.enabled,
                "state": self._state,
                "inflight": dict(sorted(self._inflight.items())),
                "admits_by_tenant": dict(sorted(self._admits_by_tenant.items())),
                "sheds_by_tenant": sheds,
                "degraded_by_tenant": dict(
                    sorted(self._degraded_by_tenant.items())
                ),
                "transitions": list(self._transitions),
            }
        out["shed_rate"] = self.shed_rate()
        out["total_sheds"] = sum(
            count
            for reasons in out["sheds_by_tenant"].values()
            for count in reasons.values()
        )
        return out

    # -- the decision --------------------------------------------------------

    def decide(
        self,
        tenant: str,
        *,
        deadline_secs: float = 0.0,
        study: str = "",
    ) -> Decision:
        """One admission verdict for a live designer computation.

        ``deadline_secs`` is the request's remaining wire budget (0 = no
        deadline, negative = already expired — the deadline layer rejects
        those before admission runs). ADMIT reserves the in-flight slot.
        """
        config = self.config
        # Estimate inputs come from foreign locks (histogram, executor):
        # read them before taking the controller lock.
        wait_estimate = None
        if config.deadline_shed and deadline_secs > 0:
            wait_estimate = self._estimate_wait_secs()
        now = self._time()
        decision: Optional[Decision] = None
        transition = None
        with self._lock:
            self._trim_window_locked(now)
            if (
                config.degraded
                and self._state == DEGRADED
                and config.low_priority(tenant)
            ):
                # Degraded mode: low-priority tenants skip the designer
                # entirely (quasi-random fallback at the caller) so the
                # remaining compute budget serves in-SLO tenants.
                decision = Decision(DEGRADE, tenant, state=self._state)
                self._degraded_by_tenant[tenant] = (
                    self._degraded_by_tenant.get(tenant, 0) + 1
                )
            elif (
                wait_estimate is not None
                and deadline_secs > 0
                and wait_estimate > deadline_secs
            ):
                decision = self._shed_locked(tenant, REASON_DEADLINE, now)
            elif self._inflight_total >= max(1, config.max_inflight):
                decision = self._shed_locked(tenant, REASON_TOTAL, now)
            elif self._inflight.get(tenant, 0) >= max(
                1, config.tenant_inflight
            ):
                decision = self._shed_locked(tenant, REASON_TENANT, now)
            else:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
                self._inflight_total += 1
                self._admits_by_tenant[tenant] = (
                    self._admits_by_tenant.get(tenant, 0) + 1
                )
                self._window.append((now, False))
                decision = Decision(ADMIT, tenant, state=self._state)
            transition = self._advance_state_locked(now)
        self._emit(decision, study, transition)
        return decision

    def release(self, decision: Decision) -> None:
        """Returns an ADMIT's in-flight slot (idempotence is the caller's
        job — use :meth:`in_flight`)."""
        if not decision.admitted:
            return
        with self._lock:
            remaining = self._inflight.get(decision.tenant, 0) - 1
            if remaining > 0:
                self._inflight[decision.tenant] = remaining
            else:
                self._inflight.pop(decision.tenant, None)
            self._inflight_total = max(0, self._inflight_total - 1)
        if self._inflight_gauge is not None:
            self._inflight_gauge.set(max(0, remaining), tenant=decision.tenant)

    @contextlib.contextmanager
    def in_flight(self, decision: Decision):
        """Holds the admitted slot for the compute's duration and exposes
        the tenant to the batch executor via the contextvar."""
        try:
            with tenant_scope(decision.tenant):
                yield decision
        finally:
            self.release(decision)

    # -- internals -----------------------------------------------------------

    def _estimate_wait_secs(self) -> Optional[float]:
        """Expected queue wait + compute time for a new live computation.

        ``compute_p50`` comes from the pythia-hop latency histogram;
        queued-ahead work adds one compute per expected flush the request
        must wait behind. None (no latency data yet) disables the
        deadline shed — conservative by construction.
        """
        p50 = self._compute_p50() if self._compute_p50 is not None else None
        if p50 is None or p50 <= 0:
            return None
        queued = self._queue_depth() if self._queue_depth is not None else 0
        # Queued live slots drain in flush-sized groups; each group ahead
        # costs roughly one compute p50.
        flushes_ahead = 1.0 + float(max(0, queued)) / 8.0
        return p50 * flushes_ahead

    def _shed_locked(self, tenant: str, reason: str, now: float) -> Decision:
        self._window.append((now, True))
        self._last_pressure_t = now
        per_tenant = self._sheds_by_tenant.setdefault(tenant, {})
        per_tenant[reason] = per_tenant.get(reason, 0) + 1
        return Decision(
            SHED,
            tenant,
            reason=reason,
            retry_after_ms=self.config.retry_after_ms,
            state=self._state,
        )

    def _trim_window_locked(self, now: float) -> None:
        horizon = now - max(0.1, self.config.window_s)
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    def _advance_state_locked(self, now: float):
        """The healthy → shedding → degraded automaton; returns the
        ``(old, new)`` transition or None."""
        config = self.config
        total = len(self._window)
        sheds = sum(1 for _, shed in self._window if shed)
        rate = sheds / total if total else 0.0
        pressured = self._inflight_total >= max(1, config.max_inflight)
        if rate > config.recover_rate or pressured:
            self._last_pressure_t = now
        calm_for = now - self._last_pressure_t
        old = self._state
        if old == HEALTHY:
            if sheds > 0:
                self._state = SHEDDING
        elif old == SHEDDING:
            if (
                config.degraded
                and total >= config.min_decisions
                and rate >= config.degrade_rate
            ):
                self._state = DEGRADED
            elif sheds == 0 and calm_for >= config.window_s:
                self._state = HEALTHY
        elif old == DEGRADED:
            if rate <= config.recover_rate and calm_for >= config.window_s:
                self._state = SHEDDING
        if self._state != old:
            self._last_pressure_t = now  # re-arm hysteresis on every move
            self._transitions.append(
                {"from": old, "to": self._state, "shed_rate": round(rate, 4)}
            )
            return (old, self._state)
        return None

    def _emit(self, decision: Decision, study: str, transition) -> None:
        """Stats/metrics/recorder updates, outside the controller lock."""
        stats = self._stats
        if stats is not None:
            if decision.outcome == SHED:
                stats.increment("admission_sheds")
                if decision.reason == REASON_DEADLINE:
                    stats.increment("admission_deadline_sheds")
            elif decision.outcome == DEGRADE:
                stats.increment("admission_degraded")
            if transition is not None:
                stats.increment("admission_transitions")
        if self._decisions_gauge is not None:
            self._decisions_gauge.inc(
                tenant=decision.tenant,
                outcome=(
                    f"shed_{decision.reason}"
                    if decision.outcome == SHED
                    else decision.outcome
                ),
            )
        if self._inflight_gauge is not None and decision.admitted:
            with self._lock:
                current = self._inflight.get(decision.tenant, 0)
            self._inflight_gauge.set(current, tenant=decision.tenant)
        if self._state_gauge is not None and transition is not None:
            self._state_gauge.set(float(_STATE_LEVEL[transition[1]]))
        recorder = self._recorder
        if recorder is not None and getattr(recorder, "enabled", False):
            if decision.outcome == SHED:
                recorder.record(
                    study or None,
                    "admission_shed",
                    tenant=decision.tenant,
                    reason=decision.reason,
                    retry_after_ms=decision.retry_after_ms,
                    state=decision.state,
                )
            elif decision.outcome == DEGRADE:
                recorder.record(
                    study or None,
                    "admission_degraded",
                    tenant=decision.tenant,
                )
            if transition is not None:
                recorder.record(
                    None,
                    "admission_state",
                    old=transition[0],
                    new=transition[1],
                )
