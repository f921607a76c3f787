"""Per-study circuit breaker over the designer computation.

A copy of the JAX package's ``reliability/breaker.py``. Each transition
lands on the active span, on the study's flight-recorder ring and in the
serving stats.

Classic closed → open → half-open automaton with a sliding failure window:
``failure_threshold`` designer failures within ``window_secs`` open the
circuit; while open, computations are short-circuited (the caller degrades
to fallback or a typed error instead of burning a designer run that will
very likely fail); after ``cooldown_secs`` the circuit half-opens and
admits ``half_open_probes`` probe computations — one success closes it, one
failure re-opens it.

Per *study*, not per process: one study whose designer state is wedged
(e.g. a GP train that NaNs on its particular history) must not poison
suggestions for every other study the process serves.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# transition-target state -> serving-stats counter
_TRANSITION_COUNTERS = {
    OPEN: "breaker_open_transitions",
    HALF_OPEN: "breaker_half_open_transitions",
    CLOSED: "breaker_close_transitions",
}


class CircuitBreaker:
    """One study's failure automaton (thread-safe)."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        window_secs: float = 60.0,
        cooldown_secs: float = 30.0,
        half_open_probes: int = 1,
        time_fn: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self._failure_threshold = max(1, failure_threshold)
        self._window_secs = window_secs
        self._cooldown_secs = cooldown_secs
        self._half_open_probes = max(1, half_open_probes)
        self._time_fn = time_fn
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures: Deque[float] = collections.deque()
        self._opened_at = 0.0
        self._probes_in_flight = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new_state: str) -> None:
        # Caller holds the lock; the callback runs inside it too (counter
        # increments only — keep it that way).
        old, self._state = self._state, new_state
        if self._on_transition is not None and old != new_state:
            self._on_transition(old, new_state)

    def allow(self) -> bool:
        """Whether a designer computation may start right now."""
        with self._lock:
            now = self._time_fn()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self._cooldown_secs:
                    return False
                self._transition(HALF_OPEN)
                self._probes_in_flight = 1
                return True
            # HALF_OPEN: admit a bounded number of concurrent probes.
            if self._probes_in_flight < self._half_open_probes:
                self._probes_in_flight += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
                self._probes_in_flight = 0
            self._failures.clear()

    def record_failure(self) -> None:
        with self._lock:
            now = self._time_fn()
            if self._state == HALF_OPEN:
                # The probe failed: straight back to open, fresh cooldown.
                self._transition(OPEN)
                self._opened_at = now
                self._probes_in_flight = 0
                self._failures.clear()
                return
            if self._state == OPEN:
                return  # a straggler admitted before opening; already open
            self._failures.append(now)
            while self._failures and now - self._failures[0] > self._window_secs:
                self._failures.popleft()
            if len(self._failures) >= self._failure_threshold:
                self._transition(OPEN)
                self._opened_at = now
                self._failures.clear()


class CircuitBreakerRegistry:
    """Per-study breakers sharing one config and one stats sink."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        window_secs: float = 60.0,
        cooldown_secs: float = 30.0,
        half_open_probes: int = 1,
        time_fn: Callable[[], float] = time.monotonic,
        stats=None,  # serving.ServingStats (duck-typed: .increment(name))
    ):
        self._kwargs = dict(
            failure_threshold=failure_threshold,
            window_secs=window_secs,
            cooldown_secs=cooldown_secs,
            half_open_probes=half_open_probes,
            time_fn=time_fn,
        )
        self._stats = stats
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _count_transition(self, study_name: str, old: str, new: str) -> None:
        if self._stats is not None:
            self._stats.increment(_TRANSITION_COUNTERS[new])
        # Transitions fire inside the suggest computation that tripped (or
        # probed) the breaker — stamp them on that span, and on the study's
        # flight-recorder ring (both leaf sinks). Lazy import: reliability
        # must stay importable without the serving stack.
        from vizier_tpu_torch.observability import flight_recorder as recorder_lib
        from vizier_tpu_torch.observability import tracing as tracing_lib

        tracing_lib.add_current_event(
            "breaker.transition", study=study_name, from_state=old, to_state=new
        )
        recorder_lib.get_recorder().record(
            study_name, "breaker_transition", from_state=old, to_state=new
        )

    def get(self, study_name: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(study_name)
            if breaker is None:
                breaker = CircuitBreaker(
                    on_transition=(
                        lambda old, new, _study=study_name: (
                            self._count_transition(_study, old, new)
                        )
                    ),
                    **self._kwargs,
                )
                self._breakers[study_name] = breaker
            return breaker

    def invalidate(self, study_name: str) -> bool:
        """Drops the study's breaker (study deleted / state reset)."""
        with self._lock:
            return self._breakers.pop(study_name, None) is not None

    def states(self) -> Dict[str, str]:
        """study -> breaker state, for observability snapshots."""
        # Snapshot the map under the registry lock, read each breaker's
        # state OUTSIDE it: b.state takes the breaker's own lock, and the
        # registry lock must stay map bookkeeping only (the runtime
        # lock-order cross-check flagged the nested read).
        with self._lock:
            breakers = list(self._breakers.items())
        return {name: b.state for name, b in breakers}

    def open_count(self) -> int:
        return sum(1 for s in self.states().values() if s != CLOSED)
