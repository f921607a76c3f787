"""Request coalescing: concurrent identical computations share one run.

A copy of the JAX package's ``serving/coalescer.py``.

The service already deduplicates at the *operation* level (an unfinished
op for the same client is returned as-is); this lifts deduplication to the
*compute* level: N concurrent suggest computations for the same study
state run ONE designer computation, and the result is fanned back out to
every waiter.

Correctness hinges on the key: callers must include everything the
computation depends on (study name, algorithm, ``max_trial_id``, count) so
only requests that would produce an identical answer coalesce. A request
arriving after the leader finished starts a fresh computation — results
are never cached beyond the in-flight window, only shared within it.

Observability: leader compute time and follower wait time land in the
``vizier_coalescer_wait_seconds{role=...}`` histogram; with tracing on, a
``span_name`` wraps the leader's computation in its own span and each
follower's active span links to it (so a coalesced trace shows *which*
computation actually served it).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple, TypeVar

from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.serving import stats as stats_lib

T = TypeVar("T")


def suggest_key(
    study_name: str, config_hash: str, algorithm: str, max_trial_id: int, count: int
) -> Tuple[Hashable, ...]:
    """The key ``PythiaServicer`` coalesces a suggest under: the study, its
    config incarnation (the StudySpec's hash), the algorithm, the trial
    frontier and the count. Only requests that would get an identical
    answer share it."""
    return ("suggest", study_name, config_hash, algorithm, int(max_trial_id), int(count))


class _Inflight:
    def __init__(self):
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.followers = 0
        # The leader's computation span context: followers link to it.
        self.leader_ctx: Optional[tracing_lib.SpanContext] = None


class RequestCoalescer:
    """Collapses concurrent calls with equal keys onto one computation."""

    def __init__(
        self,
        stats: Optional[stats_lib.ServingStats] = None,
        observe_latency: bool = True,
    ):
        self._stats = stats or stats_lib.ServingStats()
        self._lock = threading.Lock()
        self._inflight: Dict[Hashable, _Inflight] = {}
        registry = getattr(self._stats, "registry", None)
        self._wait_hist = (
            registry.histogram(
                "vizier_coalescer_wait_seconds",
                help="Coalescer wall time: role=leader is the shared "
                "computation, role=follower the wait for it.",
            )
            if observe_latency and registry is not None
            else None
        )

    def _observe(self, role: str, t0: float) -> None:
        if self._wait_hist is not None:
            self._wait_hist.observe(time.perf_counter() - t0, role=role)

    def coalesce(
        self,
        key: Hashable,
        compute: Callable[[], T],
        clone: Optional[Callable[[T], T]] = None,
        span_name: str = "",
    ) -> T:
        """Runs ``compute`` once per concurrent key; fans the result out.

        The first caller for a key becomes the leader and runs ``compute``;
        callers arriving while it is in flight block until it finishes and
        receive the same result (``clone`` applied for followers when the
        result is mutable — proto responses must not be shared across
        servicer threads). A leader's exception propagates to every waiter.
        """
        with self._lock:
            entry = self._inflight.get(key)
            if entry is not None:
                entry.followers += 1
                leader = False
            else:
                entry = _Inflight()
                self._inflight[key] = entry
                leader = True
        t0 = time.perf_counter()
        if not leader:
            entry.done.wait()
            self._observe("follower", t0)
            self._stats.increment("coalesced_requests")
            # Link the follower's active span (its own pythia.suggest) to
            # the computation that actually produced its answer.
            span = tracing_lib.get_tracer().current_span()
            if span is not None and entry.leader_ctx is not None:
                span.add_link(entry.leader_ctx, name="coalesced_leader")
                span.set_attribute("coalesced", True)
            if entry.error is not None:
                raise entry.error
            return clone(entry.result) if clone is not None else entry.result
        try:
            tracer = tracing_lib.get_tracer()
            if span_name and tracer.enabled:
                with tracer.span(span_name, coalescer_leader=True) as span:
                    entry.leader_ctx = span.context()
                    entry.result = compute()
            else:
                entry.result = compute()
        except BaseException as e:
            entry.error = e
            raise
        finally:
            self._observe("leader", t0)
            # Unregister BEFORE waking waiters: a new request arriving after
            # the computation finished must start fresh, not adopt a result
            # computed against stale study state. The counter update runs
            # outside the map lock (it takes the metrics lock; this mutex
            # stays a leaf of the serving lock graph).
            with self._lock:
                del self._inflight[key]
                had_followers = bool(entry.followers)
            if had_followers:
                self._stats.increment("coalesced_computations")
            entry.done.set()
        return entry.result

    def inflight_keys(self) -> Tuple[Hashable, ...]:
        with self._lock:
            return tuple(self._inflight)
