"""ServingRuntime: one object bundling cache + coalescer + breakers + stats.

Counterpart of the JAX package's ``serving/runtime.py``. The Pythia servicer
owns one runtime per process; the policy factory and the serving policy
share it, so every counter lands in one place and study invalidation reaches
the real cache. The reliability layer (per-study circuit breakers and its
config) lives here too, so breaker transitions land in the same stats sink
and study invalidation drops the breaker along with the designer state. One
metrics registry backs the serving counters and the latency histograms
(cache lookups, coalescer waits, per-hop suggest latency).

The runtime owns the cross-study batch executor
(``parallel.batch_executor``) when batching is on, and the exact↔sparse
surrogate policy every GP designer the factory builds shares.

The JAX runtime's planes that are off by default are not ported: the
admission controller, the speculative pre-compute engine, the SLO engine,
the flight recorder, the mesh execution plane, the compilation cache and
compile prewarm. Asking for one raises.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from vizier_tpu_torch.observability import config as obs_config_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.parallel import batch_executor as batch_executor_lib
from vizier_tpu_torch.reliability import breaker as breaker_lib
from vizier_tpu_torch.reliability import config as reliability_config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.serving import coalescer as coalescer_lib
from vizier_tpu_torch.serving import config as config_lib
from vizier_tpu_torch.serving import designer_cache as cache_lib
from vizier_tpu_torch.serving import stats as stats_lib
from vizier_tpu_torch.surrogates import config as surrogate_config_lib
from vizier_tpu_torch.utils import env as env_lib

_logger = logging.getLogger(__name__)

_NOT_PORTED = ("speculative", "mesh", "slo", "admission")


@dataclasses.dataclass
class GuardedSuggestion:
    """What :meth:`ServingRuntime.guarded_suggest` served: the policy's
    decision, or stamped fallback suggestions, or the typed error that
    completes the operation."""

    decision: Any = None
    fallbacks: List[Any] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None


def refuse_flight_recorder() -> None:
    """Raises when ``VIZIER_TORCH_FLIGHT_RECORDER`` asks for the JAX
    package's flight recorder, a plane the port does not have (off by
    default there too)."""
    if env_lib.env_on("VIZIER_TORCH_FLIGHT_RECORDER", default="0"):
        raise NotImplementedError(
            "The flight recorder plane of the JAX package's serving runtime is not ported."
        )


class ServingRuntime:
    """Shared serving state for one Pythia process."""

    def __init__(
        self,
        config: Optional[config_lib.ServingConfig] = None,
        stats: Optional[stats_lib.ServingStats] = None,
        reliability: Optional[reliability_config_lib.ReliabilityConfig] = None,
        observability: Optional[obs_config_lib.ObservabilityConfig] = None,
        surrogates: Optional[surrogate_config_lib.SurrogateConfig] = None,
        **planes: Any,
    ):
        for name, value in planes.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Unknown ServingRuntime argument {name!r}.")
            if value is not None and getattr(value, "enabled", True):
                raise NotImplementedError(
                    f"The {name} plane of the JAX package's serving runtime is not ported."
                )
        refuse_flight_recorder()
        self.config = config or config_lib.ServingConfig.from_env()
        self.observability = observability or obs_config_lib.ObservabilityConfig.from_env()
        # The exact↔sparse auto-switch threaded into every GP designer the
        # policy factory builds.
        self.surrogates = surrogates or surrogate_config_lib.SurrogateConfig.from_env()
        self.stats = stats or stats_lib.ServingStats()
        self.metrics: metrics_lib.MetricsRegistry = self.stats.registry
        self.reliability = reliability or reliability_config_lib.ReliabilityConfig.from_env()
        self.designer_cache = cache_lib.DesignerStateCache(
            max_entries=self.config.cache_max_entries,
            ttl_seconds=self.config.cache_ttl_seconds,
            stats=self.stats,
            observe_latency=self.observability.metrics_on,
        )
        self.coalescer = coalescer_lib.RequestCoalescer(
            stats=self.stats,
            observe_latency=self.observability.metrics_on,
        )
        self.breakers = breaker_lib.CircuitBreakerRegistry(
            failure_threshold=self.reliability.breaker_failure_threshold,
            window_secs=self.reliability.breaker_window_secs,
            cooldown_secs=self.reliability.breaker_cooldown_secs,
            half_open_probes=self.reliability.breaker_half_open_probes,
            stats=self.stats,
        )
        self._suggest_latency = self.metrics.histogram(
            "vizier_suggest_latency_seconds",
            help="SuggestTrials wall time per hop (service, pythia).",
        )
        # Cross-study batch executor: concurrent same-bucket designer
        # computations share one batched program. None = batching off: the
        # per-study path.
        self.batch_executor: Optional[batch_executor_lib.BatchExecutor] = None
        if self.config.batching:
            self.batch_executor = batch_executor_lib.BatchExecutor(
                max_batch_size=self.config.batch_max_size,
                max_wait_ms=self.config.batch_max_wait_ms,
                pad_partial=self.config.batch_pad_partial,
                stats=self.stats,
                metrics=self.metrics if self.observability.metrics_on else None,
            )
        self._lock = threading.Lock()
        self._closed = False

    def shutdown(self) -> None:
        """Drains and stops the batch executor. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.batch_executor is not None:
            self.batch_executor.close()

    def guarded_suggest(
        self,
        study_name: str,
        compute: Callable[[], Any],
        fallback: Callable[[str], List[Any]],
        deadline: Optional[deadline_lib.Deadline] = None,
    ) -> GuardedSuggestion:
        """One designer computation behind the study's breaker and deadline.

        The JAX Pythia servicer's order, without protobuf: an open circuit
        skips ``compute`` and degrades; a budget already spent upstream
        returns the typed deadline error before dispatch (no breaker
        record); ``compute()`` runs; a budget spent by the computation, or an
        exception from it, counts against the breaker; an exception degrades
        to ``fallback(reason)``, seeded quasi-random suggestions stamped in
        their metadata. With fallback off, both degraded cases return the
        typed error instead.
        """
        reliability = self.reliability
        stats = self.stats
        deadline = deadline or deadline_lib.Deadline.none()
        breaker = self.breakers.get(study_name) if reliability.breaker_on else None

        # Open circuit: skip the designer computation entirely (it would
        # very likely fail and burn the client's budget) and degrade.
        if breaker is not None and not breaker.allow():
            stats.increment("breaker_short_circuits")
            tracing_lib.add_current_event("breaker.short_circuit", study=study_name)
            if reliability.fallback_on:
                return self._fallback(study_name, fallback, "circuit_open")
            return GuardedSuggestion(error=errors_lib.CircuitOpenError(
                errors_lib.mark_transient(
                    f"CIRCUIT_OPEN: breaker for study {study_name!r} is open; "
                    "designer computation skipped."
                )
            ))

        try:
            # Budget already burned upstream (queueing, transport): not a
            # designer failure, so no breaker record.
            deadline.check(f"suggest dispatch for {study_name!r}")
        except errors_lib.DeadlineExceededError as e:
            stats.increment("deadline_exceeded")
            tracing_lib.add_current_event("deadline.exceeded", at="dispatch")
            return GuardedSuggestion(error=e)

        try:
            decision = compute()
            # The over-budget computation completes the op with a typed
            # error: the client stopped waiting at its deadline, so
            # returning suggestions now would hand out trials nobody runs.
            # A chronically slow designer also counts against the breaker.
            deadline.check(f"suggest computation for {study_name!r}")
        except errors_lib.DeadlineExceededError as e:
            stats.increment("deadline_exceeded")
            tracing_lib.add_current_event("deadline.exceeded", at="computation")
            if breaker is not None:
                breaker.record_failure()
            return GuardedSuggestion(error=e)
        except Exception as e:
            _logger.warning("Pythia Suggest failed: %s", traceback.format_exc())
            stats.increment("designer_failures")
            tracing_lib.add_current_event("designer.failure", error_type=type(e).__name__)
            if breaker is not None:
                breaker.record_failure()
            if reliability.fallback_on:
                return self._fallback(study_name, fallback, f"designer_error:{type(e).__name__}")
            return GuardedSuggestion(error=e)

        if breaker is not None:
            breaker.record_success()
        return GuardedSuggestion(decision=decision)

    def _fallback(
        self, study_name: str, fallback: Callable[[str], List[Any]], reason: str
    ) -> GuardedSuggestion:
        """Graceful degradation: seeded quasi-random, stamped + counted."""
        try:
            suggestions = fallback(reason)
        except Exception as e:  # fallback itself failed: surface as transient
            _logger.warning("Quasi-random fallback failed: %s", traceback.format_exc())
            return GuardedSuggestion(error=errors_lib.TransientError(
                errors_lib.mark_transient(f"FALLBACK_FAILED ({reason}): {type(e).__name__}: {e}")
            ))
        self.stats.increment("fallbacks", len(suggestions))
        tracing_lib.add_current_event("fallback.served", reason=reason, count=len(suggestions))
        _logger.warning(
            "Serving %d quasi-random fallback suggestion(s) for %s (%s).",
            len(suggestions),
            study_name,
            reason,
        )
        return GuardedSuggestion(fallbacks=suggestions)

    def observe_suggest_latency(
        self, hop: str, seconds: float, trace_id: Optional[str] = None
    ) -> None:
        """Records one suggest's wall time at a hop (no-op when metrics are
        off). ``trace_id`` makes the observation an exemplar candidate."""
        if self.observability.metrics_on:
            self._suggest_latency.observe(seconds, trace_id=trace_id, hop=hop)

    def invalidate_study(self, study_name: str) -> bool:
        """Drops the study's designer state and breaker (study deleted)."""
        self.breakers.invalidate(study_name)
        return self.designer_cache.invalidate(study_name)

    def note_study_config(self, study_name: str, config_hash: str) -> bool:
        """Pins per-study serving state to one StudyConfig incarnation.

        Called by the servicer with every request's parsed-config hash. On a
        hash turnover (a study deleted and recreated through another
        frontend, whose ``DeleteStudy`` invalidation cannot reach this
        process, or a metadata update) everything trained against the
        previous incarnation (designer entry, breaker) is dropped so it is
        never served again. Returns True when a turnover was detected.
        """
        changed = self.designer_cache.note_config_hash(study_name, config_hash)
        if changed:
            # note_config_hash already dropped the designer entry itself.
            self.breakers.invalidate(study_name)
        return changed

    def snapshot(self) -> Dict[str, int]:
        """All counters plus the current cache/breaker population."""
        out = self.stats.snapshot()
        out["cached_studies"] = len(self.designer_cache)
        out["open_breakers"] = self.breakers.open_count()
        return out
