"""ServingRuntime: one object bundling cache + coalescer + breakers + stats.

Counterpart of the JAX package's ``serving/runtime.py``. The Pythia servicer
owns one runtime per process; the policy factory and the serving policy
share it, so every counter lands in one place and study invalidation reaches
the real cache. The reliability layer (per-study circuit breakers and its
config) lives here too, so breaker transitions land in the same stats sink
and study invalidation drops the breaker along with the designer state. One
metrics registry backs the serving counters and the latency histograms
(cache lookups, coalescer waits, per-hop suggest latency), all dumped
together by :meth:`prometheus_text`.

The runtime owns the cross-study batch executor
(``parallel.batch_executor``) when batching is on, and the exact↔sparse
surrogate policy every GP designer the factory builds shares.

The JAX runtime's opt-in planes, each off by default as there:

- ``admission`` (``serving.admission``): fair-share admission, load
  shedding and degradation at the Pythia dispatch boundary, and the
  executor's weighted fair share (``VIZIER_TORCH_ADMISSION*``);
- ``speculative`` (``serving.speculative``): the next suggestion batch
  computed after each completion on the executor's deferrable lane and
  served from the designer-cache entry (``VIZIER_TORCH_SPECULATIVE*``);
- ``slo`` (``observability.slo``): windowed objectives over this runtime's
  registry with black-box dumps on a breach (``VIZIER_TORCH_SLO*``);
- the process-global flight recorder (``observability.flight_recorder``,
  ``VIZIER_TORCH_FLIGHT_RECORDER=1``).

With all of them off the request path is the one without them, bit for bit:
no engine object, no threads, no reordering, no tenant labels. The servicer's
order around each plane lives here without protobuf
(:meth:`serve_suggest` over :meth:`guarded_suggest`, :meth:`admitted_suggest`
and :meth:`speculative_suggest`), so the card drives the same code the gRPC
servicer adapts.

Prewarm (:meth:`prewarm_batching`, or :meth:`maybe_prewarm_batching_async`
with ``batching_prewarm`` on) builds the kernel library and runs one flush per
(bucket, count, batch size), so a bucket's first live flush captures no CUDA
graph; ``compilation_cache_dir`` is where the kernel library is built and
found again by later processes. The mesh execution plane (``mesh``, or
``MeshConfig.from_env()`` when batching is on) carves the host's devices of
the runtime's ``device`` type into the executor's placements.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
import traceback
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence, TypeVar

from vizier_tpu_torch.observability import config as obs_config_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import slo as slo_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.ops import native
from vizier_tpu_torch.parallel import batch_executor as batch_executor_lib
from vizier_tpu_torch.reliability import breaker as breaker_lib
from vizier_tpu_torch.reliability import config as reliability_config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import fallback as fallback_lib
from vizier_tpu_torch.serving import admission as admission_lib
from vizier_tpu_torch.serving import coalescer as coalescer_lib
from vizier_tpu_torch.serving import config as config_lib
from vizier_tpu_torch.serving import designer_cache as cache_lib
from vizier_tpu_torch.serving import speculative as speculative_lib
from vizier_tpu_torch.serving import stats as stats_lib
from vizier_tpu_torch.surrogates import config as surrogate_config_lib

_logger = logging.getLogger(__name__)

R = TypeVar("R")


@dataclasses.dataclass
class GuardedSuggestion:
    """What :meth:`ServingRuntime.guarded_suggest` served: the policy's
    decision, or stamped fallback suggestions, or the typed error that
    completes the operation."""

    decision: Any = None
    fallbacks: List[Any] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None

    @property
    def suggestions(self) -> List[Any]:
        """The served suggestions (the decision's, else the fallbacks)."""
        return list(self.decision.suggestions) if self.decision is not None else self.fallbacks


def speculative_batch_size(metadatas: Iterable[Any]) -> Optional[int]:
    """The speculative engine's vetting rule over the metadata of a
    successful response's suggestions: the batch size when it may be
    parked, else None. No suggestions, or a reliability fallback stamp on
    any, is never parked: serving cached quasi-random picks when a live
    compute might succeed would silently degrade the study."""
    metadatas = list(metadatas)
    if not metadatas or any(fallback_lib.is_fallback_suggestion(m) for m in metadatas):
        return None
    return len(metadatas)


def accept_guarded(outcome: Optional[GuardedSuggestion]) -> Optional[int]:
    """:func:`speculative_batch_size` of a protobuf-free response; an error
    or a fallback-only outcome is never parked."""
    if outcome is None or outcome.error is not None or outcome.decision is None:
        return None
    return speculative_batch_size(s.metadata for s in outcome.suggestions)


def clone_guarded(outcome: GuardedSuggestion) -> GuardedSuggestion:
    """A coalesced follower's own copy of a protobuf-free response (the
    caller adds its suggestions to a study, which must not touch the
    leader's, nor a batch parked from the same computation)."""
    return GuardedSuggestion(
        decision=copy.deepcopy(outcome.decision),
        fallbacks=copy.deepcopy(outcome.fallbacks),
        error=outcome.error,
    )


def stamp_speculative_hit(outcome: GuardedSuggestion, count: int) -> GuardedSuggestion:
    """A private copy of a parked protobuf-free response, reconciled to
    ``count`` (the batch prefix when the client asked for fewer), each
    suggestion stamped by :func:`speculative.stamp_hit`."""
    suggestions = []
    for s in outcome.suggestions[:count]:
        s = copy.deepcopy(s)
        speculative_lib.stamp_hit(s.metadata)
        suggestions.append(s)
    decision = dataclasses.replace(outcome.decision, suggestions=suggestions)
    return GuardedSuggestion(decision=decision)


class ServingRuntime:
    """Shared serving state for one Pythia process."""

    def __init__(
        self,
        config: Optional[config_lib.ServingConfig] = None,
        stats: Optional[stats_lib.ServingStats] = None,
        reliability: Optional[reliability_config_lib.ReliabilityConfig] = None,
        observability: Optional[obs_config_lib.ObservabilityConfig] = None,
        surrogates: Optional[surrogate_config_lib.SurrogateConfig] = None,
        speculative: Optional[speculative_lib.SpeculativeConfig] = None,
        mesh: Optional[Any] = None,  # parallel.mesh.MeshConfig
        slo: Optional[slo_lib.SloConfig] = None,
        admission: Optional[admission_lib.AdmissionConfig] = None,
        device: Any = "cuda",
    ):
        """``device`` is the designers' device type, whose devices an enabled
        mesh carves into placements."""
        self.config = config or config_lib.ServingConfig.from_env()
        self.observability = observability or obs_config_lib.ObservabilityConfig.from_env()
        # The exact↔sparse auto-switch threaded into every GP designer the
        # policy factory builds.
        self.surrogates = surrogates or surrogate_config_lib.SurrogateConfig.from_env()
        self.stats = stats or stats_lib.ServingStats()
        self.metrics: metrics_lib.MetricsRegistry = self.stats.registry
        self.reliability = reliability or reliability_config_lib.ReliabilityConfig.from_env()
        # The persistent compile cache: the kernel library is built into (and
        # found again in) this directory.
        if self.config.compilation_cache_dir:
            native.set_build_dir(self.config.compilation_cache_dir)
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
        metrics = self.metrics if self.observability.metrics_on else None
        # The process-global flight recorder (the stateless no-op unless
        # VIZIER_TORCH_FLIGHT_RECORDER=1).
        self.flight_recorder = recorder_lib.get_recorder()
        # Multi-tenant overload protection at the Pythia dispatch boundary,
        # and the weighted fair share inside the batch executor. Off by
        # default: no controller.
        admission_config = admission or admission_lib.AdmissionConfig.from_env()
        self.admission: Optional[admission_lib.AdmissionController] = None
        if admission_config.enabled:
            self.admission = admission_lib.AdmissionController(
                admission_config,
                stats=self.stats,
                metrics=metrics,
                recorder=self.flight_recorder,
                compute_p50_fn=lambda: self._suggest_latency.percentile(50, hop="pythia"),
                queue_depth_fn=self._live_queue_depth,
            )
        # Cross-study batch executor: concurrent same-bucket designer
        # computations share one batched program. None = batching off: the
        # per-study path. The mesh execution plane (VIZIER_TORCH_MESH=1,
        # parallel.mesh.MeshConfig) carves the devices into the placements the
        # executor schedules buckets over; off (the default) = one thread.
        self.batch_executor: Optional[batch_executor_lib.BatchExecutor] = None
        self.mesh = mesh
        if self.config.batching:
            from vizier_tpu_torch.parallel import mesh as mesh_lib

            self.mesh = mesh or mesh_lib.MeshConfig.from_env()
            self.batch_executor = batch_executor_lib.BatchExecutor(
                max_batch_size=self.config.batch_max_size,
                max_wait_ms=self.config.batch_max_wait_ms,
                pad_partial=self.config.batch_pad_partial,
                stats=self.stats,
                metrics=metrics,
                mesh=self.mesh,
                admission=self.admission,
                device=device,
            )
        # Speculative pre-compute: after each completion the next suggestion
        # batch is computed in the background and served from the
        # designer-cache entry. Needs the cache (the slot lives on its
        # entries). Off by default: no engine.
        self.speculative = speculative or speculative_lib.SpeculativeConfig.from_env()
        self.speculative_engine: Optional[speculative_lib.SpeculativeEngine] = None
        if self.speculative.speculative and self.config.designer_cache:
            self.speculative_engine = speculative_lib.SpeculativeEngine(
                config=self.speculative,
                cache=self.designer_cache,
                stats=self.stats,
                metrics=metrics,
                executor=self.batch_executor,
            )
        # The SLO engine over this runtime's registry, with breach-triggered
        # black-box dumps. Off by default: no engine, no thread.
        self.slo = slo or slo_lib.SloConfig.from_env()
        self.slo_engine: Optional[slo_lib.SloEngine] = None
        if self.slo.enabled:
            self.slo_engine = slo_lib.SloEngine(
                config=self.slo, registry=self.metrics, recorder=self.flight_recorder
            )
            self.slo_engine.start()
        self._lock = threading.Lock()
        self._closed = False
        self._prewarmed_shapes: set = set()
        self._prewarm_threads: List[threading.Thread] = []

    # -- prewarm ---------------------------------------------------------------

    def prewarm_batching(
        self,
        problem: Any,
        designer_factory: Callable[..., Any],
        *,
        max_trials: Optional[int] = None,
        counts: Sequence[int] = (1,),
    ) -> List[dict]:
        """Walks the padding-bucket grid for ``problem`` at batch sizes
        {1, max}, so a bucket's first live flush captures no CUDA graph.
        Returns the executor's per-(bucket, count, size) report."""
        if self.batch_executor is None:
            return []
        return self.batch_executor.prewarm(
            problem,
            designer_factory,
            max_trials=max_trials or self.config.batching_prewarm_max_trials,
            counts=counts,
        )

    def maybe_prewarm_batching_async(
        self, problem: Any, designer_factory: Callable[..., Any]
    ) -> bool:
        """Background prewarm, once per distinct search-space shape; used by
        the policy factory when ``config.batching_prewarm`` is on. Returns
        True when a prewarm thread was started."""
        if self.batch_executor is None or not self.config.batching_prewarm:
            return False
        shape_key = tuple(
            sorted((p.name, str(p.type)) for p in problem.search_space.parameters)
        )
        with self._lock:
            if shape_key in self._prewarmed_shapes:
                return False
            self._prewarmed_shapes.add(shape_key)
        thread = threading.Thread(
            target=lambda: self.prewarm_batching(problem, designer_factory),
            name="vizier-batch-prewarm",
            daemon=True,
        )
        with self._lock:
            self._prewarm_threads.append(thread)
        thread.start()
        return True

    def shutdown(self) -> None:
        """Joins in-flight prewarms, stops the SLO evaluator, cancels
        speculative jobs and joins their workers, then drains the batch
        executor — in that order, so no speculative job can submit into a
        closing executor. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads, self._prewarm_threads = self._prewarm_threads, []
        for thread in threads:
            thread.join(timeout=120.0)
        if self.slo_engine is not None:
            self.slo_engine.close()
        if self.speculative_engine is not None:
            self.speculative_engine.close()
        if self.batch_executor is not None:
            self.batch_executor.close()

    def _live_queue_depth(self) -> int:
        """Queued live executor slots (0 with batching off) — the admission
        controller's deadline-shed wait estimator input."""
        executor = self.batch_executor
        return 0 if executor is None else executor.live_pending()

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
        self.flight_recorder.record(study_name, "fallback", reason=reason, count=len(suggestions))
        _logger.warning(
            "Serving %d quasi-random fallback suggestion(s) for %s (%s).",
            len(suggestions),
            study_name,
            reason,
        )
        return GuardedSuggestion(fallbacks=suggestions)

    def admitted_suggest(
        self,
        study_name: str,
        live: Callable[[], GuardedSuggestion],
        fallback: Callable[[str], List[Any]],
        deadline_secs: float = 0.0,
        setup: Optional[Callable[[], Any]] = None,
    ) -> GuardedSuggestion:
        """The admission gate around one live designer computation.

        The JAX Pythia servicer's ``_suggest_compute_admitted`` without
        protobuf. With no controller (the default), and inside a speculative
        job's own compute (the engine has its own executor-backed gate, and
        a background pre-compute must never take a live in-flight slot),
        this is a direct call of ``live()``. A SHED verdict returns the
        typed ``TRANSIENT: RESOURCE_EXHAUSTED`` error with its retry-after
        hint (an :class:`~admission.AdmissionShedError`) without touching
        the study's circuit breaker or computing anything. A DEGRADE verdict
        (sustained overload, low-priority tenant) serves ``fallback``'s
        seeded quasi-random suggestions, stamped ``ns "admission":
        degraded=quasi_random`` next to the reliability stamp; ``setup``
        (the live path's config parsing) runs first, and its exception
        completes the op as it is, a permanent error, since a misconfigured
        study served fallbacks would stay misconfigured. An ADMIT
        holds the in-flight slot for ``live()``'s duration, with the tenant
        on the contextvar the batch executor's fair share reads.
        """
        admission = self.admission
        if admission is None or speculative_lib.in_speculative_compute():
            return live()
        tenant = admission_lib.tenant_of(study_name)
        decision = admission.decide(tenant, deadline_secs=deadline_secs, study=study_name)
        if decision.outcome == admission_lib.SHED:
            tracing_lib.add_current_event("admission.shed", tenant=tenant, reason=decision.reason)
            return GuardedSuggestion(error=decision.error())
        if decision.outcome == admission_lib.DEGRADE:
            tracing_lib.add_current_event("admission.degraded", tenant=tenant)
            if setup is not None:
                try:
                    setup()
                except Exception as e:
                    return GuardedSuggestion(error=e)
            out = self._fallback(study_name, fallback, "admission_degraded")
            for suggestion in out.fallbacks:
                admission_lib.stamp_degraded(suggestion.metadata)
            return out
        with admission.in_flight(decision):
            return live()

    # -- speculative pre-compute ---------------------------------------------

    def bind_speculative(
        self,
        fingerprint_fn: Callable[[str], Any],
        compute_fn: Callable[[str, int, int], Any],
        accept_fn: Callable[[Any], Optional[int]],
    ) -> bool:
        """Connects the speculative engine to a compute path (no-op without
        an engine); see :class:`~speculative.SpeculativeEngine` for the
        three callables. Returns True when an engine was bound."""
        engine = self.speculative_engine
        if engine is None:
            return False
        engine.bind(fingerprint_fn=fingerprint_fn, compute_fn=compute_fn, accept_fn=accept_fn)
        return True

    def notify_trial_event(self, study_name: str) -> None:
        """A completion or measurement moved the study's frontier: drop the
        parked batch and enqueue a pre-compute for the new frontier."""
        engine = self.speculative_engine
        if engine is not None and engine.bound:
            engine.notify_completion(study_name)

    def speculative_suggest(
        self,
        study_name: str,
        count: int,
        fingerprint: Callable[[], speculative_lib.FrontierFingerprint],
        live: Callable[[], R],
        stamp: Callable[[R, int], R],
        succeeded: Callable[[R], bool],
    ) -> R:
        """The speculative serve check around the live compute.

        The JAX Pythia servicer's ``_suggest_compute`` without protobuf.
        With no bound engine, and inside a speculative job's own compute (a
        job must compute, not serve itself), this is a direct call of
        ``live()``. Otherwise the parked batch is popped when the request's
        frontier (``fingerprint()``: the current completed and active sets
        and the config hash) matches the one it was computed for, and
        returned through ``stamp(parked, count)``; any failure of that check
        decays to ``live()``. A live response that ``succeeded`` fires the
        opt-in post-fill trigger.
        """
        engine = self.speculative_engine
        if engine is None or not engine.bound or speculative_lib.in_speculative_compute():
            return live()
        t0 = time.perf_counter()
        served = None
        if study_name:
            try:
                engine.note_live_suggest(study_name, count)
                served, _ = engine.try_serve(study_name, count, fingerprint())
            except Exception:
                _logger.warning(
                    "Speculative serve check failed for %s; computing live.",
                    study_name,
                    exc_info=True,
                )
                served = None
        if served is not None:
            served = stamp(served, count)
            engine.observe_suggest_latency("hit", time.perf_counter() - t0)
            return served
        response = live()
        engine.observe_suggest_latency("miss", time.perf_counter() - t0)
        if succeeded(response):
            # The live compute just refreshed the designer entry; with
            # speculate_on_fill, pre-compute the batch a second client at
            # the post-suggest frontier would receive.
            engine.notify_fill(study_name)
        return response

    def serve_suggest(
        self,
        study_name: str,
        count: int,
        *,
        key: Hashable,
        fingerprint: Callable[[], speculative_lib.FrontierFingerprint],
        prepare: Callable[[], Callable[[], Any]],
        fallback: Callable[[str], List[Any]],
        respond: Callable[[GuardedSuggestion], R],
        stamp: Callable[[R, int], R],
        succeeded: Callable[[R], bool],
        deadline_secs: float = 0.0,
        setup: Optional[Callable[[], Any]] = None,
        clone: Optional[Callable[[R], R]] = None,
    ) -> R:
        """One suggest in the Pythia servicer's order, without protobuf.

        Request coalescing under ``key`` (``coalescer.suggest_key``; off with
        ``ServingConfig.coalescing``), then :meth:`speculative_suggest`'s
        serve check, then :meth:`admitted_suggest`'s gate (``setup`` runs
        before a degraded serve), then ``prepare()``, which returns the
        designer computation (its exception is a permanent error, never a
        fallback), then :meth:`guarded_suggest` under the wire budget
        ``deadline_secs`` (0 = none; deadlines off = none). ``respond`` turns
        the outcome into the transport's response; a coalesced follower
        gets ``clone`` of the leader's. The gRPC servicer and the loadgen's
        runtime transport both serve through here.
        """

        def live_compute() -> GuardedSuggestion:
            try:
                compute = prepare()
            except Exception as e:
                _logger.warning("Pythia Suggest setup failed: %s", traceback.format_exc())
                return GuardedSuggestion(error=e)
            # from_wire, not from_budget: a negative wire budget means the
            # caller's deadline already expired at the sender, and the
            # dispatch check then sheds before any designer computation.
            deadline = (
                deadline_lib.Deadline.from_wire(deadline_secs)
                if self.reliability.deadlines_on
                else deadline_lib.Deadline.none()
            )
            return self.guarded_suggest(study_name, compute, fallback, deadline)

        def live() -> R:
            return respond(self.admitted_suggest(
                study_name, live_compute, fallback, deadline_secs, setup=setup
            ))

        def serve() -> R:
            return self.speculative_suggest(study_name, count, fingerprint, live, stamp, succeeded)

        if not self.config.coalescing:
            return serve()
        return self.coalescer.coalesce(key, serve, clone=clone, span_name="pythia.suggest_compute")

    def speculative_invalidate(self, study_name: str, reason: str = "") -> None:
        """Drops only the study's speculative slot and job (frontier
        surgery, surrogate crossover); the designer entry itself stays."""
        if self.speculative_engine is not None:
            self.speculative_engine.invalidate(study_name, reason=reason)

    # -- observability -------------------------------------------------------

    def observe_suggest_latency(
        self,
        hop: str,
        seconds: float,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> None:
        """Records one suggest's wall time at a hop (no-op when metrics are
        off). ``trace_id`` makes the observation an exemplar candidate.
        ``tenant`` (set by the service hop only while admission is armed)
        splits the series per tenant so the SLO engine can hold a per-tenant
        p99 objective; None keeps the series as without admission."""
        if self.observability.metrics_on:
            labels = {"hop": hop}
            if tenant is not None:
                labels["tenant"] = tenant
            self._suggest_latency.observe(seconds, trace_id=trace_id, **labels)

    def slo_report(self) -> Dict[str, Any]:
        """Evaluates the armed SLOs now and returns the JSON-ready report
        (``{"armed": False}`` when the SLO engine is off)."""
        if self.slo_engine is None:
            return {"armed": False}
        return self.slo_engine.report()

    def admission_snapshot(self) -> Dict[str, Any]:
        """The admission controller's JSON-ready state (per-tenant sheds and
        admits, overload state, transitions); ``{"enabled": False}`` with
        the plane off."""
        if self.admission is None:
            return {"enabled": False}
        return self.admission.snapshot()

    def prometheus_text(self) -> str:
        """Every serving counter and latency histogram, Prometheus format."""
        return self.metrics.prometheus_text()

    def invalidate_study(self, study_name: str) -> bool:
        """Drops the study's designer state, breaker, speculative job and
        recorder ring (study deleted)."""
        self.breakers.invalidate(study_name)
        if self.speculative_engine is not None:
            self.speculative_engine.invalidate(study_name, reason="delete_study")
        self.flight_recorder.invalidate(study_name)
        return self.designer_cache.invalidate(study_name)

    def note_study_config(self, study_name: str, config_hash: str) -> bool:
        """Pins per-study serving state to one StudyConfig incarnation.

        Called by the servicer with every request's parsed-config hash. On a
        hash turnover (a study deleted and recreated through another
        frontend, whose ``DeleteStudy`` invalidation cannot reach this
        process, or a metadata update) everything trained against the
        previous incarnation (designer entry, breaker, speculative slot) is
        dropped so it is never served again. The flight-recorder ring
        survives: it is history keyed by time, not derived state. Returns
        True when a turnover was detected.
        """
        changed = self.designer_cache.note_config_hash(study_name, config_hash)
        if changed:
            # note_config_hash already dropped the designer entry itself.
            self.breakers.invalidate(study_name)
            if self.speculative_engine is not None:
                self.speculative_engine.invalidate(study_name, reason="config_turnover")
        return changed

    def snapshot(self) -> Dict[str, int]:
        """All counters plus the current cache/breaker population."""
        out = self.stats.snapshot()
        out["cached_studies"] = len(self.designer_cache)
        out["open_breakers"] = self.breakers.open_count()
        return out
