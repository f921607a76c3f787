"""Speculative suggestion pre-compute: make the next suggest a cache hit.

A copy of the JAX package's ``serving/speculative.py``. After each trial
completion the serving runtime already has everything a steady-state suggest
needs — the live designer, warm ARD params and the new measurement — yet the
next suggest still pays the full GP train and acquisition sweep on the
request path. This module moves that compute off the request path: a
completion enqueues a *speculative job* keyed by the study's **frontier
fingerprint** (completed-trial set + active-trial set + study-config hash);
a bounded worker pool runs the job through the same policy / designer-cache
/ batch-executor / surrogate path as a live request (on the executor's
deferrable lane, so live traffic is never delayed), and parks the resulting
suggestion batch in a speculative slot on the study's designer-cache entry.
A live suggest whose frontier fingerprint matches serves the parked batch
in microseconds; any frontier change, study deletion, surrogate crossover
or config change invalidates the slot, and ``max_speculation_age_s`` bounds
staleness in time.

Correctness model — a hit IS the live compute, run early:

- The speculative job executes the identical ``update → suggest`` sequence
  on the identical cached designer the live request would have used, so a
  hit equals what live compute would have produced for the same frontier,
  float for float.
- Designers advance a persistent generator per suggest, so an *unserved*
  speculation shifts the stream for later computes. The engine therefore
  speculates only frontiers the workload will serve (completion-triggered
  by default; the post-fill trigger is opt-in) and discards — never
  serves — results whose frontier moved mid-flight.
- A live request that misses computes the very frontier its study's job
  was enqueued for, so it supersedes that job (a queued one never runs, a
  running one parks nothing): the port's one departure from the JAX
  engine, which lets such a job run on and speculate a frontier nobody asks
  for, holding a worker and the executor meanwhile.
- Speculative failures never surface to clients: a failed, superseded,
  fallback-stamped or shutdown-cancelled job simply leaves the slot empty
  and the next request decays to a live compute. ``stats`` counts each
  outcome (``speculative_errors``, ``speculative_cancelled``), so a caller
  that must not miss one can read them.

Thread and lock model: the queue condition (``_cond``) and the slot-swap
lock (``_serve_lock``) are leaves — no device compute, RPC or foreign lock
is ever taken under them. Workers pop a job under ``_cond``, release it and
run the compute bare; the compute path itself takes the ordinary serving
locks (cache map, entry, coalescer) exactly as a live request does. A
worker is a thread of its own: it makes the CUDA device current that was
current on the thread that started the pool, so its compute lands where
the caller's would have.

``VIZIER_TORCH_SPECULATIVE=0`` (the default — speculation is opt-in) leaves
the request path as it is without the engine: no engine object, no
threads, no extra designer computes.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.utils import env as env_lib

_logger = logging.getLogger(__name__)

# Metadata stamp on served speculative suggestions (the serve-path twin of
# reliability's fallback stamp): ns "serving", key "speculative" = "hit".
SPECULATIVE_NAMESPACE = "serving"
SPECULATIVE_KEY = "speculative"
SPECULATIVE_HIT_VALUE = "hit"

# The speculative-compute flag rides a thread-local, not the request proto:
# the engine's worker runs the whole compute stack synchronously on its own
# thread (policy → batch executor), so every layer can ask "am I inside a
# speculative job?" without a wire-schema change.
_STATE = threading.local()


def stamp_hit(metadata) -> None:
    """``ns "serving": speculative=hit`` on one served suggestion's
    metadata, so served speculative picks stay auditable."""
    metadata.ns(SPECULATIVE_NAMESPACE)[SPECULATIVE_KEY] = SPECULATIVE_HIT_VALUE


def in_speculative_compute() -> bool:
    """True on a thread currently executing a speculative job's compute."""
    return getattr(_STATE, "speculative", False)


class speculative_scope:
    """Marks the current thread as running a speculative compute."""

    def __enter__(self):
        self._prev = getattr(_STATE, "speculative", False)
        _STATE.speculative = True
        return self

    def __exit__(self, *exc):
        _STATE.speculative = self._prev
        return False


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Knobs for the speculative pre-compute pipeline."""

    # Master switch. Default OFF: speculation trades idle compute (and, on
    # a count-mismatch miss, an extra designer generator advance) for
    # request latency. Off = no engine, no threads, the same request path.
    speculative: bool = False
    # Bounded worker pool size. One worker serializes speculative device
    # compute behind live traffic naturally; more only helps multi-study
    # completion bursts.
    workers: int = 1
    # A parked batch older than this is served to nobody: the evaluation
    # that should have consumed it evidently stalled, and hyperparameters
    # may have drifted meaningfully by the time traffic returns.
    max_speculation_age_s: float = 300.0
    # Also speculate when a live suggest fills/refreshes the cache entry
    # (pre-computes the batch a SECOND client at the post-suggest frontier
    # would get). Off by default: in single-client loops that batch is
    # never served, and an unserved speculation advances the designer's
    # RNG stream away from the non-speculative path.
    speculate_on_fill: bool = False
    # Idle-window admission gate: a job is only handed to the compute path
    # while the batch executor's LIVE queue depth is <= this; otherwise the
    # worker backs off (admission_backoff_s per probe, admission_max_wait_s
    # total) and then drops the job rather than contend with live traffic.
    max_live_queue_depth: int = 0
    admission_backoff_s: float = 0.01
    admission_max_wait_s: float = 0.25
    # Count speculated for a study before its first live suggest reveals
    # the client's real batch size.
    default_count: int = 1
    # Distinct recent request counts remembered per study. A job
    # speculates the LARGEST of them: smaller requests serve a prefix of
    # the parked batch (the serve path already reconciles down), so a
    # client alternating suggest(1)/suggest(5) hits on both.
    count_memory: int = 4
    # Trigger debounce for high-completion-rate studies: a completion
    # burst (parallel workers reporting back-to-back) coalesces into ONE
    # pre-compute once the study has been quiet this long, instead of
    # starting-and-superseding a job per completion. 0 = immediate.
    debounce_ms: float = 0.0

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}.")
        if self.max_speculation_age_s <= 0:
            raise ValueError(
                f"max_speculation_age_s must be > 0, got "
                f"{self.max_speculation_age_s}."
            )
        if self.default_count < 1:
            raise ValueError(
                f"default_count must be >= 1, got {self.default_count}."
            )
        if self.count_memory < 1:
            raise ValueError(
                f"count_memory must be >= 1, got {self.count_memory}."
            )
        if self.debounce_ms < 0:
            raise ValueError(
                f"debounce_ms must be >= 0, got {self.debounce_ms}."
            )

    @classmethod
    def from_env(cls) -> "SpeculativeConfig":
        """The default config with per-knob environment overrides applied
        (``VIZIER_TORCH_SPECULATIVE*``)."""
        return cls(
            speculative=env_lib.env_on("VIZIER_TORCH_SPECULATIVE", default="0"),
            workers=env_lib.env_int("VIZIER_TORCH_SPECULATIVE_WORKERS", 1),
            max_speculation_age_s=env_lib.env_float("VIZIER_TORCH_SPECULATIVE_MAX_AGE_S", 300.0),
            speculate_on_fill=env_lib.env_on("VIZIER_TORCH_SPECULATIVE_ON_FILL", default="0"),
            count_memory=env_lib.env_int("VIZIER_TORCH_SPECULATIVE_COUNT_MEMORY", 4),
            debounce_ms=env_lib.env_float("VIZIER_TORCH_SPECULATIVE_DEBOUNCE_MS", 0.0),
        )

    @classmethod
    def disabled(cls) -> "SpeculativeConfig":
        """No speculation: the request path without the engine."""
        return cls(speculative=False)

    def as_dict(self) -> dict:
        """JSON-stampable form."""
        return {
            "speculative": self.speculative,
            "workers": self.workers,
            "max_speculation_age_s": self.max_speculation_age_s,
            "speculate_on_fill": self.speculate_on_fill,
            "count_memory": self.count_memory,
            "debounce_ms": self.debounce_ms,
        }


@dataclasses.dataclass(frozen=True)
class FrontierFingerprint:
    """Identity of the designer-visible study state.

    Two requests with equal fingerprints would feed the designer identical
    inputs: the same completed-trial set (what ``update`` incorporates),
    the same active-trial set (what batch designers condition on as
    pending points), and the same study config (search space, metrics,
    algorithm — hashed, since the spec can be KBs). Measurement *content*
    on active trials is intentionally excluded: no shipped designer reads
    it, and ``AddMeasurement`` re-speculates anyway.
    """

    config_digest: str
    completed_ids: Tuple[int, ...]
    active_ids: Tuple[int, ...]


def config_digest(spec_bytes: bytes) -> str:
    return hashlib.sha256(spec_bytes).hexdigest()[:16]


def make_fingerprint(
    spec_bytes: bytes,
    completed_ids: Iterable[int],
    active_ids: Iterable[int],
) -> FrontierFingerprint:
    return FrontierFingerprint(
        config_digest=config_digest(spec_bytes),
        completed_ids=tuple(sorted(int(i) for i in completed_ids)),
        active_ids=tuple(sorted(int(i) for i in active_ids)),
    )


@dataclasses.dataclass
class SpeculativeSlot:
    """One parked pre-computed suggestion batch (designer-cache entry)."""

    study_name: str
    fingerprint: FrontierFingerprint
    response: Any  # PythiaSuggestResponse (opaque to the engine)
    count: int
    created_at: float  # engine-clock (monotonic) timestamp


class _Job:
    """One queued speculative pre-compute for a study."""

    __slots__ = ("study_name", "epoch", "trigger_ctx", "reason", "not_before")

    def __init__(
        self,
        study_name: str,
        epoch: int,
        trigger_ctx: Optional[tracing_lib.SpanContext],
        reason: str,
        not_before: float = 0.0,
    ):
        self.study_name = study_name
        self.epoch = epoch
        self.trigger_ctx = trigger_ctx
        self.reason = reason
        # Engine-clock debounce deadline: a worker leaves the job queued
        # until this time, so a completion burst supersedes in place and
        # costs one compute instead of one per completion.
        self.not_before = not_before


class SpeculativeEngine:
    """Background pre-compute pipeline over the designer cache.

    The engine is proto-agnostic: the Pythia servicer binds three
    callables —

    - ``fingerprint_fn(study_name) -> (FrontierFingerprint, max_trial_id)``
      reads the study's current frontier;
    - ``compute_fn(study_name, count, max_trial_id) -> response`` runs the
      live suggest path (coalescer → policy → designer → batch executor)
      and returns the response proto, or ``None``;
    - ``accept_fn(response) -> Optional[int]`` vets a response for
      parking (no error, non-empty, not a reliability fallback) and
      returns its batch size.

    Everything else — supersede-on-new-completion epochs, the admission
    gate against live batch-executor traffic, slot staleness, one-shot
    consumption — is engine-internal.
    """

    def __init__(
        self,
        config: SpeculativeConfig,
        cache,  # serving.designer_cache.DesignerStateCache
        stats=None,  # serving.stats.ServingStats
        metrics=None,  # observability.metrics.MetricsRegistry
        executor=None,  # parallel.batch_executor.BatchExecutor
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self.config = config
        self._cache = cache
        self._stats = stats
        self._executor = executor
        self._time = time_fn
        self._fingerprint_fn: Optional[Callable] = None
        self._compute_fn: Optional[Callable] = None
        self._accept_fn: Optional[Callable] = None
        # Queue state under _cond: newest job per study (a fresh completion
        # supersedes the queued job for the same study), per-study epochs
        # (bumped by every notify/invalidate; a finished job only parks its
        # result if its epoch is still current), last-seen live counts, and
        # the in-flight study set (wait_idle).
        self._cond = threading.Condition()
        self._jobs: "collections.OrderedDict[str, _Job]" = (
            collections.OrderedDict()
        )
        self._epochs: Dict[str, int] = {}
        # study -> OrderedDict of its last count_memory DISTINCT request
        # counts (insertion order = recency; values unused).
        self._counts: Dict[str, "collections.OrderedDict"] = {}
        self._inflight: set = set()
        self._closed = False
        self._threads: List[threading.Thread] = []
        # The CUDA device current on the thread that starts the pool; each
        # worker makes it current on its own thread (None: no CUDA context).
        self._device_index: Optional[int] = None
        # Slot swaps (park / one-shot pop) serialize on their own leaf lock
        # so two concurrent suggests can never both serve one batch.
        self._serve_lock = threading.Lock()
        self._events = None
        self._latency = None
        if metrics is not None:
            self._events = metrics.counter(
                "vizier_speculative_events",
                help="Speculative pipeline events by outcome "
                "(hit | miss | stale | cancelled | stored | error).",
            )
            self._latency = metrics.histogram(
                "vizier_speculative_suggest_latency_seconds",
                help="Pythia suggest wall time split by whether the "
                "speculative slot served it (result=hit|miss).",
            )

    # -- wiring --------------------------------------------------------------

    def bind(
        self,
        *,
        fingerprint_fn: Callable,
        compute_fn: Callable,
        accept_fn: Callable,
    ) -> None:
        """Connects the engine to a Pythia servicer's compute path."""
        self._fingerprint_fn = fingerprint_fn
        self._compute_fn = compute_fn
        self._accept_fn = accept_fn

    @property
    def bound(self) -> bool:
        return self._compute_fn is not None

    # -- triggers ------------------------------------------------------------

    def notify_completion(self, study_name: str) -> bool:
        """CompleteTrial/AddMeasurement: frontier moved — invalidate the
        parked slot and enqueue a pre-compute for the new frontier."""
        return self._enqueue(study_name, reason="completion")

    def notify_fill(self, study_name: str) -> bool:
        """A live compute just filled/refreshed the cache entry; with
        ``speculate_on_fill`` pre-compute for the post-suggest frontier."""
        if not self.config.speculate_on_fill:
            return False
        return self._enqueue(study_name, reason="fill")

    def note_live_suggest(self, study_name: str, count: int) -> None:
        """Records the client's batch size in the study's recent-count set.

        The last ``count_memory`` DISTINCT counts are kept; jobs speculate
        the largest of them (smaller requests serve a batch prefix), so a
        workload mixing batch sizes no longer misses on the bigger ones.
        """
        if count < 1:
            return
        with self._cond:
            counts = self._counts.setdefault(
                study_name, collections.OrderedDict()
            )
            counts[count] = None
            counts.move_to_end(count)
            while len(counts) > self.config.count_memory:
                counts.popitem(last=False)

    def invalidate(self, study_name: str, reason: str = "") -> None:
        """Drops the parked slot and supersedes any queued/in-flight job
        (DeleteStudy, surrogate crossover, external frontier surgery).

        The study's recent request counts go too, so the next job
        speculates ``default_count`` until a live request notes a count.
        """
        dropped_job = False
        with self._cond:
            self._epochs[study_name] = self._epochs.get(study_name, 0) + 1
            dropped_job = self._jobs.pop(study_name, None) is not None
            self._counts.pop(study_name, None)
        if dropped_job:
            self._record("cancelled", reason=reason or "invalidated")
        self._clear_slot(study_name)
        tracing_lib.add_current_event(
            "speculative.invalidated", study=study_name, reason=reason
        )

    def _enqueue(self, study_name: str, reason: str) -> bool:
        if not self.bound:
            return False
        trigger_ctx = tracing_lib.get_tracer().current_context()
        # The old slot (if any) was computed for a frontier that no longer
        # exists; drop it eagerly rather than letting it fail the serve-time
        # fingerprint check. BEFORE the enqueue: a worker may pick the new
        # job the instant it lands, and clearing afterwards could wipe the
        # fresh batch it just parked.
        self._clear_slot(study_name)
        superseded = False
        with self._cond:
            if self._closed:
                return False
            epoch = self._epochs.get(study_name, 0) + 1
            self._epochs[study_name] = epoch
            superseded = study_name in self._jobs
            self._jobs[study_name] = _Job(
                study_name,
                epoch,
                trigger_ctx,
                reason,
                not_before=self._time() + self.config.debounce_ms / 1000.0,
            )
            self._jobs.move_to_end(study_name)
            self._ensure_workers()
            self._cond.notify_all()
        if superseded:
            self._record("cancelled", reason="superseded")
        return True

    # -- serve path ----------------------------------------------------------

    def try_serve(
        self, study_name: str, count: int, fingerprint: FrontierFingerprint
    ) -> Tuple[Optional[Any], str]:
        """One-shot pop of the parked batch when it matches the request.

        Returns ``(response, outcome)`` with outcome in
        ``hit | miss | stale``; the response is only non-None on a hit and
        the slot is consumed (two racing suggests can never both serve one
        parked batch — the loser decays to live compute).
        """
        entry = self._cache.peek(study_name)
        slot = getattr(entry, "speculative", None) if entry is not None else None
        if slot is None:
            self._record("miss", study=study_name)
            self._supersede_for_live(study_name)
            return None, "miss"
        now = self._time()
        outcome = "hit"
        with self._serve_lock:
            slot = entry.speculative
            if slot is None:
                self._record("miss", study=study_name)
                outcome = "miss"
            elif now - slot.created_at > self.config.max_speculation_age_s:
                entry.speculative = None
                self._record("stale", study=study_name)
                outcome = "stale"
            elif slot.fingerprint != fingerprint:
                # The frontier moved since the job ran; the batch can never
                # be served (fingerprints don't come back) — drop it.
                entry.speculative = None
                self._record("miss", study=study_name, reason="fingerprint")
                outcome = "miss"
            elif count > slot.count:
                # The client wants more than was speculated: the whole
                # request falls through to live compute (the parked batch
                # stays for a matching-count peer; the live compute's new
                # trials will invalidate it naturally).
                self._record("miss", study=study_name, reason="count")
                return None, "miss"
            else:
                entry.speculative = None
        if outcome != "hit":
            self._supersede_for_live(study_name)
            return None, outcome
        self._record("hit", study=study_name)
        return slot.response, "hit"

    def _supersede_for_live(self, study_name: str) -> None:
        """A live request missed and is computing the frontier that a queued
        or running job of the study was enqueued for. That job can no longer
        park a batch anyone asks for: a queued one would speculate the
        frontier after the live suggest (the post-fill batch, which
        ``speculate_on_fill`` leaves off), a running one parks for a frontier
        the live suggest just moved. It is superseded, so the worker and the
        executor are free for other studies' jobs."""
        with self._cond:
            if study_name not in self._jobs and study_name not in self._inflight:
                return
            self._epochs[study_name] = self._epochs.get(study_name, 0) + 1
            dropped = self._jobs.pop(study_name, None) is not None
        if dropped:
            self._record("cancelled", study=study_name, reason="served_live")

    def observe_suggest_latency(self, result: str, seconds: float) -> None:
        """The request-path latency histogram split by hit/miss."""
        if self._latency is not None:
            self._latency.observe(seconds, result=result)

    # -- worker pool ---------------------------------------------------------

    def _ensure_workers(self) -> None:
        """Starts workers lazily (caller holds ``_cond``)."""
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._device_index is None and torch.cuda.is_initialized():
            self._device_index = torch.cuda.current_device()
        while len(self._threads) < self.config.workers:
            thread = threading.Thread(
                target=self._worker_loop,
                name=f"vizier-torch-speculative-{len(self._threads)}",
                daemon=True,  # joined in close(); daemon guards teardown
            )
            self._threads.append(thread)
            thread.start()

    def _pop_due_job_locked(self):
        """(job, wait): the first debounce-expired job (popped), or the
        seconds until the earliest becomes due (None = queue empty).
        Caller holds ``_cond``."""
        if not self._jobs:
            return None, None
        now = self._time()
        earliest: Optional[float] = None
        for name, job in self._jobs.items():
            if job.not_before <= now:
                return self._jobs.pop(name), None
            wait = job.not_before - now
            earliest = wait if earliest is None else min(earliest, wait)
        return None, earliest

    def _worker_loop(self) -> None:
        if self._device_index is not None:
            torch.cuda.set_device(self._device_index)
        while True:
            with self._cond:
                while True:
                    if self._closed:
                        return
                    job, wait = self._pop_due_job_locked()
                    if job is not None:
                        break
                    self._cond.wait(timeout=wait)
                study_name = job.study_name
                self._inflight.add(study_name)
            try:
                self._run_job(job)
            except Exception:  # must never kill the pool
                _logger.warning(
                    "Speculative job for %s died.", job.study_name, exc_info=True
                )
                self._record("error", study=job.study_name)
            finally:
                with self._cond:
                    self._inflight.discard(study_name)
                    self._cond.notify_all()

    def _epoch_current(self, job: _Job) -> bool:
        with self._cond:
            return (
                not self._closed
                and self._epochs.get(job.study_name, 0) == job.epoch
            )

    def _admission_wait(self, job: _Job) -> bool:
        """Blocks until the live flush buckets are quiet (True) or the
        admission budget runs out / the job is superseded (False)."""
        if self._executor is None:
            return True
        deadline = self._time() + self.config.admission_max_wait_s
        while True:
            if self._executor.live_pending() <= self.config.max_live_queue_depth:
                return True
            if self._time() >= deadline:
                return False
            if not self._epoch_current(job):
                return False
            time.sleep(self.config.admission_backoff_s)

    def _run_job(self, job: _Job) -> None:
        study = job.study_name
        if not self._epoch_current(job):
            self._record("cancelled", study=study, reason="superseded")
            return
        if self._cache.peek(study, touch=False) is None:
            # No designer entry ⇒ the study has never been served through
            # the cache (bulk trial loading before the first suggest, an
            # evicted entry, or a non-cached policy like RANDOM_SEARCH).
            # The hit path needs the entry to park on, so computing now
            # would burn designer RNG state for a batch nobody can serve.
            self._record("cancelled", study=study, reason="no_entry")
            return
        if not self._admission_wait(job):
            if self._epoch_current(job):
                self._record("cancelled", study=study, reason="busy")
            else:
                self._record("cancelled", study=study, reason="superseded")
            return
        tracer = tracing_lib.get_tracer()
        with tracer.span(
            "speculative.precompute", study=study, trigger=job.reason
        ) as span:
            # Link (not parent) the triggering completion: the pre-compute
            # is its own trace, but a completion's trace shows what work it
            # set in motion and vice versa.
            if span is not None and job.trigger_ctx is not None:
                span.add_link(job.trigger_ctx, name="trigger")
            with self._cond:
                recent = self._counts.get(study)
                # The largest recent count covers every smaller request as
                # a served prefix; only a count above every recent one
                # still falls through to live compute.
                count = max(recent) if recent else self.config.default_count
            outcome = self._compute_and_park(job, count)
            if span is not None:
                span.set_attribute("outcome", outcome)
                span.set_attribute("count", count)

    def _compute_and_park(self, job: _Job, count: int) -> str:
        study = job.study_name
        try:
            fingerprint, max_trial_id = self._fingerprint_fn(study)
        except Exception:
            _logger.warning(
                "Speculative fingerprint for %s failed.", study, exc_info=True
            )
            self._record("error", study=study, reason="fingerprint")
            return "error"
        self._record("precompute", study=study)
        try:
            with speculative_scope():
                response = self._compute_fn(study, count, max_trial_id)
        except Exception:
            # A speculative failure must never surface anywhere: no slot is
            # parked and the next live request simply computes as usual.
            _logger.warning(
                "Speculative compute for %s failed.", study, exc_info=True
            )
            self._record("error", study=study, reason="compute")
            return "error"
        batch_size = self._accept_fn(response) if response is not None else None
        if not batch_size:
            self._record("error", study=study, reason="rejected")
            return "rejected"
        if not self._epoch_current(job):
            # A completion (or invalidation, or shutdown) landed while the
            # job was mid-flight: the batch was computed for a frontier
            # that is already history — discard, never serve.
            self._record("cancelled", study=study, reason="superseded")
            return "superseded"
        entry = self._cache.peek(study)
        if entry is None:
            self._record("cancelled", study=study, reason="evicted")
            return "evicted"
        slot = SpeculativeSlot(
            study_name=study,
            fingerprint=fingerprint,
            response=response,
            count=batch_size,
            created_at=self._time(),
        )
        with self._serve_lock:
            entry.speculative = slot
        self._record("stored", study=study)
        return "stored"

    # -- lifecycle / inspection ---------------------------------------------

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Blocks until no job is queued or in flight (tests, A/B tools —
        models an evaluation that outlasts the pre-compute)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._jobs or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return not (self._jobs or self._inflight)
                self._cond.wait(timeout=remaining)
            return True

    def pending_jobs(self) -> int:
        with self._cond:
            return len(self._jobs) + len(self._inflight)

    def close(self, timeout: float = 30.0) -> None:
        """Cancels queued jobs, lets in-flight computes finish (their
        results are discarded via the epoch bump), joins the pool."""
        with self._cond:
            if self._closed:
                threads = list(self._threads)
            else:
                self._closed = True
                cancelled = len(self._jobs)
                self._jobs.clear()
                # Bump every epoch so an in-flight job can never park its
                # result into a half-shut-down runtime.
                for study in list(self._epochs):
                    self._epochs[study] += 1
                threads = list(self._threads)
                self._cond.notify_all()
                if cancelled:
                    self._record("cancelled", amount=cancelled, reason="shutdown")
        for thread in threads:
            thread.join(timeout=timeout)

    def _clear_slot(self, study_name: str) -> None:
        entry = self._cache.peek(study_name)
        if entry is None:
            return
        with self._serve_lock:
            entry.speculative = None

    _STAT_FIELDS = {
        "hit": "speculative_hits",
        "miss": "speculative_misses",
        "stale": "speculative_stale",
        "cancelled": "speculative_cancelled",
        "precompute": "speculative_precomputes",
        "error": "speculative_errors",
    }

    def _record(self, outcome: str, amount: int = 1, **attrs) -> None:
        field = self._STAT_FIELDS.get(outcome)
        if self._stats is not None and field is not None:
            self._stats.increment(field, amount)
        if self._events is not None:
            self._events.inc(amount, outcome=outcome)
        tracing_lib.add_current_event(
            f"speculative.{outcome}", **{k: v for k, v in attrs.items() if v}
        )
        recorder = recorder_lib.get_recorder()
        if recorder.enabled:
            clean = {k: v for k, v in attrs.items() if v and k != "study"}
            recorder.record(
                attrs.get("study"), "speculation", outcome=outcome, **clean
            )
