"""Cross-study continuous batching: N same-shape studies, one device batch.

Counterpart of the JAX package's ``parallel/batch_executor.py``, single
placement. The padding schedule (``converters.padding``) quantizes trials
and features into a small grid of ``(pad_trials, cont_width, cat_width)``
buckets, so concurrent designer computations from *different* studies are
collected into shape-bucket queues and run as one program over a leading
study axis (``DesignerProgram.device_program``): N studies' work in the
kernel launches of one.

Scheduling is a bounded micro-batch window: a bucket flushes when it reaches
``max_batch_size`` slots ("full") or when its oldest slot has waited
``max_wait_ms`` ("timeout"). Partial batches are padded to
``max_batch_size`` with copies of slot 0 that are dropped at demux. A lone
slot that was never prepared takes the designer's ordinary ``suggest``.

Every computation of the executor runs on its one scheduler thread, a lone
slot's ``suggest`` included (the JAX executor hands that one back to the
caller's thread). The port's device work is eager and host-bound: a suggest
enqueues hundreds of thousands of launches from Python, so suggests running
on several threads at once take the interpreter lock in turn and slow one
another down. On one thread, the requests that arrive while one computation
runs wait in their bucket and flush together after it.

Fail isolation: a slot whose host-side ``prepare`` raises is dropped from
the batch before the device program runs; a device-program failure falls
every slot back to its own sequential ``suggest``, one after another, and
counts it (``batch_fallbacks``); a slot whose decoded suggestions hold non-finite
parameters gets a typed ``TRANSIENT:`` error (``batch_slot_errors``).

Two lanes: slots submitted with ``speculative=True`` (the serving tier's
background pre-compute, ``serving.speculative``) ride a live flush that is
forming anyway, but a bucket holding only speculative slots is deferrable:
it never becomes due while a live slot is queued in any bucket, up to
:data:`SPECULATIVE_STARVATION_CAP_SECS`; due live batches run before due
speculative ones. ``queue_depth()`` / ``live_pending()`` expose per-lane
occupancy, the speculative engine's admission gate.

Weighted fair share (with an admission controller attached,
``VIZIER_TORCH_ADMISSION=1``): inside the live lane, slots carry the tenant
the admission gate admitted (``serving.admission.current_tenant()``), and
when a bucket holds more queued work than one flush, deficit round robin
across tenants (quantum = the tenant's weight) decides who flushes first
instead of FIFO; due batches of one lane are ordered by weighted
served-slot counts across buckets. Without a controller (the default) no
tenant is attached and every bucket is one FIFO, as before.

The JAX package's mesh placements and compile prewarm are not part of the
port; asking for the mesh raises.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vizier_tpu_torch.compute import ir as compute_ir
from vizier_tpu_torch.compute import registry as compute_registry
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.reliability import errors as errors_lib

BucketKey = compute_ir.BucketKey


class BatchSlotError(errors_lib.TransientError):
    """A batched slot produced an invalid result (isolated to its study)."""


# How long a speculative-only bucket defers to queued live slots before it
# flushes anyway ("spec_starved"): it bounds the wait of a live request
# coalesced onto an in-flight speculative compute.
SPECULATIVE_STARVATION_CAP_SECS = 0.25


# -- pytrees ----------------------------------------------------------------
#
# Leaves are tensors and numpy arrays. Containers are dicts, lists, tuples,
# NamedTuples and dataclass instances (the port's GPData, ModelData,
# PaddedArray, MixedFeatures, ...); anything else (models, configs, ints,
# None) is static and taken from the first tree.


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def tree_map(fn: Callable[..., Any], *trees: Any) -> Any:
    """Applies ``fn`` to corresponding leaves of same-structure ``trees``."""
    t0 = trees[0]
    if _is_leaf(t0):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        changes = {}
        for f in dataclasses.fields(t0):
            if not f.init:
                continue
            old = getattr(t0, f.name)
            new = tree_map(fn, *(getattr(t, f.name) for t in trees))
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(t0, **changes) if changes else t0
    return t0


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(lambda x: out.append(x), tree)
    return out


def stack_pytrees(trees: Sequence[Any], pad_to: Optional[int] = None) -> Any:
    """Stacks per-study pytrees along a new leading axis, padding with copies
    of tree 0 up to ``pad_to`` (dropped again at demux). Numpy leaves stack
    on the host (the batch then crosses to the device once, leaf by leaf);
    tensor leaves stack on their device."""
    trees = list(trees)
    if pad_to is not None and pad_to > len(trees):
        trees = trees + [trees[0]] * (pad_to - len(trees))

    def stack(*xs):
        if all(not isinstance(x, torch.Tensor) for x in xs):
            return np.stack([np.asarray(x) for x in xs])
        return torch.stack([torch.as_tensor(x) for x in xs])

    return tree_map(stack, *trees)


def slice_pytree(tree: Any, index: int) -> Any:
    """Slot ``index`` of a leading-study-axis pytree (views, no copies)."""
    return tree_map(lambda a: a[index], tree)


def to_host(tree: Any) -> Any:
    """The tree with every tensor leaf on the host, copied in ONE transfer:
    the leaves' bytes are packed into one buffer on their device, copied,
    and split again into CPU tensors. Numpy leaves stay as they are."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return tree
    flat = []
    for x in leaves:
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        # Each leaf starts 8-byte aligned, so every dtype can view its bytes.
        flat += [raw, torch.zeros(-raw.numel() % 8, dtype=torch.uint8, device=raw.device)]
    host = torch.cat(flat).cpu()
    copies: Dict[int, torch.Tensor] = {}
    offset = 0
    for x, raw, pad in zip(leaves, flat[::2], flat[1::2]):
        n = raw.numel()
        copies[id(x)] = host[offset : offset + n].view(x.dtype).reshape(x.shape)
        offset += n + pad.numel()
    return tree_map(lambda x: copies.get(id(x), x), tree)


def check_finite_suggestions(suggestions: Sequence[Any], study: str = "") -> None:
    """Raises :class:`BatchSlotError` if any numeric parameter is non-finite:
    a NaN escaping one slot degrades only its own study."""
    for s in suggestions:
        for name, value in s.parameters.as_dict().items():
            if isinstance(value, float) and not math.isfinite(value):
                raise BatchSlotError(
                    errors_lib.mark_transient(
                        f"BATCH_SLOT_INVALID: non-finite parameter "
                        f"{name!r}={value!r} in batched suggestion"
                        + (f" for study {study!r}" if study else "")
                    )
                )


class _Slot:
    """One study's pending computation inside a bucket queue.

    ``action`` is the scheduler's verdict, read by the WAITING thread once
    ``event`` fires: "batched" (finalize ``output``) or "alone" (``output``
    holds the suggestions of the plain per-study suggest, which the
    scheduler ran: a lone slot, or a fallback from a failed batch).
    """

    __slots__ = (
        "designer", "program", "count", "enqueued_at", "event", "error",
        "item", "output", "action", "span", "speculative", "tenant",
    )

    def __init__(self, designer, program, count: int, now: float, span,
                 speculative: bool = False, tenant: Optional[str] = None):
        self.designer = designer
        self.program = program
        self.count = count
        self.enqueued_at = now
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.item: Optional[dict] = None
        self.output: Any = None
        self.action: str = "alone"
        self.span = span
        # Speculative lane: the slot may ride a live flush that is forming
        # anyway, but a bucket holding only speculative slots defers to
        # queued live traffic.
        self.speculative = speculative
        # Fair-share identity (admission on only): who this computation
        # bills to inside the live lane's deficit round robin.
        self.tenant = tenant


class BatchExecutor:
    """Continuous-batching engine over shape-bucket queues.

    Callers (one serving thread per study, each holding its study's
    cache-entry lock) block in :meth:`suggest`; a single daemon scheduler
    thread owns flush decisions and runs the batched programs and the lone
    slots' suggests, so device work is serialized.
    """

    def __init__(
        self,
        max_batch_size: int = 8,
        max_wait_ms: float = 4.0,
        pad_partial: bool = True,
        stats: Optional[Any] = None,  # serving.stats.ServingStats
        metrics: Optional[metrics_lib.MetricsRegistry] = None,
        time_fn: Callable[[], float] = time.monotonic,
        mesh: Optional[Any] = None,
        admission: Optional[Any] = None,  # serving.admission.AdmissionController
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if mesh is not None and getattr(mesh, "enabled", True):
            raise NotImplementedError("The port's batch executor has no mesh placements.")
        self.max_batch_size = max_batch_size
        self.max_wait_secs = max(max_wait_ms, 0.0) / 1000.0
        # Weighted fair share across tenants: with a controller attached,
        # live-lane selection is deficit round robin by tenant; None keeps
        # every bucket FIFO.
        self._admission = admission
        # DRR state, guarded by _cond: per-tenant deficit credits, the stable
        # round-robin ring and cursor, and weighted served-slot totals (the
        # cross-bucket ordering key).
        self._drr_deficit: Dict[str, float] = {}
        self._drr_ring: List[str] = []
        self._drr_cursor = 0
        self._tenant_served: Dict[str, float] = {}
        self.pad_partial = pad_partial
        self._stats = stats
        self._time = time_fn
        self._cond = threading.Condition()
        self._queues: Dict[BucketKey, List[_Slot]] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._occupancy = self._flushes = self._queue_wait = None
        if metrics is not None:
            self._occupancy = metrics.histogram(
                "vizier_batch_occupancy",
                help="Real (unpadded) slots per batch flush.",
                buckets=[1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64],
            )
            self._flushes = metrics.counter(
                "vizier_batch_flushes", help="Batch flushes by reason (full | timeout | drain)."
            )
            self._queue_wait = metrics.histogram(
                "vizier_batch_queue_wait_seconds",
                help="Time a slot spent queued before its batch flushed.",
            )

    # -- submission ---------------------------------------------------------

    def suggest(
        self,
        designer: Any,
        count: Optional[int] = None,
        *,
        speculative: bool = False,
    ) -> List[Any]:
        """Routes one study's suggest through the batching engine.

        Unbatchable paths (no program covers the designer's state) run
        inline on the caller's thread, as with batching off. ``speculative``
        puts the slot on the deferrable lane: a bucket of speculative slots
        never flushes while live slots are queued (see :meth:`_take_due`).
        """
        count = count or 1
        resolved = compute_registry.resolve(designer, count)
        if resolved is None or self._closed:
            return designer.suggest(count)
        program, key = resolved
        tenant = None
        if self._admission is not None:
            from vizier_tpu_torch.serving import admission as admission_lib

            tenant = admission_lib.current_tenant()
        slot = _Slot(
            designer, program, count, self._time(), tracing_lib.get_tracer().current_span(),
            speculative=speculative, tenant=tenant,
        )
        # Joining a non-empty bucket: this slot will (very likely) ride a
        # batched flush, so prepare it HERE, on the caller's thread, while
        # the flush forms. An empty bucket stays unprepared: if nobody joins
        # before the window closes, the slot takes the plain suggest.
        with self._cond:
            will_batch = bool(self._queues.get(key))
        if will_batch:
            try:
                slot.item = program.prepare(designer, count)
            except BaseException:
                self._increment("batch_slot_errors")
                raise
        with self._cond:
            closed = self._closed
            if not closed:
                self._ensure_scheduler()
                self._queues.setdefault(key, []).append(slot)
                self._cond.notify_all()
        if closed:
            return designer.suggest(count)
        slot.event.wait()
        return self._complete(slot)

    def _complete(self, slot: _Slot) -> List[Any]:
        """Runs the scheduler's verdict on the waiting thread."""
        if slot.error is not None:
            raise slot.error
        if slot.action == "batched":
            try:
                suggestions = list(slot.program.finalize(slot.designer, slot.item, slot.output))
                check_finite_suggestions(suggestions)
            except BaseException:
                self._increment("batch_slot_errors")
                raise
            self._increment("batched_suggests")
            return suggestions
        return slot.output  # "alone"

    def close(self) -> None:
        """Drains every queue (reason "drain") and stops the scheduler."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30.0)

    def pending_counts(self) -> Dict[str, int]:
        with self._cond:
            return {k.label(): len(v) for k, v in self._queues.items() if v}

    def queue_depth(self) -> Dict[str, int]:
        """Queued slots by lane — the speculative admission gate's view of
        whether live traffic is saturating the flush buckets."""
        with self._cond:
            queued = [slot.speculative for slots in self._queues.values() for slot in slots]
        return {"live": queued.count(False), "speculative": queued.count(True)}

    def live_pending(self) -> int:
        """Queued live (non-speculative) slots across all buckets."""
        return self.queue_depth()["live"]

    # -- scheduling ---------------------------------------------------------

    def _ensure_scheduler(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._scheduler_loop, name="vizier-torch-batch-executor", daemon=True
            )
            self._thread.start()

    @staticmethod
    def _deferrable(slots: List[_Slot]) -> bool:
        """A bucket of speculative slots only; one live slot makes the
        bucket live (the speculative ones ride its flush)."""
        return all(s.speculative for s in slots)

    def _live_queued(self) -> bool:
        return any(not s.speculative for slots in self._queues.values() for s in slots)

    def _fair_order(self, slots: List[_Slot]) -> List[_Slot]:
        """Deficit round robin across tenants, FIFO within a tenant.

        Quantum = the tenant's admission weight. Persistent ring, cursor and
        deficit state (caller holds ``_cond``) make the rotation fair across
        flushes, not just within one: a light tenant's first queued slot is
        selected within one DRR round, i.e. delayed by at most the sum of
        the other tenants' quanta. Single-tenant (or tenantless) input
        returns FIFO unchanged.
        """
        by_tenant: Dict[str, Deque[_Slot]] = collections.OrderedDict()
        for slot in slots:
            by_tenant.setdefault(slot.tenant or "", collections.deque()).append(slot)
        if len(by_tenant) <= 1:
            return slots
        for tenant in by_tenant:
            if tenant not in self._drr_ring:
                self._drr_ring.append(tenant)
        weight = self._admission.weight
        out: List[_Slot] = []
        remaining = len(slots)
        ring = self._drr_ring
        while remaining:
            self._drr_cursor %= len(ring)
            tenant = ring[self._drr_cursor]
            self._drr_cursor += 1
            queue = by_tenant.get(tenant)
            if not queue:
                # Classic DRR: an idle tenant banks no credit.
                self._drr_deficit.pop(tenant, None)
                continue
            quantum = max(1.0, float(weight(tenant)))
            credit = self._drr_deficit.get(tenant, 0.0) + quantum
            while credit >= 1.0 and queue:
                out.append(queue.popleft())
                remaining -= 1
                credit -= 1.0
            self._drr_deficit[tenant] = credit if queue else 0.0
        return out

    def _order_due(
        self, due: List[Tuple[BucketKey, List[_Slot], str]]
    ) -> List[Tuple[BucketKey, List[_Slot], str]]:
        """Cross-bucket fairness: stable-sort one lane's due batches by
        their tenants' weighted served-slot totals (least served first),
        then bill the selection — every flush is billed, even a lone one.
        No-op without an admission controller."""
        if self._admission is None:
            return due
        weight = self._admission.weight
        if len(due) > 1:

            def served_key(batch):
                _key, slots, _reason = batch
                return min(
                    self._tenant_served.get(s.tenant or "", 0.0) / max(1.0, float(weight(s.tenant)))
                    for s in slots
                )

            due = sorted(due, key=served_key)
        for _key, slots, _reason in due:
            for slot in slots:
                self._tenant_served[slot.tenant or ""] = (
                    self._tenant_served.get(slot.tenant or "", 0.0) + 1.0
                )
        return due

    def _take_due(self) -> List[Tuple[BucketKey, List[_Slot], str]]:
        """Pops every due (key, slots, reason) batch. Caller holds the lock.

        Lane rules: a live bucket flushes on the ordinary full/timeout
        rules. A speculative-only bucket defers while any live slot is
        queued anywhere, flushing only once the queues are clear of live
        work, or after :data:`SPECULATIVE_STARVATION_CAP_SECS`
        ("spec_starved"). Due live batches come back before due speculative
        ones; within a lane, batches are ordered by the weighted fair-share
        credit when admission is on.
        """
        now = self._time()
        # Index 0: live (and drained) batches; index 1: speculative ones.
        due_by_lane: Tuple[List, List] = ([], [])
        deferred: List[Tuple[BucketKey, List[_Slot]]] = []
        live_queued = self._live_queued()
        for key, slots in self._queues.items():
            if not slots:
                continue
            if self._closed:
                due_by_lane[0].append((key, slots[:], "drain"))
                slots.clear()
                continue
            deferrable = self._deferrable(slots)
            if deferrable and live_queued:
                deferred.append((key, slots))
                continue
            bucket_due = due_by_lane[int(deferrable)]
            if len(slots) >= self.max_batch_size:
                ordered = (
                    self._fair_order(slots)
                    if self._admission is not None and not deferrable
                    else slots
                )
                while len(ordered) >= self.max_batch_size:
                    bucket_due.append((key, ordered[: self.max_batch_size], "full"))
                    del ordered[: self.max_batch_size]
                slots[:] = ordered
            # Oldest by enqueue time, not position: a DRR-reordered
            # remainder is no longer FIFO.
            if slots and now - min(s.enqueued_at for s in slots) >= self.max_wait_secs:
                bucket_due.append((key, slots[:], "timeout"))
                slots.clear()
        for key, slots in deferred:
            if now - slots[0].enqueued_at < SPECULATIVE_STARVATION_CAP_SECS:
                continue
            # A deferred bucket may have grown past the batch size: flush in
            # max-size chunks so the batch shape stays the bucket's.
            bucket_due = due_by_lane[1]
            while len(slots) > self.max_batch_size:
                bucket_due.append((key, slots[: self.max_batch_size], "full"))
                del slots[: self.max_batch_size]
            bucket_due.append((key, slots[:], "spec_starved"))
            slots.clear()
        return self._order_due(due_by_lane[0]) + self._order_due(due_by_lane[1])

    def _next_deadline(self) -> Optional[float]:
        """Seconds until the next queued bucket becomes due (lock held)."""
        live_queued = self._live_queued()
        deadline = None
        for slots in self._queues.values():
            if not slots:
                continue
            if live_queued and self._deferrable(slots):
                window = SPECULATIVE_STARVATION_CAP_SECS
            else:
                window = self.max_wait_secs
            due_at = min(s.enqueued_at for s in slots) + window
            if deadline is None or due_at < deadline:
                deadline = due_at
        if deadline is None:
            return None
        return max(deadline - self._time(), 0.0)

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                due = self._take_due()
                if not due:
                    if self._closed:
                        return
                    self._cond.wait(timeout=self._next_deadline())
                    continue
            for key, slots, reason in due:
                self._execute(key, slots, reason)

    # -- execution ----------------------------------------------------------

    def _increment(self, field: str, amount: int = 1) -> None:
        if self._stats is not None and amount:
            self._stats.increment(field, amount)

    def _observe_flush(self, key: BucketKey, slots: List[_Slot], reason: str) -> None:
        now = self._time()
        label = key.label()
        if self._flushes is not None:
            self._flushes.inc(reason=reason)
            self._occupancy.observe(len(slots), bucket=label)
            for slot in slots:
                self._queue_wait.observe(now - slot.enqueued_at, bucket=label)
        self._increment("batch_flushes")
        recorder = recorder_lib.get_recorder()
        if recorder.enabled:
            # Flush membership: the member suggests' trace ids tie this
            # fleet-scoped event back to each study's own ring.
            recorder.record(
                None,
                "batch_flush",
                bucket=label,
                occupancy=len(slots),
                reason=reason,
                device=None,
                members=[s.span.trace_id for s in slots if s.span is not None],
            )

    def _execute(self, key: BucketKey, slots: List[_Slot], reason: str) -> None:
        self._observe_flush(key, slots, reason)
        tracer = tracing_lib.get_tracer()
        with tracer.span(
            "batch_executor.flush", bucket=key.label(), occupancy=len(slots), reason=reason
        ) as span:
            for slot in slots:
                if slot.span is not None and span is not None:
                    span.add_link(slot.span.context(), name="batch_member")
                    slot.span.add_link(span.context(), name="batch_flush")
                    slot.span.set_attribute("batch_occupancy", len(slots))
            if len(slots) == 1 and slots[0].item is None:
                # No batchmates and never prepared: the plain sequential
                # suggest, run here (see the module docstring).
                self._run_alone(slots[0])
                return
            self._execute_batched(slots)

    @staticmethod
    def _run_alone(slot: _Slot) -> None:
        """The slot's plain sequential suggest, on the scheduler thread."""
        try:
            slot.output = list(slot.designer.suggest(slot.count))
        except BaseException as e:  # raised again on the waiting thread
            slot.error = e
        slot.action = "alone"
        slot.event.set()

    def _execute_batched(self, slots: List[_Slot]) -> None:
        # Prepare any slot that arrived into an empty bucket; a study whose
        # prepare raises is dropped before the device program runs.
        live: List[_Slot] = []
        for slot in slots:
            if slot.item is None:
                try:
                    slot.item = slot.program.prepare(slot.designer, slot.count)
                except BaseException as e:
                    slot.error = e
                    self._increment("batch_slot_errors")
                    slot.event.set()
                    continue
            live.append(slot)
        if not live:
            return
        program = live[0].program
        pad_to = self.max_batch_size if self.pad_partial else None
        try:
            outputs = program.device_program([slot.item for slot in live], pad_to=pad_to)
        except BaseException:
            # The shared device program died: every slot retries alone, one
            # after another, and each fallback is counted.
            tracing_lib.add_current_event("batch_executor.fallback_sequential", slots=len(live))
            for slot in live:
                self._increment("batch_fallbacks")
                self._run_alone(slot)
            return
        for slot, output in zip(live, outputs):
            slot.output = output
            slot.action = "batched"
            slot.event.set()
