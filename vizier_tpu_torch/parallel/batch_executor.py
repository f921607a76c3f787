"""Cross-study continuous batching: N same-shape studies, one device batch.

Counterpart of the JAX package's ``parallel/batch_executor.py``. The
padding schedule (``converters.padding``) quantizes trials and features into
a small grid of ``(pad_trials, cont_width, cat_width)`` buckets, so
concurrent designer computations from *different* studies are collected
into shape-bucket queues and run as one program over a leading
study axis (``DesignerProgram.device_program``): N studies' work in the
kernel launches of one.

Scheduling is a bounded micro-batch window: a bucket flushes when it reaches
``max_batch_size`` slots ("full") or when its oldest slot has waited
``max_wait_ms`` ("timeout"). Partial batches are padded to
``max_batch_size`` with copies of slot 0 that are dropped at demux. A lone
slot that was never prepared takes the designer's ordinary ``suggest``.

Every computation of the executor runs on its one scheduler thread (or, on a
mesh of several placements, on the bucket's placement worker), a lone
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

Priority lanes (N-lane): every slot rides a named :class:`LaneSpec` lane.
The default table has two, ``live`` (priority 0) and ``speculative``
(priority 1, deferrable): slots submitted with ``speculative=True`` (the
serving tier's background pre-compute, ``serving.speculative``) ride a live
flush that is forming anyway, but a bucket holding only deferrable-lane
slots waits for the idle window: it never becomes due while a slot of a
lower priority number is queued in any bucket, up to its lane's
``starvation_cap_ms``, and due batches run in lane-priority order. Another
QoS class is one more ``LaneSpec`` (``lanes=``, ``suggest(..., lane=)``).
``queue_depth()`` / ``live_pending()`` expose per-lane occupancy, the
speculative engine's admission gate.

Weighted fair share (with an admission controller attached,
``VIZIER_TORCH_ADMISSION=1``): inside the live lane, slots carry the tenant
the admission gate admitted (``serving.admission.current_tenant()``), and
when a bucket holds more queued work than one flush, deficit round robin
across tenants (quantum = the tenant's weight) decides who flushes first
instead of FIFO; due batches of one lane are ordered by weighted
served-slot counts across buckets. Without a controller (the default) no
tenant is attached and every bucket is one FIFO, as before.

Prewarm (:meth:`BatchExecutor.prewarm`) walks a search space's padding-bucket
grid before live traffic: it builds the kernel library and runs one flush per
(bucket, count, batch size in {1, max}) over synthetic studies, so every
layout's CUDA graphs (``optimizers/graphs.py``) are captured before a live
flush needs them. Its device work runs on the scheduler thread between
flushes, as every computation of the executor does, so a capture never
overlaps another thread's launches and the graphs are captured on the thread
that replays them.

Mesh execution plane (``parallel.mesh``, opt-in ``VIZIER_TORCH_MESH=1``): the
host's devices are carved into placements and each bucket is sticky-assigned
to one (least loaded on its first flush). A shardable program's flush on a
placement pads at shard granularity (``DevicePlacement.pad_to``: the next
power-of-two multiple of its device count) instead of to ``max_batch_size``,
and gets the placement, which splits its study axis over the placement's
devices (:func:`place_batch`). With exactly one placement the scheduler
thread still runs every flush, as above: a placement worker beside it doubled
the loadgen soak's GP suggest p50 on an H100. With two or more, each
placement has one worker thread (``vizier-mesh-worker-<i>``) that runs every
launch of its buckets (flushes, lone slots, fallbacks, prewarm steps), so a
capture on a device never overlaps another thread's launches there; the
scheduler then only forms flushes. On a mesh that spans processes
(``parallel.initialize_multihost``) the executor assigns buckets only to the
placements of its own process's devices, and refuses a placement that spans
processes when it is built: one process cannot make another enter its flush.
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


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One QoS lane of the executor's N-lane scheduler.

    ``priority`` orders execution (lower number first). A ``deferrable``
    lane's buckets wait for the idle window (they become due only while no
    slot of a strictly lower priority number is queued anywhere) except after
    ``starvation_cap_ms``, the bounded-starvation escape (0: the ordinary
    flush window applies even while deferring).
    """

    name: str
    priority: int
    deferrable: bool = False
    starvation_cap_ms: float = 0.0


LANE_LIVE = "live"
LANE_SPECULATIVE = "speculative"


def default_lanes(speculative_max_wait_ms: float) -> Tuple[LaneSpec, ...]:
    """The two-lane table: live traffic and the deferrable speculative
    pre-compute lane, whose starvation cap bounds how long a live request
    coalesced onto an in-flight speculative compute waits."""
    return (
        LaneSpec(LANE_LIVE, priority=0),
        LaneSpec(LANE_SPECULATIVE, priority=1, deferrable=True,
                 starvation_cap_ms=speculative_max_wait_ms),
    )


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


def place_batch(tree: Any, placement: Optional[Any] = None) -> List[Any]:
    """A stacked flush pytree as the chunks its devices run: ``[tree]`` with
    no placement, else one chunk per device of the placement
    (``DevicePlacement.shard``). The shardable programs route their stacked
    inputs through this."""
    if placement is None:
        return [tree]
    return placement.shard(tree)


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
        "item", "output", "action", "span", "lane", "tenant",
    )

    def __init__(self, designer, program, count: int, now: float, span,
                 lane: str = LANE_LIVE, tenant: Optional[str] = None):
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
        # QoS lane (LaneSpec.name): a deferrable-lane slot may ride a flush
        # of a lower priority number that is forming anyway, but a bucket
        # holding only deferrable slots defers to queued priority traffic.
        self.lane = lane
        # Fair-share identity (admission on only): who this computation
        # bills to inside the live lane's deficit round robin.
        self.tenant = tenant

    @property
    def speculative(self) -> bool:
        return self.lane == LANE_SPECULATIVE


class BatchExecutor:
    """Continuous-batching engine over shape-bucket queues.

    Callers (one serving thread per study, each holding its study's
    cache-entry lock) block in :meth:`suggest`; a single daemon scheduler
    thread owns flush decisions and runs the batched programs and the lone
    slots' suggests, so device work is serialized. On a mesh of several
    placements it hands each flush to its placement's worker thread instead.
    """

    def __init__(
        self,
        max_batch_size: int = 8,
        max_wait_ms: float = 4.0,
        pad_partial: bool = True,
        stats: Optional[Any] = None,  # serving.stats.ServingStats
        metrics: Optional[metrics_lib.MetricsRegistry] = None,
        time_fn: Callable[[], float] = time.monotonic,
        speculative_max_wait_ms: float = 250.0,
        mesh: Optional[Any] = None,  # parallel.mesh.MeshConfig
        lanes: Optional[Sequence[LaneSpec]] = None,
        admission: Optional[Any] = None,  # serving.admission.AdmissionController
        device: Any = "cuda",
    ):
        """``device`` names the device type whose devices an enabled ``mesh``
        carves into placements (the designers' own device type)."""
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        self.max_batch_size = max_batch_size
        self.max_wait_secs = max(max_wait_ms, 0.0) / 1000.0
        # The N-lane QoS table by lane name; a slot's unknown lane name
        # follows the live lane's rules. ``speculative_max_wait_ms`` is the
        # default table's speculative starvation cap.
        lane_table = tuple(lanes) if lanes else default_lanes(speculative_max_wait_ms)
        self._lanes: Dict[str, LaneSpec] = {lane.name: lane for lane in lane_table}
        self._live_lane = min(self._lanes.values(), key=lambda lane: lane.priority)
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
        # Work handed to the scheduler thread to run between flushes
        # (prewarm steps): (fn, done event, [result, error]).
        self._tasks: Deque[Tuple[Callable[[], Any], threading.Event, list]] = (
            collections.deque())
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # -- mesh execution plane (parallel.mesh, VIZIER_TORCH_MESH=1) -------
        # Placements are built only when the config enables the mesh; None
        # keeps every mesh branch below dead. On a mesh of several processes
        # only this process's own placements are kept: buckets go to them
        # alone.
        self._placements: Optional[List[Any]] = None
        # Per-placement dispatch queues and workers, used with two or more
        # placements: entries are ("flush", key, slots, reason) or ("task",
        # fn, done event, [result, error]).
        self._workers: List[threading.Thread] = []
        self._dispatch_cond = threading.Condition()
        self._dispatch_queues: Dict[int, Deque[tuple]] = {}
        self._dispatch_closed = False
        # BucketKey -> placement index, sticky from the first flush (the
        # prewarm walker assigns through the same map). Guarded by
        # _dispatch_cond.
        self._bucket_placement: Dict[BucketKey, int] = {}
        # Flushes per placement label; each entry is written only by the
        # thread that runs its placement's flushes.
        self._placement_flushes: Dict[str, int] = {}
        if mesh is not None and getattr(mesh, "enabled", False):
            from vizier_tpu_torch.parallel import mesh as mesh_lib

            placements = mesh_lib.build_placements(mesh, device)
            for placement in placements:
                if placement.spans_processes:
                    # One process cannot make another enter its flush.
                    raise ValueError(
                        f"Placement {placement.describe()} spans processes; a batch "
                        f"executor runs only placements of its own process's devices "
                        f"(make shard_devices divide each process's device count).")
            self._placements = [p for p in placements if p.is_local]
            if not self._placements:
                raise ValueError("No placement holds a device of this process.")
            for placement in self._placements:
                self._dispatch_queues[placement.index] = collections.deque()
                self._placement_flushes[placement.label()] = 0
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
        lane: Optional[str] = None,
    ) -> List[Any]:
        """Routes one study's suggest through the batching engine.

        Unbatchable paths (no program covers the designer's state) run
        inline on the caller's thread, as with batching off. ``speculative``
        (or an explicit ``lane`` name) marks the slot's QoS lane: a
        deferrable lane's bucket never flushes while slots of a lower
        priority number are queued (see :meth:`_take_due`).
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
            lane=lane or (LANE_SPECULATIVE if speculative else LANE_LIVE), tenant=tenant,
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
        """Drains every queue (reason "drain") and stops the scheduler, and
        then the placement workers, which run the drained flushes the
        scheduler handed them first."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30.0)
        if self._placements is not None:
            with self._dispatch_cond:
                self._dispatch_closed = True
                self._dispatch_cond.notify_all()
            for worker in self._workers:
                worker.join(timeout=30.0)

    def pending_counts(self) -> Dict[str, int]:
        with self._cond:
            return {k.label(): len(v) for k, v in self._queues.items() if v}

    # -- mesh introspection -------------------------------------------------

    @property
    def mesh_enabled(self) -> bool:
        return self._placements is not None

    def placements(self) -> List[Any]:
        """This process's device placements (empty when the mesh plane is
        off)."""
        return list(self._placements or [])

    def placement_flush_counts(self) -> Dict[str, int]:
        """Flushes run per placement label (mesh on only)."""
        return dict(self._placement_flushes)

    def bucket_placements(self) -> Dict[str, List[str]]:
        """Sticky bucket -> placements, by bucket label (which omits the
        statics, so one label may hold several keys' placements)."""
        if self._placements is None:
            return {}
        by_index = {p.index: p.label() for p in self._placements}
        out: Dict[str, List[str]] = {}
        with self._dispatch_cond:
            for key, idx in self._bucket_placement.items():
                out.setdefault(key.label(), []).append(by_index[idx])
        return {label: sorted(placements) for label, placements in out.items()}

    def _placement_for(self, key: BucketKey) -> Any:
        """The placement sticky-assigned to ``key``: the least loaded on its
        first sight, the same ever after. Caller must not hold
        ``_dispatch_cond``."""
        with self._dispatch_cond:
            index = self._bucket_placement.get(key)
            if index is None:
                load: Dict[int, int] = {p.index: 0 for p in self._placements}
                for assigned in self._bucket_placement.values():
                    load[assigned] += 1
                index = min(load, key=lambda i: (load[i], i))
                self._bucket_placement[key] = index
        return next(p for p in self._placements if p.index == index)

    def _uses_workers(self) -> bool:
        """Two or more placements of this process: each runs its buckets on
        its own worker."""
        return self._placements is not None and len(self._placements) > 1

    def queue_depth(self) -> Dict[str, int]:
        """Queued slots by lane name, every lane of the table listed (a slot
        of an unknown lane counts as live) — the speculative admission
        gate's view of whether live traffic is saturating the buckets."""
        out = {name: 0 for name in self._lanes}
        with self._cond:
            for slots in self._queues.values():
                for slot in slots:
                    out[slot.lane if slot.lane in out else self._live_lane.name] += 1
        return out

    def live_pending(self) -> int:
        """Queued live (non-speculative) slots across all buckets."""
        return self.queue_depth()[LANE_LIVE]

    # -- scheduling ---------------------------------------------------------

    def _ensure_scheduler(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._scheduler_loop, name="vizier-torch-batch-executor", daemon=True
            )
            self._thread.start()
        if self._uses_workers() and not self._workers:
            self._workers = [
                threading.Thread(
                    target=self._worker_loop, args=(placement,),
                    name=f"vizier-mesh-worker-{placement.index}", daemon=True,
                )
                for placement in self._placements
            ]
            for worker in self._workers:
                worker.start()

    def _lane_for(self, slot: _Slot) -> LaneSpec:
        return self._lanes.get(slot.lane, self._live_lane)

    def _bucket_lane(self, slots: List[_Slot]) -> LaneSpec:
        """A bucket's effective lane: the lowest priority number among its
        slots (a deferrable slot rides a priority flush that is forming
        anyway)."""
        return min((self._lane_for(s) for s in slots), key=lambda lane: lane.priority)

    def _min_queued_priority(self) -> int:
        return min((self._lane_for(s).priority for slots in self._queues.values() for s in slots),
                   default=0)

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

        Lane rules: a bucket whose effective lane is not deferrable flushes
        on the ordinary full/timeout rules. A deferrable-lane bucket defers
        while any slot of a strictly lower priority number is queued
        anywhere, flushing only once the queues are clear of priority work,
        or after the lane's ``starvation_cap_ms`` ("spec_starved"). Due
        batches come back in ascending lane priority, drains at priority 0;
        one priority's batches are ordered by the weighted fair-share credit
        when admission is on.
        """
        now = self._time()
        due_by_priority: Dict[int, List[Tuple[BucketKey, List[_Slot], str]]] = {}
        deferred: List[Tuple[BucketKey, List[_Slot], LaneSpec]] = []
        min_queued_priority = self._min_queued_priority()
        for key, slots in self._queues.items():
            if not slots:
                continue
            if self._closed:
                due_by_priority.setdefault(0, []).append((key, slots[:], "drain"))
                slots.clear()
                continue
            lane = self._bucket_lane(slots)
            if lane.deferrable and min_queued_priority < lane.priority:
                deferred.append((key, slots, lane))
                continue
            bucket_due = due_by_priority.setdefault(lane.priority, [])
            if len(slots) >= self.max_batch_size:
                ordered = (
                    self._fair_order(slots)
                    if self._admission is not None and not lane.deferrable
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
        for key, slots, lane in deferred:
            if now - slots[0].enqueued_at < max(lane.starvation_cap_ms, 0.0) / 1000.0:
                continue
            # A deferred bucket may have grown past the batch size: flush in
            # max-size chunks so the batch shape stays the bucket's.
            bucket_due = due_by_priority.setdefault(lane.priority, [])
            while len(slots) > self.max_batch_size:
                bucket_due.append((key, slots[: self.max_batch_size], "full"))
                del slots[: self.max_batch_size]
            bucket_due.append((key, slots[:], "spec_starved"))
            slots.clear()
        out: List[Tuple[BucketKey, List[_Slot], str]] = []
        for priority in sorted(due_by_priority):
            out.extend(self._order_due(due_by_priority[priority]))
        return out

    def _next_deadline(self) -> Optional[float]:
        """Seconds until the next queued bucket becomes due (lock held)."""
        min_queued_priority = self._min_queued_priority()
        deadline = None
        for slots in self._queues.values():
            if not slots:
                continue
            lane = self._bucket_lane(slots)
            if lane.deferrable and min_queued_priority < lane.priority:
                window = max(lane.starvation_cap_ms, 0.0) / 1000.0
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
                tasks = list(self._tasks)
                self._tasks.clear()
                due = self._take_due()
                if not due and not tasks:
                    if self._closed:
                        self._signal_workers_closed()
                        return
                    self._cond.wait(timeout=self._next_deadline())
                    continue
            for fn, done, outcome in tasks:
                self._run_task(fn, done, outcome)
            for key, slots, reason in due:
                if not self._uses_workers():
                    # No mesh, or one placement: the scheduler runs the flush.
                    self._execute(key, slots, reason,
                                  self._placements[0] if self._placements else None)
                    continue
                # Several placements: the scheduler only forms flushes; the
                # bucket's placement worker runs it.
                placement = self._placement_for(key)
                with self._dispatch_cond:
                    self._dispatch_queues[placement.index].append(("flush", key, slots, reason))
                    self._dispatch_cond.notify_all()

    @staticmethod
    def _run_task(fn: Callable[[], Any], done: threading.Event, outcome: list) -> None:
        try:
            outcome[0] = fn()
        except BaseException as e:  # raised again on the waiting thread
            outcome[1] = e
        done.set()

    def _signal_workers_closed(self) -> None:
        if self._placements is None:
            return
        with self._dispatch_cond:
            self._dispatch_closed = True
            self._dispatch_cond.notify_all()

    def _worker_loop(self, placement: Any) -> None:
        """One placement's thread: runs its queued flushes and tasks in order,
        popped under the dispatch lock and run outside it."""
        queue = self._dispatch_queues[placement.index]
        while True:
            with self._dispatch_cond:
                while not queue and not self._dispatch_closed:
                    self._dispatch_cond.wait()
                if not queue:
                    return
                entry = queue.popleft()
            if entry[0] == "task":
                self._run_task(*entry[1:])
            else:
                self._execute(*entry[1:], placement)

    def _run_on_scheduler(self, fn: Callable[[], Any], placement: Optional[Any] = None) -> Any:
        """Runs ``fn()`` between flushes on the thread that runs
        ``placement``'s flushes (the scheduler, or with several placements
        that placement's worker) and returns its result (its exception is
        raised here)."""
        done, outcome = threading.Event(), [None, None]
        with self._cond:
            if self._closed:
                raise RuntimeError("The batch executor is closed.")
            self._ensure_scheduler()
            if placement is None or not self._uses_workers():
                self._tasks.append((fn, done, outcome))
                self._cond.notify_all()
            else:
                with self._dispatch_cond:
                    self._dispatch_queues[placement.index].append(("task", fn, done, outcome))
                    self._dispatch_cond.notify_all()
        done.wait()
        if outcome[1] is not None:
            raise outcome[1]
        return outcome[0]

    # -- execution ----------------------------------------------------------

    def _increment(self, field: str, amount: int = 1) -> None:
        if self._stats is not None and amount:
            self._stats.increment(field, amount)

    def _observe_flush(
        self, key: BucketKey, slots: List[_Slot], reason: str, placement: Optional[Any] = None
    ) -> None:
        now = self._time()
        label = key.label()
        # The device label exists only on a mesh, so the series of the
        # executor without one stay as they were.
        device = {"device": placement.label()} if placement is not None else {}
        if self._flushes is not None:
            self._flushes.inc(reason=reason, **device)
            self._occupancy.observe(len(slots), bucket=label, **device)
            for slot in slots:
                self._queue_wait.observe(now - slot.enqueued_at, bucket=label, **device)
        self._increment("batch_flushes")
        if placement is not None:
            self._increment("mesh_flushes")
            self._placement_flushes[placement.label()] += 1
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
                device=placement.label() if placement is not None else None,
                members=[s.span.trace_id for s in slots if s.span is not None],
            )

    def _execute(
        self, key: BucketKey, slots: List[_Slot], reason: str, placement: Optional[Any] = None
    ) -> None:
        self._observe_flush(key, slots, reason, placement)
        tracer = tracing_lib.get_tracer()
        device_attr = {"device": placement.label()} if placement is not None else {}
        with tracer.span(
            "batch_executor.flush", bucket=key.label(), occupancy=len(slots), reason=reason,
            **device_attr,
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
            self._execute_batched(slots, placement)

    @staticmethod
    def _run_alone(slot: _Slot) -> None:
        """The slot's plain sequential suggest, on the scheduler thread."""
        try:
            slot.output = list(slot.designer.suggest(slot.count))
        except BaseException as e:  # raised again on the waiting thread
            slot.error = e
        slot.action = "alone"
        slot.event.set()

    def _execute_batched(self, slots: List[_Slot], placement: Optional[Any] = None) -> None:
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
        try:
            outputs = self._run_program(program, [slot.item for slot in live], placement)
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

    def _run_program(self, program: Any, items: List[dict], placement: Optional[Any]) -> List[Any]:
        """The program's device body over ``items``. A shardable program on a
        placement pads at shard granularity (``DevicePlacement.pad_to``) and
        gets the placement, which splits its study axis over the devices;
        anything else pads to ``max_batch_size`` (with ``pad_partial``)."""
        if placement is not None and getattr(program, "shardable_batch_axis", ""):
            return program.device_program(
                items, pad_to=placement.pad_to(len(items), self.max_batch_size),
                placement=placement,
            )
        return program.device_program(
            items, pad_to=self.max_batch_size if self.pad_partial else None)

    # -- prewarm ------------------------------------------------------------

    def prewarm(
        self,
        problem: Any,  # pyvizier ProblemStatement
        designer_factory: Callable[..., Any],
        *,
        max_trials: int = 32,
        counts: Sequence[int] = (1,),
        batch_sizes: Optional[Sequence[int]] = None,
        rng_seed: int = 0,
    ) -> List[dict]:
        """Walks the padding-bucket grid and captures each layout's graphs.

        Builds the kernel library when the designers run on CUDA, then for
        every ``pad_trials`` bucket covering studies up to ``max_trials`` and
        every requested suggestion ``count``, trains and sweeps synthetic
        studies once at batch sizes {1, max}: 1 runs a study's sequential
        suggest (the lone-slot path), max the padded flush every batched
        bucket runs (with ``pad_partial``, the only batched layout); on a mesh
        the batched sizes are the placements' padding grids
        (``DevicePlacement.pad_grid``) and each bucket's steps run through its
        sticky placement, on the thread that will run its live flushes. A
        bucket's first live flush then captures no CUDA graph. Returns one
        report row per (bucket, count, batch size): its wall seconds, the
        graphs it captured and its status (a failed step is reported, not
        raised: prewarm must never block serving).
        """
        from vizier_tpu_torch.algorithms import core as core_lib
        from vizier_tpu_torch.designers import quasi_random
        from vizier_tpu_torch.ops import native
        from vizier_tpu_torch.optimizers import graphs as graphs_lib
        from vizier_tpu_torch.pyvizier import trial as trial_

        if batch_sizes:
            sizes = tuple(batch_sizes)
        elif self._placements is not None:
            grid = sorted({size for placement in self._placements
                           for size in placement.pad_grid(self.max_batch_size)})
            sizes = tuple([1] + [s for s in grid if s != 1])
        else:
            sizes = (1, self.max_batch_size)
        probe = designer_factory(problem)
        if torch.device(getattr(probe, "device", "cpu")).type == "cuda":
            native.library()
        schedule = probe._converter.padding
        report: List[dict] = []
        for bucket in schedule.trial_bucket_grid(max_trials):
            for count in counts:
                for size in sizes:
                    t0 = time.perf_counter()
                    designers = []
                    for j in range(size):
                        d = designer_factory(problem)
                        seeder = quasi_random.QuasiRandomDesigner(
                            problem.search_space, seed=rng_seed + j
                        )
                        trials = []
                        for i, s in enumerate(seeder.suggest(bucket)):
                            t = s.to_trial(i + 1)
                            t.complete(
                                trial_.Measurement(
                                    metrics={
                                        m.name: 0.1 * ((i + j) % 7)
                                        for m in problem.metric_information
                                    }
                                )
                            )
                            trials.append(t)
                        d.update(core_lib.CompletedTrials(trials))
                        designers.append(d)
                    status = "ok"
                    captures = graphs_lib.STATS["captures"]
                    try:
                        self._prewarm_on_placement(designers, count, size)
                    except Exception as e:  # prewarm must never block serving
                        status = f"error:{type(e).__name__}"
                    captures = graphs_lib.STATS["captures"] - captures
                    report.append(
                        dict(
                            pad_trials=bucket,
                            count=count,
                            batch_size=size,
                            seconds=round(time.perf_counter() - t0, 4),
                            captures=captures,
                            status=status,
                        )
                    )
        return report

    def _prewarm_on_placement(self, designers: List[Any], count: int, size: int) -> None:
        """One synthetic flush, on the thread and placement that will run the
        bucket's live flushes: the lone suggest at size 1, else the padded
        batch through the designers' resolved program."""
        # Resolution refreshes each designer's surrogate mode, which prepare
        # snapshots into its item, and names the program and the bucket.
        resolved = [compute_registry.resolve(d, count) for d in designers]
        placement = None
        if self._placements is not None and resolved[0] is not None:
            placement = self._placement_for(resolved[0][1])
        self._run_on_scheduler(
            lambda: self._prewarm_step(designers, count, size, resolved, placement), placement)

    def _prewarm_step(self, designers: List[Any], count: int, size: int, resolved: List[Any],
                      placement: Optional[Any]) -> None:
        if size == 1 or any(r is None for r in resolved):
            designers[0].suggest(count)
            return
        program, _ = resolved[0]
        items = [program.prepare(d, count) for d in designers]
        outputs = self._run_program(program, items, placement)
        for d, item, out in zip(designers, items, outputs):
            program.finalize(d, item, out)
