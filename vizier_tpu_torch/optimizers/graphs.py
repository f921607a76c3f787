"""CUDA-graph capture and replay for fixed-shape optimizer steps.

A GP suggest on the card is host-bound: one Adam step of the ARD loss
(forward, autograd backward, update) is a few hundred small launches, each
costing more host time than device time, so a 10-step train of a 2-D study
takes tens of milliseconds of interpreter and dispatcher work. A step reads
nothing back to the host, so its launches are the same on every call with
inputs of the same layout: they are captured once into a CUDA graph and
replayed, the way the JAX package compiles its loop once per shape and runs
it again.

A loss names its tensor inputs (:class:`BoundLoss`), so a captured step can
run on its own copies of them. :func:`cached` keeps what a caller builds from
captures by a key the caller derives from the inputs' layout
(:func:`layout`: every tensor's shape, dtype and device, every other value as
it is) and the loss function (:func:`fn_key`: its owner, a frozen model
config, compared by value).

The kernels' launch counters (``models.kernels``) count a replay's launches
when it replays, not while they are captured.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from vizier_tpu_torch.models import kernels

Tensor = torch.Tensor

_logger = logging.getLogger(__name__)

# Entries kept at once (least recently used dropped first). Serving traffic
# sees a handful of layouts: padded trial counts × studies per flush.
MAX_ENTRIES = 64


class BoundLoss:
    """``fn(params, inputs)`` as a loss of the params alone, with the tensors
    it reads named, so a captured step can run it on its own copies."""

    __slots__ = ("fn", "inputs")

    def __init__(self, fn: Callable[[Any, Any], Tensor], inputs: Any):
        self.fn = fn
        self.inputs = inputs

    def __call__(self, params) -> Tensor:
        return self.fn(params, self.inputs)


def layout(tree: Any, leaves: List[Tensor]) -> Hashable:
    """The hashable layout of ``tree``; its tensors are appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = tuple(
            (f.name, layout(getattr(tree, f.name), leaves))
            for f in dataclasses.fields(tree)
            if f.init
        )
        return ("dataclass", type(tree), fields)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("namedtuple", type(tree), tuple(layout(x, leaves) for x in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(layout(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, layout(tree[k], leaves)) for k in sorted(tree)))
    return ("static", tree)


def rebuild(tree: Any, leaves) -> Any:
    """``tree`` with its tensors replaced, in :func:`layout`'s order."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {
            f.name: rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)
            if f.init
        }
        return dataclasses.replace(tree, **changes)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(x, leaves) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], leaves) for k in tree}
    return tree


def fn_key(fn: Callable) -> Hashable:
    """A bound method by its function and owner (compared by value)."""
    owner = getattr(fn, "__self__", None)
    if owner is None:
        return fn
    return (fn.__func__, owner)


class Graph:
    """One captured function: :meth:`replay` reruns its launches on the
    current stream and returns its outputs, the graph's own tensors (the
    next replay overwrites them)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: Tuple[Tensor, ...],
                 launches: List[Tuple[str, str]]):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self) -> Tuple[Tensor, ...]:
        self.graph.replay()
        kernels.count_replayed(self.launches)
        return self.outputs


_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
# (device, thread) pairs whose lazy CUDA state a capture has warmed.
_WARM: set = set()


def capture(fn: Callable[[], Tuple[Tensor, ...]], device: torch.device) -> Graph:
    """Captures ``fn()``, which must read only tensors that outlive the graph
    and nothing back to the host. Raises RuntimeError when it cannot be
    captured. Called from :func:`cached`'s build (captures share a stream)."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device=device)
    stream = _STREAMS[device]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        if (device, threading.get_ident()) not in _WARM:
            # One eager run on the capture stream before a thread's first
            # capture: its cuBLAS / cuSOLVER handles and their workspaces on
            # this stream, and the autograd engine's device thread, start
            # there, not inside the capture.
            fn()
            _WARM.add((device, threading.get_ident()))
        # capture_begin / capture_end rather than ``torch.cuda.graph``, whose
        # entry also synchronizes the device, collects garbage and empties
        # the allocator's cache.
        graph = torch.cuda.CUDAGraph()
        with kernels.capturing_launches(stream) as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn()
            finally:
                graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    with _LOCK:
        STATS["captures"] += 1
    return Graph(graph, tuple(outputs), launches)


_ENTRIES: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()
_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
# Since the process started: graphs captured, calls served from graphs, and
# builds that could not capture (the smoke run reads them).
STATS = {"captures": 0, "served": 0, "failures": 0}


def cached(key: Hashable, build: Callable[[], Any]) -> Optional[Any]:
    """``build()``'s result for ``key``, built once (under the capture lock)
    and kept; None when ``build`` raised RuntimeError, which is logged,
    counted and remembered, so the caller runs eagerly for this key."""
    known, entry = _lookup(key)
    if not known:
        with _CAPTURE_LOCK:
            known, entry = _lookup(key)
            if not known:
                try:
                    entry = build()
                except RuntimeError:
                    _logger.warning("CUDA graph capture failed; running eagerly.",
                                    exc_info=True)
                    entry = None
                    with _LOCK:
                        STATS["failures"] += 1
                with _LOCK:
                    _ENTRIES[key] = entry
                    while len(_ENTRIES) > MAX_ENTRIES:
                        _ENTRIES.popitem(last=False)
    if entry is not None:
        with _LOCK:
            STATS["served"] += 1
    return entry


def _lookup(key: Hashable) -> Tuple[bool, Optional[Any]]:
    with _LOCK:
        if key not in _ENTRIES:
            return False, None
        _ENTRIES.move_to_end(key)
        return True, _ENTRIES[key]


def clear() -> None:
    """Drops every cached entry (tests)."""
    with _LOCK:
        _ENTRIES.clear()
