"""Tracing/profiling: phase timers, runtime decorators and call beacons.

Copy of the JAX package's ``utils/profiler.py``: global event storage,
``collect_events``, ``timeit`` (which also opens a ``profiler.<name>`` span
on the port's tracer), ``record_runtime`` and ``record_tracing``. The GP
designers time their phases with ``timeit`` under the JAX package's names
(``convert_trials``, ``train_gp``, ``acquisition_optimizer``,
``best_candidates_to_trials``, ...). Kernels run asynchronously on CUDA, so
``record_runtime(block_until_ready=True)`` synchronizes the device before it
stops the clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProfileEvent:
    name: str
    kind: str  # 'latency' | 'tracing'
    duration_secs: float
    timestamp: float


class _Storage:
    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[ProfileEvent] = []
        self._enabled = False
        self._scope: List[str] = []

    def add(self, event: ProfileEvent) -> None:
        with self._lock:
            if self._enabled:
                self._events.append(event)

    def scoped_name(self, name: str) -> str:
        with self._lock:
            return "::".join(self._scope + [name])

    @contextlib.contextmanager
    def push_scope(self, name: str):
        with self._lock:
            self._scope.append(name)
        try:
            yield
        finally:
            with self._lock:
                self._scope.pop()

    @contextlib.contextmanager
    def collect(self):
        with self._lock:
            self._enabled = True
            self._events = []
        try:
            yield self._events
        finally:
            with self._lock:
                self._enabled = False


_storage = _Storage()

_tracing_mod = None


def _tracer():
    """The observability tracer, lazily bound (no import cycle: the
    observability package never imports utils.profiler)."""
    global _tracing_mod
    if _tracing_mod is None:
        from vizier_tpu_torch.observability import tracing as _tracing_mod_

        _tracing_mod = _tracing_mod_
    return _tracing_mod.get_tracer()


def collect_events():
    """Context manager enabling collection; yields the event list."""
    return _storage.collect()


@contextlib.contextmanager
def timeit(name: str, also_log: bool = False):
    """Times a block (nested scopes join with ``::``).

    Also opens a ``profiler.<name>`` span on the observability tracer, so
    the per-phase timers that already annotate the designer hot path
    (convert_trials, train_gp, acquisition_optimizer, ...) show up inside
    the request's trace for free. A no-op CM when tracing is off.
    """
    full = _storage.scoped_name(name)
    start = time.perf_counter()
    with _storage.push_scope(name), _tracer().span(f"profiler.{name}"):
        yield
    duration = time.perf_counter() - start
    _storage.add(
        ProfileEvent(name=full, kind="latency", duration_secs=duration, timestamp=time.time())
    )
    if also_log:
        import logging

        logging.getLogger(__name__).info("%s took %.3fs", full, duration)


def _holds_cuda_tensor(out: Any) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_holds_cuda_tensor(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_holds_cuda_tensor(v) for v in out)
    return False


def record_runtime(
    fn: Optional[Callable] = None,
    *,
    name_prefix: str = "",
    name: str = "",
    also_log: bool = False,
    block_until_ready: bool = False,
):
    """Decorator recording a function's wall time.

    ``block_until_ready=True`` synchronizes the CUDA device when the
    function returned a CUDA tensor (anywhere in a tuple, list or dict), so
    the recorded time covers the kernels it queued, not just their enqueue;
    on a CPU result it does nothing more.
    """

    def decorator(func: Callable) -> Callable:
        label = "::".join(x for x in (name_prefix, name or func.__qualname__) if x)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with timeit(label, also_log=also_log):
                out = func(*args, **kwargs)
                if block_until_ready and _holds_cuda_tensor(out):
                    torch.cuda.synchronize()
            return out

        return wrapper

    if fn is not None:
        return decorator(fn)
    return decorator


def record_tracing(fn: Optional[Callable] = None, *, name: str = ""):
    """Decorator that logs a 'tracing' event each time the body runs.

    In the JAX package it wraps a jitted function's body, so an event is a
    (re)trace. Eager PyTorch has no trace: the Python body runs on every
    call, so here an event is a call, and the count is the number of calls.
    """

    def decorator(func: Callable) -> Callable:
        label = name or func.__qualname__

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            _storage.add(
                ProfileEvent(
                    name=label, kind="tracing", duration_secs=0.0, timestamp=time.time()
                )
            )
            return func(*args, **kwargs)

        return wrapper

    if fn is not None:
        return decorator(fn)
    return decorator


def get_latencies_dict(
    events: List[ProfileEvent],
) -> Dict[str, List[datetime.timedelta]]:
    out: Dict[str, List[datetime.timedelta]] = collections.defaultdict(list)
    for e in events:
        if e.kind == "latency":
            out[e.name].append(datetime.timedelta(seconds=e.duration_secs))
    return dict(out)


def get_tracing_counts(events: List[ProfileEvent]) -> Dict[str, int]:
    out: Dict[str, int] = collections.defaultdict(int)
    for e in events:
        if e.kind == "tracing":
            out[e.name] += 1
    return dict(out)
