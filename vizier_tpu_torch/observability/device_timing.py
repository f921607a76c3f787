"""Device-phase timing on CUDA events: compile vs. execute, as in the JAX package.

The port's counterpart of the JAX package's ``observability/jax_timing.py``.
PyTorch launches asynchronously, so a host clock around a designer stage
measures enqueue, not device work. :func:`device_phase` wraps a stage in a
span, records a CUDA event on the current stream when the stage starts and
another when it ends, waits for the second, and reads both the events'
elapsed time and the host wall around them:

    with device_timing.device_phase("gp_bandit.train_gp", device) as phase:
        states = self._train(...)

The end event pins the stage's device work inside the phase, where the JAX
package's caller blocks on the stage's outputs.

The first occurrence of a phase name in the process is ``mode="compile"``
(on the port, the stage's first run pays for building the kernel library,
cuBLAS / cuSOLVER handles and its CUDA-graph captures), later ones
``mode="execute"``. The host wall lands in the global metrics registry as
``vizier_jax_phase_seconds{phase=...,mode=...}``, the JAX package's
histogram under its own name, so the two packages' exports compare, and
both times on the span (``jax.<phase>``) as ``host_ms`` and ``device_ms``
and in :func:`recent`. A phase on the CPU (``device`` not CUDA) records no
event: its ``device_ms`` is None.

With observability or ``VIZIER_TORCH_OBSERVABILITY_JAX`` off the phase is
inert: no span, no event, no wait.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional, Set, Tuple

import torch

from vizier_tpu_torch.observability import config as config_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib

_seen_lock = threading.Lock()
_seen_phases: Set[str] = set()

_config: Optional[config_lib.ObservabilityConfig] = None

# The last finished phases, (name, mode, host_ms, device_ms), oldest first.
_recent: Deque[Tuple[str, str, float, Optional[float]]] = collections.deque(maxlen=256)


def _profiling_on() -> bool:
    global _config
    if _config is None:
        _config = config_lib.ObservabilityConfig.from_env()
    return _config.jax_profiling_on


def set_config(config: Optional[config_lib.ObservabilityConfig]) -> None:
    """Overrides the env-derived config (tests); None re-reads on next use."""
    global _config
    _config = config


def reset_compile_tracking() -> None:
    """Forgets which phases have run (tests)."""
    with _seen_lock:
        _seen_phases.clear()
        _recent.clear()


def recent() -> List[Tuple[str, str, float, Optional[float]]]:
    """The last finished phases as (name, mode, host ms, event ms or None)."""
    with _seen_lock:
        return list(_recent)


def _mark_seen(name: str) -> bool:
    """True iff this is the first time ``name`` runs in this process."""
    with _seen_lock:
        if name in _seen_phases:
            return False
        _seen_phases.add(name)
        return True


class _Phase:
    """Yielded by :func:`device_phase`; after the block, ``host_ms`` and
    ``device_ms`` hold the stage's times."""

    __slots__ = ("name", "enabled", "first_call", "host_ms", "device_ms")

    def __init__(self, name: str, enabled: bool, first_call: bool):
        self.name = name
        self.enabled = enabled
        self.first_call = first_call
        self.host_ms: Optional[float] = None
        self.device_ms: Optional[float] = None

    @property
    def mode(self) -> str:
        return "compile" if self.first_call else "execute"


_DISABLED_PHASE = _Phase("", enabled=False, first_call=False)


def _cuda(device) -> Optional[torch.device]:
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _PhaseCM:
    __slots__ = ("_phase", "_registry", "_span_cm", "_span", "_t0", "_device", "_events")

    def __init__(self, phase: _Phase, registry: metrics_lib.MetricsRegistry, device):
        self._phase = phase
        self._registry = registry
        self._device = _cuda(device)
        self._span_cm = tracing_lib.get_tracer().span(
            f"jax.{phase.name}", jax_phase=phase.name, first_call=phase.first_call
        )
        self._span = None
        self._t0 = 0.0
        self._events = None

    def __enter__(self) -> _Phase:
        self._span = self._span_cm.__enter__()
        self._t0 = time.perf_counter()
        if self._device is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            self._events = (start, end)
        return self._phase

    def __exit__(self, exc_type, exc, tb) -> bool:
        phase = self._phase
        if self._events is not None:
            start, end = self._events
            end.record(torch.cuda.current_stream(self._device))
            end.synchronize()
            phase.device_ms = start.elapsed_time(end)
        phase.host_ms = (time.perf_counter() - self._t0) * 1000.0
        mode = phase.mode
        with _seen_lock:
            _recent.append((phase.name, mode, phase.host_ms, phase.device_ms))
        if exc is None:
            self._registry.histogram(
                "vizier_jax_phase_seconds",
                help="Designer device phase wall time, device-synced; "
                "mode=compile is the first call per phase.",
            ).observe(phase.host_ms / 1000.0, phase=phase.name, mode=mode)
        self._span.set_attribute("mode", mode)
        self._span.set_attribute("host_ms", phase.host_ms)
        self._span.set_attribute("device_ms", phase.device_ms)
        return self._span_cm.__exit__(exc_type, exc, tb)


class _DisabledPhaseCM:
    __slots__ = ()

    def __enter__(self) -> _Phase:
        return _DISABLED_PHASE

    def __exit__(self, *exc) -> bool:
        return False


_DISABLED_CM = _DisabledPhaseCM()


def device_phase(
    name: Optional[str],
    device=None,
    registry: Optional[metrics_lib.MetricsRegistry] = None,
):
    """Times one device phase on ``device`` (see the module docstring). A
    phase named None is not timed: its stage runs inside a larger phase."""
    if name is None or not _profiling_on():
        return _DISABLED_CM
    phase = _Phase(name, enabled=True, first_call=_mark_seen(name))
    return _PhaseCM(phase, registry or metrics_lib.default_registry(), device)
