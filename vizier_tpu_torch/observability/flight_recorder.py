"""Per-study flight recorder: bounded rings of structured lifecycle events.

A copy of the JAX package's ``observability/flight_recorder.py``, with the
port's own process-global recorder. Every study gets a bounded ring of
structured events — suggest served, trial completed, batch-flush membership,
speculation outcome, surrogate crossover, breaker transition, admission
decision — each stamped with a wall-clock time and (when one is active) the
request's ``trace_id``, so an SLO breach can be walked backwards: "show me
exactly the requests around the spike, and which traces they were." The
event kinds and attributes are the JAX package's, so one tool reads both.

Fleet-scoped events that belong to no single study (batch flushes, SLO
breaches, admission state changes) land under the :data:`FLEET`
pseudo-study.

Like the tracer, the recorder is a process-global singleton built from the
environment on first use: subsystems call ``get_recorder().record(...)``
and pay ≈ nothing when the switch is off (``VIZIER_TORCH_FLIGHT_RECORDER=0``,
the default, yields the stateless :data:`NOOP_RECORDER`). Stdlib only.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional

from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.utils import env as env_lib

# Pseudo-study key for events that belong to the fleet, not one study.
FLEET = "<fleet>"


@dataclasses.dataclass(frozen=True)
class FlightRecorderConfig:
    """Knobs for the per-study flight recorder."""

    # Off by default: recording every lifecycle event is an opt-in cost.
    enabled: bool = False
    # Events kept per study ring (oldest evicted first).
    ring_size: int = 256
    # Study rings kept (least-recently-recorded evicted first).
    max_studies: int = 1024

    @classmethod
    def from_env(cls) -> "FlightRecorderConfig":
        return cls(
            enabled=env_lib.env_on("VIZIER_TORCH_FLIGHT_RECORDER", default="0"),
            ring_size=env_lib.env_int("VIZIER_TORCH_FLIGHT_RECORDER_RING", 256),
            max_studies=env_lib.env_int("VIZIER_TORCH_FLIGHT_RECORDER_STUDIES", 1024),
        )

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded per-study rings of JSON-ready lifecycle events."""

    enabled = True

    def __init__(self, ring_size: int = 256, max_studies: int = 1024):
        self._ring_size = max(1, ring_size)
        self._max_studies = max(1, max_studies)
        self._lock = threading.Lock()
        self._rings: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )

    def record(
        self,
        study: Optional[str],
        kind: str,
        trace_id: Optional[str] = None,
        **attributes: Any,
    ) -> None:
        """Appends one event to ``study``'s ring (:data:`FLEET` when None).

        ``trace_id`` defaults to the ambient trace so deep callees (the
        breaker, the batch executor) correlate for free; attribute values
        must be JSON-serializable.
        """
        if trace_id is None:
            ctx = tracing_lib.get_tracer().current_context()
            trace_id = ctx.trace_id if ctx is not None else None
        event: Dict[str, Any] = {
            "time": time.time(),
            "study": study or FLEET,
            "kind": kind,
        }
        if trace_id:
            event["trace_id"] = trace_id
        if attributes:
            event["attributes"] = attributes
        with self._lock:
            ring = self._rings.get(event["study"])
            if ring is None:
                while len(self._rings) >= self._max_studies:
                    self._rings.popitem(last=False)
                ring = self._rings[event["study"]] = collections.deque(maxlen=self._ring_size)
            else:
                self._rings.move_to_end(event["study"])
            ring.append(event)

    def ring(self, study: str) -> List[dict]:
        """One study's events, oldest first (empty when never recorded)."""
        with self._lock:
            ring = self._rings.get(study)
            return list(ring) if ring is not None else []

    def studies(self) -> List[str]:
        with self._lock:
            return list(self._rings)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Every recorded event across all rings, time-ordered; optionally
        filtered by ``kind``."""
        with self._lock:
            out = [e for ring in self._rings.values() for e in ring]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        out.sort(key=lambda e: e["time"])
        return out

    def invalidate(self, study: str) -> bool:
        """Drops a study's ring (DeleteStudy hygiene)."""
        with self._lock:
            return self._rings.pop(study, None) is not None

    def snapshot(self) -> Dict[str, List[dict]]:
        """JSON-ready copy of every ring (the black-box dump payload)."""
        with self._lock:
            return {study: list(ring) for study, ring in self._rings.items()}

    def dump_json(self, path: str) -> int:
        """Writes every event (time-ordered) to ``path`` as one JSON list;
        returns the event count."""
        events = self.events()
        with open(path, "w") as f:
            json.dump(events, f)
        return len(events)


class NoopFlightRecorder:
    """The off switch: same surface, no state, no allocation per event."""

    enabled = False

    def record(self, study, kind, trace_id=None, **attributes):
        pass

    def ring(self, study):
        return []

    def studies(self):
        return []

    def events(self, kind=None):
        return []

    def invalidate(self, study):
        return False

    def snapshot(self):
        return {}

    def dump_json(self, path: str) -> int:
        return 0


NOOP_RECORDER = NoopFlightRecorder()

_global_recorder = None
_global_lock = threading.Lock()


def _recorder_from_config(config: FlightRecorderConfig):
    if not config.enabled:
        return NOOP_RECORDER
    return FlightRecorder(ring_size=config.ring_size, max_studies=config.max_studies)


def get_recorder():
    """The process-global recorder, built from the environment on first use."""
    global _global_recorder
    recorder = _global_recorder
    if recorder is None:
        with _global_lock:
            if _global_recorder is None:
                _global_recorder = _recorder_from_config(FlightRecorderConfig.from_env())
            recorder = _global_recorder
    return recorder


def set_recorder(recorder):
    """Swaps the global recorder (tests, tools); None re-derives it from the
    environment on next use. Returns the previous recorder."""
    global _global_recorder
    with _global_lock:
        old, _global_recorder = _global_recorder, recorder
    return old
