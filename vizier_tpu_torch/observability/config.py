"""Observability knobs (tracing, metrics, device phase profiling).

Copy of the JAX package's ``observability/config.py`` with the port's
``VIZIER_TORCH_*`` switches.

Everything defaults ON; ``VIZIER_TORCH_OBSERVABILITY=0`` turns the whole
subsystem off wholesale (no-op tracer, no histogram observations, no
device-sync in the device phase timers — ≈ zero overhead), and each
mechanism has its own off-switch for A/B isolation:

- ``VIZIER_TORCH_OBSERVABILITY=0``         — master switch;
- ``VIZIER_TORCH_OBSERVABILITY_TRACING=0`` — no spans (counters/histograms stay);
- ``VIZIER_TORCH_OBSERVABILITY_METRICS=0`` — no latency histograms (the serving
  counter vocabulary — ``ServingStats`` — is core behavior and stays on);
- ``VIZIER_TORCH_OBSERVABILITY_JAX=0``     — designer device-phase timers become
  no-ops and stop forcing device syncs;
- ``VIZIER_TORCH_OBSERVABILITY_SPAN_BUFFER=N`` — finished-span ring size;
- ``VIZIER_TORCH_OBSERVABILITY_SPAN_LOG=path`` — append every finished span to
  ``path`` as one JSON line (off by default; the in-memory ring is always
  available via ``Tracer.finished_spans()`` / ``dump_jsonl()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from vizier_tpu_torch.utils import env as _registry


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Knobs for the tracing/metrics/profiling subsystem."""

    # Master switch; off ≈ zero overhead everywhere.
    enabled: bool = True
    # Per-mechanism switches (each effective only when ``enabled``).
    tracing: bool = True
    metrics: bool = True
    jax_profiling: bool = True

    # Finished spans kept in the tracer's bounded ring buffer.
    span_buffer_size: int = 4096
    # Optional JSON-lines sink ("" = in-memory ring only).
    span_log_path: str = ""

    # -- effective switches (master ANDed in) ------------------------------

    @property
    def tracing_on(self) -> bool:
        return self.enabled and self.tracing

    @property
    def metrics_on(self) -> bool:
        return self.enabled and self.metrics

    @property
    def jax_profiling_on(self) -> bool:
        return self.enabled and self.jax_profiling

    @classmethod
    def from_env(cls) -> "ObservabilityConfig":
        """The default config with per-knob environment overrides applied."""
        return cls(
            enabled=_registry.env_on("VIZIER_TORCH_OBSERVABILITY"),
            tracing=_registry.env_on("VIZIER_TORCH_OBSERVABILITY_TRACING"),
            metrics=_registry.env_on("VIZIER_TORCH_OBSERVABILITY_METRICS"),
            jax_profiling=_registry.env_on("VIZIER_TORCH_OBSERVABILITY_JAX"),
            span_buffer_size=_registry.env_int(
                "VIZIER_TORCH_OBSERVABILITY_SPAN_BUFFER", 4096
            ),
            span_log_path=_registry.env_str("VIZIER_TORCH_OBSERVABILITY_SPAN_LOG"),
        )

    @classmethod
    def disabled(cls) -> "ObservabilityConfig":
        """Everything off: the pre-observability code paths."""
        return cls(enabled=False)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready form, for stamping into benchmark/report output."""
        return dataclasses.asdict(self)
