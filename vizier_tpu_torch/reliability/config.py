"""Reliability knobs (retries, deadlines, breaker, fallback).

A copy of the JAX package's ``reliability/config.py`` with the port's
``VIZIER_TORCH_*`` switches. Everything defaults ON;
``VIZIER_TORCH_RELIABILITY=0`` restores fail-hard behavior wholesale, and
each mechanism has its own off-switch for A/B isolation:

- ``VIZIER_TORCH_RELIABILITY=0``          — master switch: no retries, no
  deadline enforcement, no breaker, no fallback (one designer exception
  fails the op);
- ``VIZIER_TORCH_RELIABILITY_RETRIES=0``  — client RPCs and op polling fail
  on the first transient error;
- ``VIZIER_TORCH_RELIABILITY_DEADLINE=0`` — no deadline attachment/propagation;
- ``VIZIER_TORCH_RELIABILITY_BREAKER=0``  — designer failures never open a
  circuit;
- ``VIZIER_TORCH_RELIABILITY_FALLBACK=0`` — designer failures error the op
  instead of degrading to seeded quasi-random suggestions.
"""

from __future__ import annotations

import dataclasses

from vizier_tpu_torch.utils import env as env_lib


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Knobs for the fault-tolerant suggestion path."""

    # Master switch; off restores fail-hard behavior everywhere.
    enabled: bool = True
    # Per-mechanism switches (each effective only when ``enabled``).
    retries: bool = True
    deadlines: bool = True
    breaker: bool = True
    fallback: bool = True

    # Retry: exponential backoff with full jitter over transient errors.
    retry_max_attempts: int = 3
    retry_base_delay_secs: float = 0.1
    retry_max_delay_secs: float = 2.0

    # Deadline budget the client attaches to SuggestTrials when the caller
    # supplies none. Kept under the 600 s polling timeout so an over-budget
    # computation surfaces as a typed error instead of a poll timeout.
    default_deadline_secs: float = 300.0

    # Circuit breaker: ``failure_threshold`` failures within ``window_secs``
    # open the circuit; after ``cooldown_secs`` it half-opens and admits
    # ``half_open_probes`` trial computations.
    breaker_failure_threshold: int = 3
    breaker_window_secs: float = 60.0
    breaker_cooldown_secs: float = 30.0
    breaker_half_open_probes: int = 1

    # -- effective switches (master ANDed in) ------------------------------

    @property
    def retries_on(self) -> bool:
        return self.enabled and self.retries

    @property
    def deadlines_on(self) -> bool:
        return self.enabled and self.deadlines

    @property
    def breaker_on(self) -> bool:
        return self.enabled and self.breaker

    @property
    def fallback_on(self) -> bool:
        return self.enabled and self.fallback

    @classmethod
    def from_env(cls) -> "ReliabilityConfig":
        """The default config with per-knob environment overrides applied."""
        return cls(
            enabled=env_lib.env_on("VIZIER_TORCH_RELIABILITY"),
            retries=env_lib.env_on("VIZIER_TORCH_RELIABILITY_RETRIES"),
            deadlines=env_lib.env_on("VIZIER_TORCH_RELIABILITY_DEADLINE"),
            breaker=env_lib.env_on("VIZIER_TORCH_RELIABILITY_BREAKER"),
            fallback=env_lib.env_on("VIZIER_TORCH_RELIABILITY_FALLBACK"),
        )

    @classmethod
    def disabled(cls) -> "ReliabilityConfig":
        """Fail hard: no retries, deadlines, breaker or fallback."""
        return cls(enabled=False)
