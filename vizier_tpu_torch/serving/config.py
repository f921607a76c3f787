"""Serving runtime knobs.

Counterpart of the JAX package's ``serving/config.py``, with the same
defaults. Everything the port serves defaults ON; each knob can be forced
off per process through the environment:

- ``VIZIER_TORCH_SERVING_CACHE=0``      — no designer-state cache (stateless
  ``DesignerPolicy`` per request);
- ``VIZIER_TORCH_SERVING_WARM_START=0`` — cache designers but cold-train ARD
  on every suggest;
- ``VIZIER_TORCH_SERVING_COALESCING=0`` — every suggest computes its own
  designer run;
- ``VIZIER_TORCH_BATCHING=0``           — no cross-study batch executor:
  every study's computation runs alone;
- ``VIZIER_TORCH_BATCH_MAX_SIZE``, ``VIZIER_TORCH_BATCH_MAX_WAIT_MS`` — the
  flush window.

The JAX package's compile prewarm and persistent compilation cache have no
counterpart in the port: a config that asks for them is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from vizier_tpu_torch.utils import env as env_lib


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for the stateful serving runtime."""

    # Keep live designers + trained ARD params per study.
    designer_cache: bool = True
    # Inject the previous suggest's trained params as an extra restart and
    # shrink the restart budget to ``warm_ard_restarts``.
    warm_start: bool = True
    # Collapse concurrent identical suggest computations (the Pythia
    # servicer's coalescer, ``ServingRuntime.coalescer``).
    coalescing: bool = True
    # Cache sizing: LRU beyond max_entries, TTL on idle entries.
    cache_max_entries: int = 64
    cache_ttl_seconds: float = 3600.0
    # Restart budget for a warm-started ARD train (cold trains keep the
    # designer's full ``ard_restarts``).
    warm_ard_restarts: int = 1

    # -- cross-study batching (vizier_tpu_torch.parallel.batch_executor) ----
    # Collect concurrent designer computations from different studies into
    # shape-bucket queues and run each bucket as one batched program.
    batching: bool = True
    # Flush a bucket at this many studies ("full") ...
    batch_max_size: int = 8
    # ... or when its oldest request has waited this long ("timeout").
    batch_max_wait_ms: float = 4.0
    # Pad partial batches to batch_max_size with masked copies of slot 0.
    batch_pad_partial: bool = True
    # The JAX package's compile prewarm: not part of the port (must stay off).
    batching_prewarm: bool = False
    batching_prewarm_max_trials: int = 32

    # The JAX package's persistent compilation cache: not part of the port
    # (must stay None).
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.batching_prewarm:
            raise NotImplementedError(
                "batching_prewarm is not ported: the port compiles its kernels once per "
                "process and has no per-bucket programs to prewarm."
            )
        if self.compilation_cache_dir is not None:
            raise NotImplementedError(
                "compilation_cache_dir is not ported: the port has no compilation cache."
            )

    @classmethod
    def from_env(cls) -> "ServingConfig":
        """The default config with per-knob environment overrides applied."""
        return cls(
            designer_cache=env_lib.env_on("VIZIER_TORCH_SERVING_CACHE"),
            warm_start=env_lib.env_on("VIZIER_TORCH_SERVING_WARM_START"),
            coalescing=env_lib.env_on("VIZIER_TORCH_SERVING_COALESCING"),
            batching=env_lib.env_on("VIZIER_TORCH_BATCHING"),
            batch_max_size=env_lib.env_int("VIZIER_TORCH_BATCH_MAX_SIZE", 8),
            batch_max_wait_ms=env_lib.env_float("VIZIER_TORCH_BATCH_MAX_WAIT_MS", 4.0),
        )

    @classmethod
    def disabled(cls) -> "ServingConfig":
        """Reference behavior: stateless, cold, uncoalesced, unbatched."""
        return cls(designer_cache=False, warm_start=False, coalescing=False, batching=False)
