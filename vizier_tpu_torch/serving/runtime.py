"""ServingRuntime: one object bundling cache + stats + config.

Counterpart of the JAX package's ``serving/runtime.py``. The policy factory
and the serving policy share one runtime per process, so every counter
lands in one place and study invalidation reaches the real cache. One
metrics registry backs the serving counters and the latency histograms.

The runtime owns the cross-study batch executor
(``parallel.batch_executor``) when batching is on, and the exact↔sparse
surrogate policy every GP designer the factory builds shares.

The JAX runtime's planes that are off by default are not ported: the
admission controller, the speculative pre-compute engine, the SLO engine,
the flight recorder, the mesh execution plane, the compilation cache and
compile prewarm (and the circuit breakers and per-hop latency histogram,
which serve the gRPC servicers). Asking for one raises. Nor is the request
coalescer: its only caller is the gRPC servicer, which is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from vizier_tpu_torch.observability import config as obs_config_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.parallel import batch_executor as batch_executor_lib
from vizier_tpu_torch.serving import config as config_lib
from vizier_tpu_torch.serving import designer_cache as cache_lib
from vizier_tpu_torch.serving import stats as stats_lib
from vizier_tpu_torch.surrogates import config as surrogate_config_lib

_NOT_PORTED = ("reliability", "speculative", "mesh", "slo", "admission")


class ServingRuntime:
    """Shared serving state for one Pythia process."""

    def __init__(
        self,
        config: Optional[config_lib.ServingConfig] = None,
        stats: Optional[stats_lib.ServingStats] = None,
        observability: Optional[obs_config_lib.ObservabilityConfig] = None,
        surrogates: Optional[surrogate_config_lib.SurrogateConfig] = None,
        **planes: Any,
    ):
        for name, value in planes.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Unknown ServingRuntime argument {name!r}.")
            if value is not None and getattr(value, "enabled", True):
                raise NotImplementedError(
                    f"The {name} plane of the JAX package's serving runtime is not ported."
                )
        self.config = config or config_lib.ServingConfig.from_env()
        self.observability = observability or obs_config_lib.ObservabilityConfig.from_env()
        # The exact↔sparse auto-switch threaded into every GP designer the
        # policy factory builds.
        self.surrogates = surrogates or surrogate_config_lib.SurrogateConfig.from_env()
        self.stats = stats or stats_lib.ServingStats()
        self.metrics: metrics_lib.MetricsRegistry = self.stats.registry
        self.designer_cache = cache_lib.DesignerStateCache(
            max_entries=self.config.cache_max_entries,
            ttl_seconds=self.config.cache_ttl_seconds,
            stats=self.stats,
            observe_latency=self.observability.metrics_on,
        )
        # Cross-study batch executor: concurrent same-bucket designer
        # computations share one batched program. None = batching off: the
        # per-study path.
        self.batch_executor: Optional[batch_executor_lib.BatchExecutor] = None
        if self.config.batching:
            self.batch_executor = batch_executor_lib.BatchExecutor(
                max_batch_size=self.config.batch_max_size,
                max_wait_ms=self.config.batch_max_wait_ms,
                pad_partial=self.config.batch_pad_partial,
                stats=self.stats,
                metrics=self.metrics if self.observability.metrics_on else None,
            )
        self._lock = threading.Lock()
        self._closed = False

    def shutdown(self) -> None:
        """Drains and stops the batch executor. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.batch_executor is not None:
            self.batch_executor.close()

    def invalidate_study(self, study_name: str) -> bool:
        """Drops the study's designer state (study deleted)."""
        return self.designer_cache.invalidate(study_name)

    def snapshot(self) -> Dict[str, int]:
        """All counters plus the current cache population."""
        out = self.stats.snapshot()
        out["cached_studies"] = len(self.designer_cache)
        return out
