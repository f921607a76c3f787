"""Stateful serving runtime of the port: designer cache, request coalescing,
circuit breakers, stats, the cross-study batch executor and the opt-in
admission and speculative pre-compute planes (own copies of the JAX
package's ``serving`` modules; its compile prewarm is not ported)."""

from vizier_tpu_torch.serving.coalescer import RequestCoalescer
from vizier_tpu_torch.serving.config import ServingConfig
from vizier_tpu_torch.serving.designer_cache import CachedDesignerEntry, DesignerStateCache
from vizier_tpu_torch.serving.policy import CachedDesignerStatePolicy
from vizier_tpu_torch.serving.runtime import ServingRuntime
from vizier_tpu_torch.serving.stats import ServingStats

__all__ = [
    "CachedDesignerEntry",
    "CachedDesignerStatePolicy",
    "DesignerStateCache",
    "RequestCoalescer",
    "ServingConfig",
    "ServingRuntime",
    "ServingStats",
]
