"""Fault tolerance for the suggestion path: retries, deadlines, breaker, fallback.

Copies of the JAX package's ``reliability`` modules. They thread graceful
degradation through client → VizierService → Pythia → designer:

- :class:`RetryPolicy` — exponential backoff + full jitter over transient
  errors, applied to client RPCs and op polling;
- :class:`Deadline` — a budget attached at the client, decremented across
  hops, enforced around the designer computation; over-budget work completes
  the op with a typed ``TRANSIENT: DEADLINE_EXCEEDED:`` error;
- :class:`CircuitBreaker` / :class:`CircuitBreakerRegistry` — per-study
  closed/open/half-open automaton over a sliding designer-failure window;
- :func:`suggest_fallback` — on designer failure or open circuit, seeded
  quasi-random suggestions stamped ``reliability:fallback=quasi_random``
  keep the study moving, auditably;
- :class:`ReliabilityConfig` — the knobs; ``VIZIER_TORCH_RELIABILITY=0``
  restores fail-hard behavior.

Counters land in the serving stats (``PythiaServicer.serving_stats()``):
retries, fallbacks, breaker transitions, deadline hits. Nothing here imports
protobuf or gRPC.
"""

from vizier_tpu_torch.reliability.breaker import CircuitBreaker
from vizier_tpu_torch.reliability.breaker import CircuitBreakerRegistry
from vizier_tpu_torch.reliability.config import ReliabilityConfig
from vizier_tpu_torch.reliability.deadline import Deadline
from vizier_tpu_torch.reliability.errors import CircuitOpenError
from vizier_tpu_torch.reliability.errors import DeadlineExceededError
from vizier_tpu_torch.reliability.errors import TRANSIENT_MARKER
from vizier_tpu_torch.reliability.errors import TransientError
from vizier_tpu_torch.reliability.errors import format_op_error
from vizier_tpu_torch.reliability.errors import has_transient_marker
from vizier_tpu_torch.reliability.errors import is_transient_exception
from vizier_tpu_torch.reliability.errors import mark_transient
from vizier_tpu_torch.reliability.fallback import FALLBACK_NAMESPACE
from vizier_tpu_torch.reliability.fallback import is_fallback_suggestion
from vizier_tpu_torch.reliability.fallback import suggest_fallback
from vizier_tpu_torch.reliability.retry import RetryPolicy

__all__ = [
    "CircuitBreaker",
    "CircuitBreakerRegistry",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceededError",
    "FALLBACK_NAMESPACE",
    "ReliabilityConfig",
    "RetryPolicy",
    "TRANSIENT_MARKER",
    "TransientError",
    "format_op_error",
    "has_transient_marker",
    "is_fallback_suggestion",
    "is_transient_exception",
    "mark_transient",
    "suggest_fallback",
]
