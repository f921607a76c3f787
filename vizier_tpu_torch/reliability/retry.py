"""RetryPolicy: exponential backoff with full jitter over transient errors.

A copy of the JAX package's ``reliability/retry.py``.

Full jitter (delay ~ Uniform(0, min(cap, base * 2^attempt))) rather than
equal/decorrelated jitter: with many clients hammering one service, full
jitter spreads the retry herd widest for the same mean delay. The RNG and
sleep function are injectable so tests run deterministic schedules without
real sleeping.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Iterator, Optional, TypeVar

from vizier_tpu_torch.reliability import config as config_lib
from vizier_tpu_torch.reliability import errors as errors_lib

_T = TypeVar("_T")


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries of transient failures."""

    max_attempts: int = 3
    base_delay_secs: float = 0.1
    max_delay_secs: float = 2.0
    jitter: bool = True
    is_retryable: Callable[[BaseException], bool] = (
        errors_lib.is_transient_exception
    )
    rng: random.Random = dataclasses.field(default_factory=random.Random)
    sleep_fn: Callable[[float], None] = time.sleep

    @classmethod
    def from_config(
        cls,
        config: config_lib.ReliabilityConfig,
        *,
        seed: Optional[int] = None,
    ) -> "RetryPolicy":
        """A policy matching ``config`` (1 attempt = no retries when off)."""
        return cls(
            max_attempts=config.retry_max_attempts if config.retries_on else 1,
            base_delay_secs=config.retry_base_delay_secs,
            max_delay_secs=config.retry_max_delay_secs,
            rng=random.Random(seed),
        )

    def delay_for_attempt(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        cap = min(self.max_delay_secs, self.base_delay_secs * (2.0**attempt))
        return self.rng.uniform(0.0, cap) if self.jitter else cap

    def delays(self) -> Iterator[float]:
        """The backoff schedule: one delay per allowed retry."""
        for attempt in range(max(0, self.max_attempts - 1)):
            yield self.delay_for_attempt(attempt)

    def call(
        self,
        fn: Callable[[], _T],
        *,
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
        deadline=None,
    ) -> _T:
        """Runs ``fn``, retrying transient failures with backoff.

        ``on_retry(error, attempt)`` fires before each backoff (counter
        hooks). A ``deadline`` (reliability.Deadline) bounds the whole
        attempt loop: no retry is started that the remaining budget cannot
        cover, and the last error is re-raised instead. An error carrying
        a ``retry_after_ms=`` hint (an admission shed) raises the backoff
        to at least the service's floor — shed retries must not hammer a
        saturated fleet on the client's own (jittered, possibly tiny)
        schedule.
        """
        attempts = max(1, self.max_attempts)
        for attempt in range(attempts):
            try:
                return fn()
            except BaseException as e:  # noqa: B036 - classified below
                last_attempt = attempt == attempts - 1
                if last_attempt or not self.is_retryable(e):
                    raise
                delay = self.delay_for_attempt(attempt)
                hint = errors_lib.retry_after_secs(e)
                if hint is not None:
                    delay = max(delay, hint)
                if deadline is not None and deadline.remaining() <= delay:
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)
                if delay > 0:
                    self.sleep_fn(delay)
        raise AssertionError("unreachable")  # pragma: no cover
