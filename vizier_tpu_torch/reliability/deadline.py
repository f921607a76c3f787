"""Deadline budgets: created at the edge, decremented across hops.

A copy of the JAX package's ``reliability/deadline.py``.

A deadline travels the wire as *remaining seconds* (clock-skew immune), and
in-process as a :class:`Deadline` pinned to a monotonic clock. Every layer
re-reads ``remaining()`` at its hop so queueing and compute time upstream
shrink the budget downstream.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from vizier_tpu_torch.reliability import errors as errors_lib


class Deadline:
    """A fixed point in (monotonic) time with budget arithmetic."""

    def __init__(
        self,
        expires_at: Optional[float],
        clock: Callable[[], float] = time.monotonic,
    ):
        # None = no deadline (infinite budget).
        self._expires_at = expires_at
        self._clock = clock

    @classmethod
    def from_budget(
        cls, budget_secs: float, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        """A deadline ``budget_secs`` from now; <= 0 means none."""
        if budget_secs <= 0:
            return cls(None, clock)
        return cls(clock() + budget_secs, clock)

    @classmethod
    def from_wire(
        cls, budget_secs: float, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        """A deadline from a wire ``deadline_secs`` field.

        Wire semantics: positive = remaining budget, 0 = no deadline
        (back-compat), **negative = already expired at the sender** — the
        resulting deadline is born expired so the receiver's existing
        ``check()`` sheds the request before any computation starts,
        instead of conflating "caller gave up" with "no deadline".
        """
        if budget_secs == 0:
            return cls(None, clock)
        return cls(clock() + budget_secs, clock)

    @classmethod
    def none(cls) -> "Deadline":
        """No deadline: infinite remaining budget, never expired."""
        return cls(None)

    @property
    def is_set(self) -> bool:
        return self._expires_at is not None

    def remaining(self) -> float:
        """Seconds left (may be negative once expired; inf when unset)."""
        if self._expires_at is None:
            return float("inf")
        return self._expires_at - self._clock()

    @property
    def expired(self) -> bool:
        return self._expires_at is not None and self.remaining() <= 0

    def wire_budget(self) -> float:
        """The remaining budget as a request field (0 = no deadline)."""
        if self._expires_at is None:
            return 0.0
        return max(0.0, self.remaining())

    def check(self, what: str) -> None:
        """Raises the typed DEADLINE_EXCEEDED error once the budget is gone."""
        if self.expired:
            raise errors_lib.DeadlineExceededError(
                errors_lib.mark_transient(
                    f"DEADLINE_EXCEEDED: {what} "
                    f"(over budget by {-self.remaining():.3f}s)"
                )
            )
