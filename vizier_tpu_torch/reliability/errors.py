"""Typed reliability errors + transient/permanent classification.

A copy of the JAX package's ``reliability/errors.py``, so that the port imports nothing
of the JAX package.

The service surfaces failures to clients as text inside the long-running
operation's ``error`` field, so the transient/permanent distinction must
survive a round of stringification: transient errors carry a leading
``TRANSIENT:`` marker that retry logic greps for, while typed exceptions
cover the in-process paths.

Permanent errors (e.g. an invalid search space or unknown algorithm) are
deliberately NOT marked: retrying them burns the client's budget on a
failure that will never heal, and falling back would silently serve
quasi-random points to a misconfigured study forever.
"""

from __future__ import annotations

import re
from typing import Optional, Union

TRANSIENT_MARKER = "TRANSIENT:"

# Admission-control shed vocabulary: the marker names the condition
# (capacity, not failure) and the retry-after key carries the service's
# backoff hint in milliseconds. Both survive stringification across the
# op-error round trip, like the transient marker itself.
RESOURCE_EXHAUSTED_MARKER = "RESOURCE_EXHAUSTED"
RETRY_AFTER_KEY = "retry_after_ms="
_RETRY_AFTER_RE = re.compile(re.escape(RETRY_AFTER_KEY) + r"([0-9]*\.?[0-9]+)")


class TransientError(RuntimeError):
    """A failure that is expected to heal: safe to retry."""


class DeadlineExceededError(TransientError, TimeoutError):
    """The request's deadline budget ran out (typed DEADLINE_EXCEEDED)."""


class CircuitOpenError(TransientError):
    """The study's circuit breaker is open; computation was not attempted."""


def mark_transient(text: str) -> str:
    """Prefixes ``text`` with the marker unless one is already present."""
    if has_transient_marker(text):
        return text
    return f"{TRANSIENT_MARKER} {text}"


def has_transient_marker(text: str) -> bool:
    """True when error text anywhere carries the transient marker.

    Substring (not prefix) match: service layers wrap each other's error
    text (``"RuntimeError: Pythia error: TRANSIENT: ..."``), and the marker
    must survive that nesting.
    """
    return TRANSIENT_MARKER in text


def is_resource_exhausted(text: str) -> bool:
    """True when error text carries the admission-shed marker (substring:
    service layers wrap each other's error text, like the transient
    marker)."""
    return RESOURCE_EXHAUSTED_MARKER in text


def retry_after_secs(error: Union[BaseException, str]) -> Optional[float]:
    """The ``retry_after_ms=`` hint in an error (or its text), in seconds.

    Admission sheds stamp the hint so client retry logic can honor the
    service's backoff floor instead of hammering a saturated fleet with
    its own (possibly tiny) jittered schedule. None when absent.
    """
    match = _RETRY_AFTER_RE.search(
        error if isinstance(error, str) else str(error)
    )
    if match is None:
        return None
    try:
        return float(match.group(1)) / 1e3
    except ValueError:  # pragma: no cover - regex admits only numbers
        return None


def is_transient_exception(error: BaseException) -> bool:
    """Classifies an exception as retryable.

    Transient: the typed reliability errors, timeouts, transport failures
    (``ConnectionError``, gRPC UNAVAILABLE / DEADLINE_EXCEEDED /
    RESOURCE_EXHAUSTED), and any error whose text carries the marker.
    """
    if isinstance(error, (TransientError, TimeoutError, ConnectionError)):
        return True
    if has_transient_marker(str(error)):
        return True
    code = getattr(error, "code", None)
    if callable(code):
        try:
            import grpc

            if isinstance(error, grpc.RpcError):
                return code() in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                )
        except Exception:  # grpc missing or a non-RPC ``code`` attribute
            return False
    return False


def format_op_error(error: BaseException) -> str:
    """Formats an exception for an operation/response ``error`` field.

    Transient errors gain the ``TRANSIENT:`` marker (once — re-wrapped
    errors whose text already carries it are left alone) so clients can
    classify without the exception object.
    """
    text = f"{type(error).__name__}: {error}"
    if is_transient_exception(error):
        return mark_transient(text)
    return text
