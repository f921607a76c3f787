"""Cross-thread response handoff.

A copy of the JAX package's ``service/pythia_util.py``
(``ResponseWaiter``): one thread computes a response while another blocks
waiting for it, with error propagation. Used by the Vizier service to bound
a Pythia dispatch with the request's deadline budget — the waiter times out
(naming the operation it was waiting on) while the abandoned computation
finishes on its daemon thread.
"""

from __future__ import annotations

import threading
import traceback
from typing import Generic, Optional, TypeVar

_T = TypeVar("_T")


class ResponseWaiter(Generic[_T]):
    def __init__(self, operation_name: str = ""):
        self._operation_name = operation_name
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._response: Optional[_T] = None
        self._error: Optional[BaseException] = None
        self._error_tb: Optional[str] = None

    def Report(self, response: _T) -> None:
        with self._lock:
            if self._event.is_set():
                raise RuntimeError("ResponseWaiter already completed.")
            self._response = response
            self._event.set()

    def ReportError(self, error: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                raise RuntimeError("ResponseWaiter already completed.")
            self._error = error
            # Format NOW, on the reporting thread: once re-raised on the
            # waiting thread the traceback would be rewritten and the
            # compute-side frames lost.
            self._error_tb = "".join(
                traceback.format_exception(type(error), error, error.__traceback__)
            ).strip()
            self._event.set()

    def WaitForResponse(self, timeout: Optional[float] = None) -> _T:
        if not self._event.wait(timeout):
            suffix = (
                f" for operation {self._operation_name!r}"
                if self._operation_name
                else ""
            )
            raise TimeoutError(f"Timed out waiting for response{suffix}.")
        if self._error is not None:
            err = self._error
            # Cross-thread re-raise: ``from None`` (the waiting thread's
            # context is noise), with the original traceback text folded
            # into the message so it survives the thread hop. Guarded: a
            # second waiter must not append twice, and exceptions with
            # exotic args must still propagate.
            if self._error_tb is not None and self._error_tb not in str(err):
                try:
                    err.args = (
                        f"{err}\n--- original traceback (cross-thread) ---\n"
                        f"{self._error_tb}",
                    )
                except Exception:
                    pass
            raise err from None
        return self._response  # type: ignore[return-value]
