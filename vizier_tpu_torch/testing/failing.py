"""Deliberately failing designers (fault injection).

The port's copy of the JAX package's ``testing/failing.py``.
"""

from __future__ import annotations

from typing import List, Optional

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.pyvizier import trial as trial_


class FailedSuggestError(Exception):
    pass


class FailingDesigner(core_lib.Designer):
    """Raises on every suggest."""

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        del completed, all_active

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        raise FailedSuggestError("FailingDesigner always fails.")


class AlternateFailingDesigner(core_lib.Designer):
    """Fails every second suggest call (retry-path testing)."""

    def __init__(self, inner: core_lib.Designer):
        self._inner = inner
        self._calls = 0

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        self._inner.update(completed, all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        self._calls += 1
        if self._calls % 2 == 1:
            raise FailedSuggestError("AlternateFailingDesigner fails on odd calls.")
        return list(self._inner.suggest(count))
