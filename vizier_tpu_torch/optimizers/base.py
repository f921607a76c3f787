"""Gradient-free optimizer protocols.

Copy of the JAX package's ``optimizers/base.py`` (``BranchSelector``,
``GradientFreeOptimizer``): the interfaces that predate the vectorized
optimizers; the batched path is ``optimizers.vectorized``.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List, Sequence

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


class BranchSelector(abc.ABC):
    """Picks conditional-tree branches before continuous optimization."""

    @abc.abstractmethod
    def select_branches(
        self, problem: base_study_config.ProblemStatement, count: int
    ) -> List[Dict[str, trial_.ParameterValueTypes]]:
        ...


class GradientFreeOptimizer(abc.ABC):
    """Maximizes a batched score function over a problem's search space."""

    @abc.abstractmethod
    def optimize(
        self,
        score_fn: Callable[[Sequence[trial_.TrialSuggestion]], Sequence[float]],
        problem: base_study_config.ProblemStatement,
        *,
        count: int = 1,
    ) -> List[trial_.TrialSuggestion]:
        ...
