"""Safety wrapper: unsafe trials are shown to the inner designer as infeasible.

Copy of the JAX package's ``designers/unsafe_as_infeasible_designer.py`` on
the port's ``pyvizier.multimetric.SafetyChecker``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import multimetric
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class UnsafeAsInfeasibleDesigner(core_lib.Designer):
    problem: base_study_config.ProblemStatement
    designer_factory: core_lib.DesignerFactory = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.designer_factory is None:
            raise ValueError("designer_factory is required.")
        self._checker = multimetric.SafetyChecker(self.problem.metric_information)
        self._inner = self.designer_factory(self.problem)

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        rewritten = []
        for t in completed.trials:
            if self._checker.is_safe(t):
                rewritten.append(t)
            else:
                clone = trial_.Trial(
                    id=t.id, parameters=t.parameters, metadata=t.metadata
                )
                clone.complete(infeasibility_reason="Safety violation.")
                rewritten.append(clone)
        self._inner.update(core_lib.CompletedTrials(rewritten), all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        return list(self._inner.suggest(count))
