"""Singleton-parameter stripping.

Copy of the JAX package's ``pythia/singleton_params.py``: parameters with
exactly one feasible value carry no information for the model, so they are
stripped from the problem before an algorithm sees it, and their fixed
values are re-attached to every suggestion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class SingletonParameterHandler:
    """Splits a problem into (reduced problem, fixed singleton values)."""

    problem: base_study_config.ProblemStatement

    def __post_init__(self):
        self._fixed: Dict[str, pc.ParameterValueTypes] = {}
        kept: List[pc.ParameterConfig] = []
        for config in self.problem.search_space.parameters:
            if not config.children and config.num_feasible_values == 1:
                if config.type == pc.ParameterType.DOUBLE:
                    value = config.bounds[0]
                else:
                    value = config.feasible_values[0]
                self._fixed[config.name] = config.cast_value(value)
            else:
                kept.append(config)
        space = pc.SearchSpace(kept)
        self.reduced_problem = base_study_config.ProblemStatement(
            search_space=space,
            metric_information=self.problem.metric_information,
            metadata=self.problem.metadata,
        )

    @property
    def fixed_parameters(self) -> Dict[str, pc.ParameterValueTypes]:
        return dict(self._fixed)

    def augment(
        self, suggestions: Sequence[trial_.TrialSuggestion]
    ) -> List[trial_.TrialSuggestion]:
        """Re-attaches the stripped singleton values to each suggestion."""
        for s in suggestions:
            for name, value in self._fixed.items():
                if name not in s.parameters:
                    s.parameters[name] = value
        return list(suggestions)

    def strip(self, trials: Sequence[trial_.Trial]) -> List[trial_.Trial]:
        """Removes singleton parameters from trials (for designer updates)."""
        out = []
        for t in trials:
            params = trial_.ParameterDict(
                {k: v for k, v in t.parameters.items() if k not in self._fixed}
            )
            clone = trial_.Trial(
                id=t.id,
                parameters=params,
                metadata=t.metadata,
                measurements=list(t.measurements),
                final_measurement=t.final_measurement,
                infeasibility_reason=t.infeasibility_reason,
            )
            out.append(clone)
        return out
