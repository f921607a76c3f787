"""Cross-problem trial mapping for transfer learning.

Copy of the JAX package's ``converters/embedder.py`` (host Python): maps a
prior problem's trials into the current problem's space. Shared names keep
their values clipped or snapped to the current domain; missing parameters
take the current default; extra parameters are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class ProblemAndTrialsScaler:
    """Maps trials from arbitrary (prior) problems into ``problem``'s space."""

    problem: base_study_config.ProblemStatement

    def _snap(self, config: pc.ParameterConfig, value) -> pc.ParameterValueTypes:
        try:
            if config.type == pc.ParameterType.DOUBLE:
                lo, hi = config.bounds
                return float(np.clip(float(value), lo, hi))
            if config.type == pc.ParameterType.INTEGER:
                lo, hi = config.bounds
                return int(np.clip(int(round(float(value))), int(lo), int(hi)))
            if config.type == pc.ParameterType.DISCRETE:
                values = np.asarray([float(v) for v in config.feasible_values])
                return float(values[np.abs(values - float(value)).argmin()])
        except (TypeError, ValueError):
            # Prior study typed this name differently (e.g. categorical
            # value in a numeric domain) — fall back to the default.
            return config.first_feasible_value()
        # CATEGORICAL: unknown categories fall back to the default value.
        if config.contains(str(value)):
            return str(value)
        return config.first_feasible_value()

    def map_trials(self, trials: Sequence[trial_.Trial]) -> List[trial_.Trial]:
        out = []
        for t in trials:
            params = trial_.ParameterDict()
            for config in self.problem.search_space.parameters:
                if config.name in t.parameters:
                    raw = t.parameters.get_value(config.name)
                    params[config.name] = config.cast_value(self._snap(config, raw))
                else:
                    params[config.name] = config.cast_value(
                        config.first_feasible_value()
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
