"""The search space's default point (the JAX package's ``designer_policy``)."""

from __future__ import annotations

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


def default_suggestion(problem: base_study_config.ProblemStatement) -> trial_.TrialSuggestion:
    """The search space's default/center point (used to seed empty studies).

    Each parameter takes its default value (or center/first feasible),
    walking conditional children whose activation matches the parent value.
    """
    params = trial_.ParameterDict()

    def assign(config: pc.ParameterConfig) -> None:
        value = config.first_feasible_value()
        params[config.name] = config.cast_value(value)
        for child in config.children:
            if any(pc.parent_value_matches(value, pv) for pv in child.matching_parent_values):
                assign(child)

    for config in problem.search_space.parameters:
        assign(config)
    return trial_.TrialSuggestion(parameters=params)
