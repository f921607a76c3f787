"""Uniform random designer.

Copy of the JAX package's ``designers/random.py`` (host numpy): the same
``np.random.Generator`` draws in the same order, so both packages give the
same points from one seed. Conditional search spaces are sampled top-down.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


def unit_to_double(config: pc.ParameterConfig, u: float) -> float:
    """Maps u ∈ [0, 1] to the parameter's range honoring its scale type.

    Shared by the random/quasi-random/grid samplers so LOG and REVERSE_LOG
    parameters get the density their scale type promises.
    """
    lo, hi = config.bounds
    if hi <= lo:
        return float(lo)
    scale = config.scale_type
    if scale == pc.ScaleType.LOG and lo > 0:
        return float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
    if scale == pc.ScaleType.REVERSE_LOG and lo > 0:
        return float(hi + lo - np.exp(np.log(lo) + (1.0 - u) * (np.log(hi) - np.log(lo))))
    return float(lo + u * (hi - lo))


def sample_parameter(
    config: pc.ParameterConfig, rng: np.random.Generator
) -> pc.ParameterValueTypes:
    """Uniformly samples one feasible value (scale-aware for DOUBLEs)."""
    if config.type == pc.ParameterType.DOUBLE:
        return unit_to_double(config, float(rng.uniform()))
    if config.type == pc.ParameterType.INTEGER:
        lo, hi = config.bounds
        return int(rng.integers(int(lo), int(hi) + 1))
    values = config.feasible_values
    return values[int(rng.integers(0, len(values)))]


def sample_point(
    search_space: pc.SearchSpace, rng: np.random.Generator
) -> trial_.ParameterDict:
    """Samples a full (conditionally-consistent) point."""
    params = trial_.ParameterDict()

    def walk(config: pc.ParameterConfig) -> None:
        value = sample_parameter(config, rng)
        params[config.name] = config.cast_value(value)
        for child in config.children:
            if any(pc.parent_value_matches(value, pv) for pv in child.matching_parent_values):
                walk(child)

    for config in search_space.parameters:
        walk(config)
    return params


class RandomDesigner(core_lib.Designer):
    """Stateless uniform sampling."""

    def __init__(
        self,
        search_space: pc.SearchSpace,
        *,
        seed: Optional[int] = None,
    ):
        self._search_space = search_space
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_problem(
        cls, problem: base_study_config.ProblemStatement, seed: Optional[int] = None
    ) -> "RandomDesigner":
        return cls(problem.search_space, seed=seed)

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        del completed, all_active

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        return [
            trial_.TrialSuggestion(parameters=sample_point(self._search_space, self._rng))
            for _ in range(count)
        ]
