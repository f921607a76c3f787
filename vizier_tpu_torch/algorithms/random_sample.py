"""Random sampling helpers over search spaces (numpy Generator based).

Copy of the JAX package's ``algorithms/random_sample.py`` (host numpy):
per-type value samplers, closest-element snapping for DISCRETE, and
whole-search-space parameter sampling, for designers that need one-off
random draws (eagle utilities, ensembles).
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

import numpy as np

from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_

_T = TypeVar("_T")


def sample_uniform(
    rng: np.random.Generator, min_value: float = 0.0, max_value: float = 1.0
) -> float:
    return float(rng.uniform(low=min_value, high=max_value))


def sample_bernoulli(
    rng: np.random.Generator, prob1: float, value1: _T = 0, value2: _T = 1
) -> _T:
    return value1 if rng.random() < prob1 else value2


def sample_integer(
    rng: np.random.Generator, min_value: float, max_value: float
) -> int:
    return round(sample_uniform(rng, min_value, max_value))


def sample_categorical(rng: np.random.Generator, categories: Sequence[str]) -> str:
    return str(categories[int(rng.integers(len(categories)))])


def get_closest_element(array: Sequence[float], value: float) -> float:
    arr = np.asarray(list(array), dtype=float)
    return float(arr[int(np.argmin(np.abs(arr - value)))])


def sample_discrete(
    rng: np.random.Generator, feasible_points: Sequence[float]
) -> float:
    """Uniform over the continuous span, snapped to the closest point.

    (Matches the reference: NOT uniform over the point set — points with
    wide gaps around them are proportionally more likely.)
    """
    points = [float(p) for p in feasible_points]
    value = sample_uniform(rng, min(points), max(points))
    return get_closest_element(points, value)


def sample_value(
    rng: np.random.Generator, param_config: pc.ParameterConfig
) -> pc.ParameterValueTypes:
    """Random value of the parameter's own type."""
    if param_config.type == pc.ParameterType.CATEGORICAL:
        return sample_categorical(rng, [str(v) for v in param_config.feasible_values])
    if param_config.type == pc.ParameterType.DISCRETE:
        return sample_discrete(rng, [float(v) for v in param_config.feasible_values])
    min_value, max_value = param_config.bounds
    if param_config.type == pc.ParameterType.INTEGER:
        return sample_integer(rng, min_value, max_value)
    return sample_uniform(rng, min_value, max_value)


def sample_parameters(
    rng: np.random.Generator, search_space: pc.SearchSpace
) -> trial_.ParameterDict:
    """Random assignment for every top-level parameter in the space."""
    out = trial_.ParameterDict()
    for config in search_space.parameters:
        out[config.name] = trial_.ParameterValue(sample_value(rng, config))
    return out


def shuffle_list(rng: np.random.Generator, items: List[_T]) -> List[_T]:
    rng.shuffle(items)
    return items
