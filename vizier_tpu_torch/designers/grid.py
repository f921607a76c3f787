"""Grid-search designer (+ shuffled variant).

Copy of the JAX package's ``designers/grid.py`` (host numpy):
cross-product grid over the (flat) search space with a serialized position;
DOUBLE parameters are discretized to ``double_grid_resolution`` points. The
dumped state has the JAX package's format, so either package resumes the
other's walk.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.designers import random as random_designer
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import serializable


def _axis_values(
    config: pc.ParameterConfig, resolution: int
) -> List[pc.ParameterValueTypes]:
    if config.type == pc.ParameterType.DOUBLE:
        lo, hi = config.bounds
        if lo == hi:
            return [lo]
        return [
            random_designer.unit_to_double(config, u)
            for u in np.linspace(0.0, 1.0, resolution)
        ]
    return list(config.feasible_values)


class GridSearchDesigner(core_lib.PartiallySerializableDesigner):
    """Enumerates the grid in mixed-radix order from a stored position."""

    def __init__(
        self,
        search_space: pc.SearchSpace,
        *,
        shuffle_seed: Optional[int] = None,
        double_grid_resolution: int = 10,
    ):
        if search_space.is_conditional:
            raise ValueError("GridSearchDesigner requires a flat search space.")
        self._search_space = search_space
        self._configs = search_space.parameters
        self._axes = [
            _axis_values(c, double_grid_resolution) for c in self._configs
        ]
        self._size = int(np.prod([len(a) for a in self._axes])) if self._axes else 0
        self._position = 0
        self._shuffle_seed = shuffle_seed
        if shuffle_seed is not None and self._size > 0:
            rng = np.random.default_rng(shuffle_seed)
            self._order = rng.permutation(self._size)
        else:
            self._order = None

    @classmethod
    def from_problem(
        cls, problem: base_study_config.ProblemStatement, seed: Optional[int] = None
    ) -> "GridSearchDesigner":
        return cls(problem.search_space, shuffle_seed=seed)

    @property
    def grid_size(self) -> int:
        return self._size

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        del completed, all_active

    def _point(self, flat_index: int) -> trial_.ParameterDict:
        if self._order is not None:
            flat_index = int(self._order[flat_index])
        params = trial_.ParameterDict()
        for config, axis in zip(self._configs, self._axes):
            flat_index, idx = divmod(flat_index, len(axis))
            params[config.name] = config.cast_value(axis[idx])
        return params

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        out = []
        while len(out) < count and self._position < self._size:
            out.append(trial_.TrialSuggestion(parameters=self._point(self._position)))
            self._position += 1
        return out  # may be fewer than requested once the grid is exhausted

    # -- PartiallySerializable --------------------------------------------

    def dump(self) -> common.Metadata:
        md = common.Metadata()
        md["grid"] = json.dumps(
            {"position": self._position, "shuffle_seed": self._shuffle_seed}
        )
        return md

    def load(self, metadata: common.Metadata) -> None:
        raw = metadata.get("grid")
        if raw is None:
            raise serializable.DecodeError("Missing 'grid' key.")
        try:
            state = json.loads(raw)
            position = int(state["position"])
            shuffle_seed = state.get("shuffle_seed")
        except (ValueError, KeyError, TypeError) as e:
            raise serializable.DecodeError(f"Bad grid state: {e}")
        self._position = position
        # The stored order, not the constructor's, must govern the walk.
        if shuffle_seed != self._shuffle_seed:
            self._shuffle_seed = shuffle_seed
            if shuffle_seed is not None and self._size > 0:
                rng = np.random.default_rng(shuffle_seed)
                self._order = rng.permutation(self._size)
            else:
                self._order = None
