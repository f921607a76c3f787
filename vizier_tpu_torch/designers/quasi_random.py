"""Scrambled-Halton quasi-random designer.

Parity with ``vizier/_src/algorithms/designers/quasi_random.py:32``,
with our own Halton implementation (no scipy dependency in the hot path —
the generator is pure numpy and supports ``fast_forward`` for partial
serializability; the same radical-inverse core is reused by the GP designer's
seeding stage).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.designers.random import unit_to_double
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import serializable

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313,
    317, 331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409,
    419, 421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499,
]


def _radical_inverse(index: int, base: int, perm: np.ndarray) -> float:
    """Scrambled radical inverse of ``index`` in ``base``."""
    result = 0.0
    inv_base = 1.0 / base
    factor = inv_base
    while index > 0:
        digit = perm[index % base]
        result += digit * factor
        index //= base
        factor *= inv_base
    return result


class HaltonSequence:
    """Scrambled Halton sequence over [0, 1]^d with skip + fast-forward."""

    def __init__(self, num_dimensions: int, *, seed: Optional[int] = None, skip: int = 100):
        if num_dimensions > len(_PRIMES):
            raise ValueError(
                f"Halton supports up to {len(_PRIMES)} dims, got {num_dimensions}."
            )
        self._dim = num_dimensions
        self._index = skip
        rng = np.random.default_rng(seed)
        # One digit permutation per dimension (fixing 0 -> 0 keeps the
        # sequence's low-discrepancy structure).
        self._perms = []
        for d in range(num_dimensions):
            base = _PRIMES[d]
            perm = np.concatenate([[0], rng.permutation(np.arange(1, base))])
            self._perms.append(perm)

    @property
    def index(self) -> int:
        return self._index

    def fast_forward(self, count: int) -> None:
        self._index += count

    def sample(self, count: int) -> np.ndarray:
        out = np.empty((count, self._dim))
        for i in range(count):
            for d in range(self._dim):
                out[i, d] = _radical_inverse(self._index + 1, _PRIMES[d], self._perms[d])
            self._index += 1
        return out


class QuasiRandomDesigner(core_lib.PartiallySerializableDesigner):
    """Halton sampling over a flat search space (scaled per parameter)."""

    def __init__(
        self,
        search_space: pc.SearchSpace,
        *,
        seed: Optional[int] = None,
        skip_points: int = 100,
    ):
        if search_space.is_conditional:
            raise ValueError("QuasiRandomDesigner requires a flat search space.")
        self._search_space = search_space
        self._configs = search_space.parameters
        self._seed = seed if seed is not None else 0
        self._halton = HaltonSequence(
            len(self._configs), seed=self._seed, skip=skip_points
        )

    @classmethod
    def from_problem(
        cls, problem: base_study_config.ProblemStatement, seed: Optional[int] = None
    ) -> "QuasiRandomDesigner":
        return cls(problem.search_space, seed=seed)

    def update(self, completed, all_active=core_lib.ActiveTrials()) -> None:
        del completed, all_active

    def _to_value(self, config: pc.ParameterConfig, u: float) -> pc.ParameterValueTypes:
        if config.type == pc.ParameterType.DOUBLE:
            return unit_to_double(config, u)
        if config.type == pc.ParameterType.INTEGER:
            lo, hi = config.bounds
            return int(np.clip(int(lo) + int(u * (int(hi) - int(lo) + 1)), int(lo), int(hi)))
        values = config.feasible_values
        idx = min(int(u * len(values)), len(values) - 1)
        return values[idx]

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        samples = self._halton.sample(count)
        out = []
        for row in samples:
            params = trial_.ParameterDict()
            for config, u in zip(self._configs, row):
                params[config.name] = config.cast_value(self._to_value(config, float(u)))
            out.append(trial_.TrialSuggestion(parameters=params))
        return out

    # -- PartiallySerializable --------------------------------------------

    def dump(self) -> common.Metadata:
        md = common.Metadata()
        md["halton"] = json.dumps({"index": self._halton.index, "seed": self._seed})
        return md

    def load(self, metadata: common.Metadata) -> None:
        raw = metadata.get("halton")
        if raw is None:
            raise serializable.DecodeError("Missing 'halton' key.")
        try:
            state = json.loads(raw)
            index = int(state["index"])
            seed = int(state["seed"])
        except (ValueError, KeyError, TypeError) as e:
            raise serializable.DecodeError(f"Bad halton state: {e}")
        self._seed = seed  # keep dump() consistent with the restored stream
        self._halton = HaltonSequence(len(self._configs), seed=seed, skip=0)
        self._halton.fast_forward(index)
