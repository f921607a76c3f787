"""Evolution scaffolding + NSGA-II.

Counterpart of the JAX package's ``designers/evolution.py``: a canonical
evolution designer drives (population → selection → offspring) generations
from completed trials. The host side (genomes, crossover, mutation, the
``np.random.Generator`` draws) is the JAX package's numpy, draw for draw; the
NSGA-II ranking (nondomination layers + crowding distance) runs as tensor
ops of ``vizier_tpu_torch.ops.pareto`` on the designer's device, in float32
as the JAX package computes it, and comes back to the host in one copy per
survival.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import json_utils, serializable


@dataclasses.dataclass
class Population:
    """Genomes in model space ([N, Dc] floats in [0,1] + [N, Ds] ints)."""

    continuous: np.ndarray
    categorical: np.ndarray
    objectives: np.ndarray  # [N, M] all-MAXIMIZE; NaN = unevaluated

    def __len__(self) -> int:
        return self.continuous.shape[0]

    @classmethod
    def concat(cls, pops: Sequence["Population"]) -> "Population":
        return cls(
            continuous=np.concatenate([p.continuous for p in pops]),
            categorical=np.concatenate([p.categorical for p in pops]),
            objectives=np.concatenate([p.objectives for p in pops]),
        )

    def take(self, idx: np.ndarray) -> "Population":
        return Population(
            continuous=self.continuous[idx],
            categorical=self.categorical[idx],
            objectives=self.objectives[idx],
        )


def survival_ranking(objectives: np.ndarray, device: torch.device):
    """NSGA-II ranking of ``[N, M]`` all-MAXIMIZE objectives on ``device``.

    As the JAX package ranks: the objectives in float32, rows with a
    non-finite value at -1e30. Returns the host arrays ``(layers, crowding)``
    (crowding float32), read back from the device in one copy.
    """
    points = np.asarray(objectives, dtype=np.float32)
    finite = np.all(np.isfinite(points), axis=1)
    points = np.where(finite[:, None], points, np.float32(-1e30))
    tensor = torch.as_tensor(points, device=device)
    layers = pareto_ops.nondomination_layers(tensor)
    crowding = pareto_ops.crowding_distance(tensor, layers)
    # float64 holds both the layer indices and the float32 distances exactly.
    both = torch.stack([layers.to(torch.float64), crowding.to(torch.float64)]).cpu().numpy()
    return both[0].astype(np.int64), both[1].astype(np.float32)


def nsga2_survival(
    population: Population, target_size: int, device: device_lib.DeviceLike = "cuda"
) -> Population:
    """NSGA-II elitist survival: layer rank, then crowding distance."""
    layers, crowding = survival_ranking(population.objectives, device_lib.resolve(device))
    # Sort: lower layer first; within layer, higher crowding first.
    order = np.lexsort((-crowding, layers))
    return population.take(order[:target_size])


@dataclasses.dataclass
class UniformMutation:
    """Gaussian perturbation of continuous genes + categorical resampling."""

    scale: float = 0.1
    categorical_mutate_prob: float = 0.1

    def __call__(
        self,
        parents: Population,
        category_sizes: Sequence[int],
        rng: np.random.Generator,
    ) -> Tuple[np.ndarray, np.ndarray]:
        n, dc = parents.continuous.shape
        cont = parents.continuous + rng.normal(0.0, self.scale, size=(n, dc))
        cont = np.clip(cont, 0.0, 1.0)
        cat = parents.categorical.copy()
        for j, size in enumerate(category_sizes):
            mutate = rng.uniform(size=n) < self.categorical_mutate_prob
            cat[mutate, j] = rng.integers(0, size, size=int(mutate.sum()))
        return cont, cat


def sbx_crossover(
    a: np.ndarray, b: np.ndarray, rng: np.random.Generator, eta: float = 15.0
) -> np.ndarray:
    """Simulated binary crossover for continuous genes (one child per pair)."""
    u = rng.uniform(size=a.shape)
    beta = np.where(
        u <= 0.5,
        (2.0 * u) ** (1.0 / (eta + 1.0)),
        (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta + 1.0)),
    )
    child = 0.5 * ((1 + beta) * a + (1 - beta) * b)
    return np.clip(child, 0.0, 1.0)


@dataclasses.dataclass
class NSGA2Designer(core_lib.PartiallySerializableDesigner):
    """NSGA-II over flat search spaces; single- or multi-objective."""

    problem: base_study_config.ProblemStatement
    population_size: int = 50
    mutation: UniformMutation = dataclasses.field(default_factory=UniformMutation)
    eta: float = 15.0
    seed: Optional[int] = None
    # Where the survival's ranking runs: CUDA unless the caller asks for the CPU.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        self.device = device_lib.resolve(self.device)
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        self._enc = self._converter.encoder
        self._rng = np.random.default_rng(self.seed)
        self._num_suggested = 0
        m = self._converter.metrics.num_metrics
        self._population = Population(
            continuous=np.zeros((0, self._enc.num_continuous)),
            categorical=np.zeros((0, self._enc.num_categorical), dtype=np.int32),
            objectives=np.zeros((0, m)),
        )

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        trials = list(completed.trials)
        if not trials:
            return
        cont, cat = self._enc.encode(trials)
        objectives = self._converter.metrics.encode(trials)  # all-MAXIMIZE
        newcomers = Population(cont, cat.astype(np.int32), objectives)
        merged = Population.concat([self._population, newcomers])
        self._population = nsga2_survival(merged, self.population_size, self.device)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        out: List[trial_.TrialSuggestion] = []
        pop = self._population
        # NSGA-II is generation-based: the whole first generation is random.
        # Starting crossover after only a few evaluated points collapses the
        # population prematurely (visible as sub-random ZDT hypervolume).
        in_first_generation = self._num_suggested < self.population_size
        evaluated = (
            not in_first_generation
            and len(pop) > 0
            and np.isfinite(pop.objectives).any()
        )
        self._num_suggested += count
        for _ in range(count):
            if not evaluated or len(pop) < 2:
                cont = self._rng.uniform(size=(1, self._enc.num_continuous))
                cat = np.asarray(
                    [
                        [self._rng.integers(0, s) for s in self._enc.category_sizes]
                    ],
                    dtype=np.int32,
                ).reshape(1, self._enc.num_categorical)
            else:
                # Binary tournament on (layer, crowding) implicit in survival
                # order: earlier rows are better.
                i = min(self._rng.integers(0, len(pop)), self._rng.integers(0, len(pop)))
                j = min(self._rng.integers(0, len(pop)), self._rng.integers(0, len(pop)))
                child_cont = sbx_crossover(
                    pop.continuous[i : i + 1], pop.continuous[j : j + 1], self._rng, self.eta
                )
                pick = self._rng.uniform(size=(1, self._enc.num_categorical)) < 0.5
                child_cat = np.where(
                    pick, pop.categorical[i : i + 1], pop.categorical[j : j + 1]
                )
                parents = Population(
                    child_cont,
                    child_cat.astype(np.int32),
                    np.full((1, pop.objectives.shape[1]), np.nan),
                )
                cont, cat = self.mutation(parents, self._enc.category_sizes, self._rng)
            params = self._converter.to_parameters(cont, cat)[0]
            out.append(trial_.TrialSuggestion(parameters=params))
        return out

    # -- PartiallySerializable --------------------------------------------

    def dump(self) -> common.Metadata:
        md = common.Metadata()
        md["population"] = json_utils.dumps(
            {
                "continuous": self._population.continuous,
                "categorical": self._population.categorical,
                "objectives": self._population.objectives,
                "num_suggested": self._num_suggested,
            }
        )
        return md

    def load(self, metadata: common.Metadata) -> None:
        raw = metadata.get("population")
        if raw is None:
            raise serializable.DecodeError("Missing 'population'.")
        try:
            state = json_utils.loads(raw)
            self._population = Population(
                continuous=np.asarray(state["continuous"], dtype=np.float64),
                categorical=np.asarray(state["categorical"], dtype=np.int32),
                objectives=np.asarray(state["objectives"], dtype=np.float64),
            )
            # Older checkpoints lack num_suggested: a restored evaluated
            # population implies its generation was already spent — do not
            # re-run the random first generation after resume.
            self._num_suggested = int(
                state.get("num_suggested", len(self._population))
            )
        except (KeyError, ValueError, TypeError) as e:
            raise serializable.DecodeError(f"Bad population state: {e}")
