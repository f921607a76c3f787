"""Vectorized acquisition optimizer: an ask-evaluate-tell loop on the device.

Counterpart of the JAX package's ``optimizers/vectorized.py``: a strategy proposes
candidate batches, the scoring function evaluates them, the strategy
updates, and a running top-k of the best candidates is kept (75 000
evaluations per suggest by default). The JAX package runs the loop as one
``fori_loop`` under jit; here it is a Python loop of eager device ops with
no read-back to the host. ``run_studies`` runs S studies' sweeps as one
loop over a ``[S, P, D]`` pool, each with its own top-k and its own
generator's draws, taken up front; one study alone is a study axis of one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol, Sequence, Tuple

import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import kernels

Tensor = torch.Tensor

# (features) -> [B] scores.
ScoreFn = Callable[[kernels.MixedFeatures], Tensor]


class VectorizedStrategy(Protocol):
    """Ask/tell strategy over scaled feature space [0,1]^Dc × categories."""

    num_continuous: int

    @property
    def num_categorical(self) -> int:
        ...

    @property
    def batch_size(self) -> int:
        ...

    def init_state(self, generator: torch.Generator, *, prior_features=None):
        ...

    def sweep_draws(self, generator: torch.Generator, iterations: int):
        ...

    def apply_suggest(self, state, draws) -> kernels.MixedFeatures:
        ...

    def apply_update(self, state, fresh, candidates: kernels.MixedFeatures, scores: Tensor):
        ...


class VectorizedOptimizerResult(NamedTuple):
    features: kernels.MixedFeatures  # top-k candidates [K, ...]
    scores: Tensor  # [K]


@dataclasses.dataclass(frozen=True)
class VectorizedOptimizer:
    """Runs a strategy for ``max_evaluations`` scores, keeps the top-k."""

    strategy: VectorizedStrategy
    max_evaluations: int = 75_000
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", device_lib.resolve(self.device))

    def __call__(
        self,
        score_fn: ScoreFn,
        generator: torch.Generator,
        *,
        count: int = 1,
        prior_features: Optional[kernels.MixedFeatures] = None,
    ) -> VectorizedOptimizerResult:
        """One study's sweep: :meth:`run_studies` over a study axis of one.
        ``score_fn`` maps [P, ...] candidates to [P] scores; returns [count]
        results."""
        prior = None if prior_features is None else kernels.MixedFeatures(
            prior_features.continuous[None], prior_features.categorical[None])
        result = self.run_studies(
            lambda q: score_fn(kernels.MixedFeatures(q.continuous[0], q.categorical[0]))[None],
            [generator], count=count, prior_features=prior,
        )
        return VectorizedOptimizerResult(
            kernels.MixedFeatures(result.features.continuous[0], result.features.categorical[0]),
            result.scores[0],
        )

    def run_studies(
        self,
        score_fn: ScoreFn,
        generators: Sequence[torch.Generator],
        *,
        count: int = 1,
        prior_features: Optional[kernels.MixedFeatures] = None,
    ) -> VectorizedOptimizerResult:
        """S studies' sweeps as one loop: ``score_fn`` maps [S, P, ...]
        candidates to [S, P] scores; ``generators`` holds one generator per
        study, whose pool init and whole sweep's draws are taken before the
        loop; ``prior_features`` is [S, K, ...]. Returns [S, count, ...]
        features and [S, count] scores. A study's result depends on its own
        generator and scores only."""
        strategy = self.strategy
        iterations = max(self.max_evaluations // strategy.batch_size, 1)
        device = self.device
        for g in generators:
            if g.device.type != device.type:
                raise ValueError(f"generator is on {g.device}, expected {device}.")
        states, draws = [], []
        for s, g in enumerate(generators):
            prior = None if prior_features is None else kernels.MixedFeatures(
                prior_features.continuous[s], prior_features.categorical[s])
            states.append(strategy.init_state(g, prior_features=prior))
            draws.append(strategy.sweep_draws(g, iterations))
        state = type(states[0]).stack(states)
        sweep = type(draws[0]).stack(draws)
        studies = len(generators)
        best_cont = torch.zeros((studies, count, strategy.num_continuous), device=device)
        best_cat = torch.zeros(
            (studies, count, strategy.num_categorical), dtype=torch.int32, device=device)
        best_scores = torch.full((studies, count), float("-inf"), device=device)
        for t in range(iterations):
            suggest_draws, fresh = sweep.at(t)
            candidates = strategy.apply_suggest(state, suggest_draws)
            scores = score_fn(candidates)
            scores = torch.where(
                torch.isfinite(scores), scores, torch.full_like(scores, float("-inf"))
            )
            state = strategy.apply_update(state, fresh, candidates, scores)
            # The per-study running top-k; the stable sort keeps the earlier
            # entry on ties, as the reference's top_k does.
            all_scores = torch.cat([best_scores, scores], dim=1)
            idx = torch.sort(all_scores, dim=1, descending=True, stable=True).indices[:, :count]
            best_scores = torch.gather(all_scores, 1, idx)
            best_cont = torch.take_along_dim(
                torch.cat([best_cont, candidates.continuous], dim=1), idx[..., None], dim=1)
            best_cat = torch.take_along_dim(
                torch.cat([best_cat, candidates.categorical], dim=1), idx[..., None], dim=1)
        return VectorizedOptimizerResult(kernels.MixedFeatures(best_cont, best_cat), best_scores)


class RandomState(NamedTuple):
    """Uniform random search keeps no state between iterations."""

    @staticmethod
    def stack(states) -> "RandomState":
        del states
        return RandomState()


class RandomDraws(NamedTuple):
    """Uniforms of one batch (``[P, D]``) or of a sweep (``[(S,) T, P, D]``):
    the continuous features, and the draws that pick each category."""

    continuous: Tensor
    categorical: Tensor

    @staticmethod
    def stack(draws) -> "RandomDraws":
        """S studies' sweeps with a leading study axis: [S, T, P, D]."""
        return RandomDraws(*(torch.stack(t) for t in zip(*draws)))

    def at(self, t: int) -> Tuple["RandomDraws", None]:
        """Iteration t's draws of a stacked [S, T, P, D] sweep (no update draws)."""
        return RandomDraws(self.continuous[:, t], self.categorical[:, t]), None


@dataclasses.dataclass(frozen=True)
class RandomVectorizedStrategy:
    """Uniform random search under the vectorized interface: every batch is
    ``suggestion_batch_size`` fresh uniform points, category i drawn as
    ``min(floor(u * size_i), size_i - 1)``."""

    num_continuous: int
    num_categorical: int
    category_sizes: Tuple[int, ...]
    suggestion_batch_size: int = 64

    @property
    def batch_size(self) -> int:
        return self.suggestion_batch_size

    def init_state(self, generator: torch.Generator, *, prior_features=None) -> RandomState:
        del generator, prior_features
        return RandomState()

    def sweep_draws(self, generator: torch.Generator, iterations: int) -> RandomDraws:
        """Every uniform of an ``iterations``-step sweep, drawn up front."""
        shape = (iterations, self.suggestion_batch_size)
        device = generator.device
        cont = torch.rand(shape + (self.num_continuous,), generator=generator, device=device)
        cat = (
            torch.rand(shape + (self.num_categorical,), generator=generator, device=device)
            if self.num_categorical
            else torch.zeros(shape + (0,), device=device)
        )
        return RandomDraws(cont, cat)

    def apply_suggest(self, state: RandomState, draws: RandomDraws) -> kernels.MixedFeatures:
        del state
        if not self.num_categorical:
            cat = torch.zeros(draws.categorical.shape, dtype=torch.int32,
                              device=draws.categorical.device)
            return kernels.MixedFeatures(draws.continuous, cat)
        sizes = torch.tensor(self.category_sizes, dtype=torch.int32,
                             device=draws.categorical.device)
        cat = torch.minimum((draws.categorical * sizes).to(torch.int32), sizes - 1)
        return kernels.MixedFeatures(draws.continuous, cat)

    def apply_update(self, state: RandomState, fresh, candidates, scores) -> RandomState:
        del fresh, candidates, scores
        return state


def optimize_random(
    score_fn: ScoreFn,
    generator: torch.Generator,
    *,
    num_continuous: int,
    category_sizes: Tuple[int, ...],
    count: int = 1,
    max_evaluations: int = 10_000,
) -> VectorizedOptimizerResult:
    """Random-search acquisition maximization on the generator's device."""
    strategy = RandomVectorizedStrategy(
        num_continuous=num_continuous,
        num_categorical=len(category_sizes),
        category_sizes=tuple(category_sizes),
    )
    optimizer = VectorizedOptimizer(
        strategy, max_evaluations=max_evaluations, device=generator.device
    )
    return optimizer(score_fn, generator, count=count)
