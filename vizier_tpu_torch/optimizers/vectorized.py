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
from typing import Callable, NamedTuple, Optional, Protocol, Sequence

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
