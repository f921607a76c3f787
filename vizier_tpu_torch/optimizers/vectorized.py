"""Vectorized acquisition optimizer: an ask-evaluate-tell loop on the device.

Counterpart of the JAX package's ``optimizers/vectorized.py``: a strategy proposes
candidate batches, the scoring function evaluates them, the strategy
updates, and a running top-k of the best candidates is kept (75 000
evaluations per suggest by default). The JAX package runs the loop as one
``fori_loop`` under jit; here it is a Python loop of eager device ops with
no read-back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol

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

    def suggest(self, state, generator: torch.Generator) -> kernels.MixedFeatures:
        ...

    def update(self, state, generator, candidates: kernels.MixedFeatures, scores: Tensor):
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
        strategy = self.strategy
        iterations = max(self.max_evaluations // strategy.batch_size, 1)
        device = self.device
        if generator.device.type != device.type:
            raise ValueError(f"generator is on {generator.device}, expected {device}.")
        state = strategy.init_state(generator, prior_features=prior_features)
        best_cont = torch.zeros((count, strategy.num_continuous), device=device)
        best_cat = torch.zeros((count, strategy.num_categorical), dtype=torch.int32, device=device)
        best_scores = torch.full((count,), float("-inf"), device=device)
        for _ in range(iterations):
            candidates = strategy.suggest(state, generator)
            scores = score_fn(candidates)
            scores = torch.where(
                torch.isfinite(scores), scores, torch.full_like(scores, float("-inf"))
            )
            state = strategy.update(state, generator, candidates, scores)
            # Merge into the running top-k; the stable sort keeps the earlier
            # entry on ties, as the reference's top_k does.
            all_scores = torch.cat([best_scores, scores])
            idx = torch.sort(all_scores, descending=True, stable=True).indices[:count]
            best_scores = all_scores[idx]
            best_cont = torch.cat([best_cont, candidates.continuous])[idx]
            best_cat = torch.cat([best_cat, candidates.categorical])[idx]
        return VectorizedOptimizerResult(kernels.MixedFeatures(best_cont, best_cat), best_scores)
