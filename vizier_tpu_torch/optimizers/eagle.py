"""Vectorized Eagle (firefly) strategy: the default acquisition maximizer.

Counterpart of the JAX package's ``optimizers/eagle.py``: a pool of fireflies moves
through scaled feature space under pairwise attraction toward better-scoring
flies and repulsion from worse ones, plus a decaying random perturbation;
exhausted flies are re-seeded.

Each random step is split in two: the draws, which consume the
``torch.Generator`` (``sweep_draws`` takes a whole sweep's for one study up
front, so a flush's iterations launch nothing per study), and a
deterministic apply (``apply_suggest``, ``apply_update``) that takes the
draws as inputs, so a test can feed the reference's draws to both packages.
The applies take any leading axes ahead of the pool's (``[S, P, D]``: S
studies' pools, one flush).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from vizier_tpu_torch.models import kernels

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EagleStrategyConfig:
    """Knobs (defaults follow the reference ``EagleStrategyConfig``)."""

    pool_size: int = 50
    visibility: float = 0.45
    gravity: float = 1.5
    negative_gravity: float = 0.008
    perturbation: float = 0.16
    perturbation_lower_bound: float = 7e-5
    penalize_factor: float = 0.7
    categorical_perturbation_factor: float = 25.0


@dataclasses.dataclass(frozen=True)
class EagleState:
    features: Tensor  # [(S,) P, Dc] in [0, 1]
    categorical: Tensor  # [(S,) P, Ds] int32
    rewards: Tensor  # [(S,) P] best score seen by each fly (-inf = unevaluated)
    perturbations: Tensor  # [(S,) P] current perturbation scale

    @staticmethod
    def stack(states) -> "EagleState":
        """S studies' pools as one state with a leading study axis."""
        return EagleState(*(torch.stack([getattr(s, f.name) for s in states])
                            for f in dataclasses.fields(EagleState)))


class SuggestDraws(NamedTuple):
    """The random numbers one ``suggest`` consumes."""

    noise: Tensor  # [P, Dc] standard normal
    mutate_u: Tensor  # [P, Ds] uniform: mutate when below the mutate probability
    category_u: Tensor  # [P, Ds] uniform: the random category
    copy_u: Tensor  # [P, Ds] uniform: copy the best fly's category when < 0.5


class FeatureDraws(NamedTuple):
    """Uniforms that become random features (``_features_from_draws``)."""

    continuous: Tensor  # [P, Dc]
    categorical: Tensor  # [P, Ds]


class SweepDraws(NamedTuple):
    """Every draw of a ``T``-iteration sweep: iteration t's suggest and update
    draws are ``suggest[..., t, :, :]`` and ``fresh[..., t, :, :]``."""

    suggest: SuggestDraws  # each [T, P, D]
    fresh: FeatureDraws  # each [T, P, D]

    @staticmethod
    def stack(draws) -> "SweepDraws":
        """S studies' draws with a leading study axis: [S, T, P, D]."""
        return SweepDraws(
            SuggestDraws(*(torch.stack(t) for t in zip(*(d.suggest for d in draws)))),
            FeatureDraws(*(torch.stack(t) for t in zip(*(d.fresh for d in draws)))),
        )

    def at(self, t: int) -> Tuple[SuggestDraws, FeatureDraws]:
        """Iteration t's draws of a stacked [S, T, P, D] sweep."""
        return (SuggestDraws(*(d[:, t] for d in self.suggest)),
                FeatureDraws(*(d[:, t] for d in self.fresh)))


@dataclasses.dataclass(frozen=True)
class VectorizedEagleStrategy:
    """Firefly ask/tell over mixed feature space."""

    num_continuous: int
    category_sizes: Tuple[int, ...]
    config: EagleStrategyConfig = EagleStrategyConfig()

    @property
    def num_categorical(self) -> int:
        return len(self.category_sizes)

    @property
    def batch_size(self) -> int:
        return self.config.pool_size

    def _uniform(self, generator: torch.Generator, shape) -> Tensor:
        return torch.rand(shape, generator=generator, device=generator.device)

    # -- random features ---------------------------------------------------

    def feature_draws(self, generator: torch.Generator, n: int) -> FeatureDraws:
        cont = self._uniform(generator, (n, self.num_continuous))
        cat = (
            self._uniform(generator, (n, self.num_categorical))
            if self.num_categorical
            else torch.zeros((n, 0), device=generator.device)
        )
        return FeatureDraws(cont, cat)

    def _features_from_draws(self, draws: FeatureDraws) -> Tuple[Tensor, Tensor]:
        if not self.num_categorical:
            return draws.continuous, torch.zeros(
                draws.continuous.shape[:-1] + (0,), dtype=torch.int32,
                device=draws.continuous.device,
            )
        sizes = torch.tensor(self.category_sizes, dtype=torch.int32, device=draws.categorical.device)
        cat = torch.minimum((draws.categorical * sizes).to(torch.int32), sizes - 1)
        return draws.continuous, cat

    # -- init --------------------------------------------------------------

    def init_state(
        self,
        generator: torch.Generator,
        *,
        prior_features: Optional[kernels.MixedFeatures] = None,
    ) -> EagleState:
        p = self.config.pool_size
        cont, cat = self._features_from_draws(self.feature_draws(generator, p))
        if prior_features is not None and prior_features.continuous.shape[0] > 0:
            # Seed the head of the pool with prior (e.g. best observed) points.
            k = min(prior_features.continuous.shape[0], p)
            cont = torch.cat([prior_features.continuous[:k].to(torch.float32), cont[k:]])
            if self.num_categorical:
                cat = torch.cat([prior_features.categorical[:k].to(torch.int32), cat[k:]])
        device = cont.device
        return EagleState(
            features=cont,
            categorical=cat,
            rewards=torch.full((p,), float("-inf"), device=device),
            perturbations=torch.full((p,), self.config.perturbation, device=device),
        )

    # -- ask ---------------------------------------------------------------

    def apply_suggest(self, state: EagleState, draws: SuggestDraws) -> kernels.MixedFeatures:
        cfg = self.config
        x = state.features  # [(S,) P, Dc]
        r = state.rewards

        # Pairwise pulls: toward better flies, away from worse ones.
        diff = x[..., None, :, :] - x[..., :, None, :]  # [(S,) P, P, Dc]: j - i
        sq_dist = torch.sum(diff * diff, dim=-1)
        better = (r[..., None, :] > r[..., :, None]).to(torch.float32)
        worse = 1.0 - better
        both_seen = (
            torch.isfinite(r[..., None, :]) & torch.isfinite(r[..., :, None])
        ).to(torch.float32)
        scale = torch.exp(-sq_dist / (2.0 * cfg.visibility**2 + 1e-12))
        force = both_seen * scale * (cfg.gravity * better - cfg.negative_gravity * worse)
        pull = torch.einsum("...ij,...ijd->...id", force, diff) / max(cfg.pool_size - 1, 1)
        new_x = torch.clamp(x + pull + state.perturbations[..., None] * draws.noise, 0.0, 1.0)

        # Categorical proposal: keep own category w.h.p., else copy from the
        # best-rewarded fly or mutate randomly (scaled by perturbation).
        if not self.num_categorical:
            return kernels.MixedFeatures(new_x, state.categorical)
        sizes = torch.tensor(self.category_sizes, dtype=torch.int32, device=x.device)
        best = torch.argmax(r, dim=-1, keepdim=True)[..., None]
        best_cat = torch.take_along_dim(state.categorical, best, dim=-2)  # [(S,) 1, Ds]
        mutate_prob = torch.clamp(
            state.perturbations[..., None] * cfg.categorical_perturbation_factor, max=1.0
        )
        rand_cat = torch.minimum((draws.category_u * sizes).to(torch.int32), sizes - 1)
        proposal = torch.where(draws.copy_u < 0.5, best_cat, rand_cat)
        new_cat = torch.where(draws.mutate_u < mutate_prob, proposal, state.categorical)
        return kernels.MixedFeatures(new_x, new_cat)

    def sweep_draws(self, generator: torch.Generator, iterations: int) -> SweepDraws:
        """A ``iterations``-step sweep's draws for one pool, drawn up front
        (the suggest draws of every step, then the fresh features)."""
        p, dc, ds = self.config.pool_size, self.num_continuous, self.num_categorical
        device = generator.device
        noise = torch.randn((iterations, p, dc), generator=generator, device=device)
        shape = (iterations, p, ds)
        if ds:
            mutate_u, category_u, copy_u = (self._uniform(generator, shape) for _ in range(3))
        else:
            mutate_u = category_u = copy_u = torch.zeros(shape, device=device)
        fresh_cont = self._uniform(generator, (iterations, p, dc))
        fresh_cat = self._uniform(generator, shape) if ds else torch.zeros(shape, device=device)
        return SweepDraws(
            SuggestDraws(noise, mutate_u, category_u, copy_u), FeatureDraws(fresh_cont, fresh_cat)
        )

    # -- tell --------------------------------------------------------------

    def apply_update(
        self,
        state: EagleState,
        fresh: FeatureDraws,
        candidates: kernels.MixedFeatures,
        scores: Tensor,
    ) -> EagleState:
        cfg = self.config
        improved = scores > state.rewards
        features = torch.where(improved[..., None], candidates.continuous, state.features)
        categorical = torch.where(improved[..., None], candidates.categorical, state.categorical)
        rewards = torch.where(improved, scores, state.rewards)
        # Flies that failed to improve get their perturbation penalized.
        perturbations = torch.where(
            improved,
            torch.full_like(state.perturbations, cfg.perturbation),
            state.perturbations * cfg.penalize_factor,
        )
        # Re-seed exhausted flies (perturbation collapsed), but never the
        # current best fly.
        best_idx = torch.argmax(rewards, dim=-1, keepdim=True)
        exhausted = (perturbations < cfg.perturbation_lower_bound) & (
            torch.arange(cfg.pool_size, device=scores.device) != best_idx
        )
        fresh_cont, fresh_cat = self._features_from_draws(fresh)
        return EagleState(
            features=torch.where(exhausted[..., None], fresh_cont, features),
            categorical=torch.where(exhausted[..., None], fresh_cat, categorical),
            rewards=torch.where(exhausted, torch.full_like(rewards, float("-inf")), rewards),
            perturbations=torch.where(
                exhausted, torch.full_like(perturbations, cfg.perturbation), perturbations
            ),
        )
