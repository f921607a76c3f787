"""The port's eagle strategy and vectorized optimizer against the JAX package's.

The eagle steps split into a random draw and a deterministic apply; the
tests regenerate the JAX package's draws from its PRNG key, in its split
order, and feed them to the port's apply step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.models import kernels as jk
from vizier_tpu.optimizers import eagle as jeagle
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.optimizers import eagle as teagle
from vizier_tpu_torch.optimizers import vectorized as tvec

_SIZES = (3, 2)


def _states(seed, pool=12, dc=3):
    """The same eagle state in both packages: some flies unevaluated, some
    close to exhaustion."""
    rng = np.random.default_rng(seed)
    cfg = dict(pool_size=pool)
    jstrat = jeagle.VectorizedEagleStrategy(dc, _SIZES, jeagle.EagleStrategyConfig(**cfg))
    tstrat = teagle.VectorizedEagleStrategy(dc, _SIZES, teagle.EagleStrategyConfig(**cfg))
    rewards = rng.normal(size=pool).astype(np.float32)
    rewards[rng.choice(pool, 3, replace=False)] = -np.inf
    perturb = rng.uniform(1e-4, 0.2, size=pool).astype(np.float32)
    perturb[:4] = 5e-5
    arrays = dict(
        features=rng.uniform(size=(pool, dc)).astype(np.float32),
        categorical=np.stack([rng.integers(0, s, size=pool) for s in _SIZES], -1).astype(np.int32),
        rewards=rewards,
        perturbations=perturb,
    )
    jstate = jeagle.EagleState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = teagle.EagleState(**{k: torch.tensor(v) for k, v in arrays.items()})
    return jstrat, jstate, tstrat, tstate


@pytest.mark.parametrize("seed", [0, 1])
def test_suggest_matches_with_the_reference_draws(seed):
    jstrat, jstate, tstrat, tstate = _states(seed)
    key = jax.random.PRNGKey(seed)
    want = jstrat.suggest(jstate, key)
    # eagle.py:113-135: split(key) -> (normal noise, split(3) -> mutate, category, copy).
    p_key, c_key = jax.random.split(key)
    k1, k2, k3 = jax.random.split(c_key, 3)
    shape = jstate.categorical.shape
    draws = teagle.SuggestDraws(
        *(
            torch.tensor(np.asarray(a))
            for a in (
                jax.random.normal(p_key, jstate.features.shape),
                jax.random.uniform(k1, shape),
                jax.random.uniform(k2, shape),
                jax.random.uniform(k3, shape),
            )
        )
    )
    got = tstrat.apply_suggest(tstate, draws)
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(want.continuous), atol=1e-6)
    np.testing.assert_array_equal(got.categorical.numpy(), np.asarray(want.categorical))


@pytest.mark.parametrize("seed", [0, 1])
def test_update_matches_with_the_reference_draws(seed):
    jstrat, jstate, tstrat, tstate = _states(seed)
    rng = np.random.default_rng(seed + 10)
    cand_cont = rng.uniform(size=jstate.features.shape).astype(np.float32)
    cand_cat = np.stack([rng.integers(0, s, size=12) for s in _SIZES], -1).astype(np.int32)
    scores = rng.normal(size=12).astype(np.float32)
    key = jax.random.PRNGKey(seed + 20)
    want = jstrat.update(
        jstate, key, jk.MixedFeatures(jnp.asarray(cand_cont), jnp.asarray(cand_cat)),
        jnp.asarray(scores),
    )
    # eagle.py:68-77: split(key) -> (continuous uniforms, categorical uniforms).
    c_key, s_key = jax.random.split(key)
    fresh = teagle.FeatureDraws(
        torch.tensor(np.asarray(jax.random.uniform(c_key, (12, 3)))),
        torch.tensor(np.asarray(jax.random.uniform(s_key, (12, 2)))),
    )
    got = tstrat.apply_update(
        tstate, fresh, tk.MixedFeatures(torch.tensor(cand_cont), torch.tensor(cand_cat)),
        torch.tensor(scores),
    )
    for field in ("features", "categorical", "rewards", "perturbations"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-7
        )


def test_init_state_seeds_the_pool_head_with_prior_points():
    strat = teagle.VectorizedEagleStrategy(2, (4,), teagle.EagleStrategyConfig(pool_size=8))
    prior = tk.MixedFeatures(torch.tensor([[0.1, 0.2], [0.3, 0.4]]), torch.tensor([[3], [1]], dtype=torch.int32))
    state = strat.init_state(torch.Generator().manual_seed(0), prior_features=prior)
    torch.testing.assert_close(state.features[:2], prior.continuous)
    assert state.categorical[:2, 0].tolist() == [3, 1]
    assert state.features.shape == (8, 2) and bool(torch.all(state.categorical < 4))
    assert bool(torch.all(torch.isinf(state.rewards)))


def test_vectorized_optimizer_finds_a_quadratic_maximum():
    center = torch.tensor([0.2, 0.7, 0.5, 0.9])

    def score(f):
        bonus = (f.categorical[:, 0] == 2).to(torch.float32)
        return -torch.sum((f.continuous - center) ** 2, -1) + bonus

    strat = teagle.VectorizedEagleStrategy(4, (3,))
    opt = tvec.VectorizedOptimizer(strat, max_evaluations=5000, device="cpu")
    result = opt(score, torch.Generator().manual_seed(0), count=3)
    assert result.scores.shape == (3,)
    assert bool(torch.all(result.scores[:-1] >= result.scores[1:]))
    assert int(result.features.categorical[0, 0]) == 2
    torch.testing.assert_close(result.features.continuous[0], center, atol=0.05, rtol=0)
    assert float(result.scores[0]) > 1.0 - 1e-2
