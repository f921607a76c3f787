"""The single-objective GP surface of the port against the JAX package's.

Adam, the random vectorized strategy, the LCB / LogEI / PI / Sample /
q-acquisition / MES acquisitions, and the GP's joint posterior, samples and
per-member predictions (the stack and the joint score functions are in
``test_torch_joint.py``). Inputs are made with numpy; random numbers are the
JAX package's draws, regenerated from its keys and fed to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import types as jtypes
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import kernels as jk
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.optimizers import vectorized as jvec
from vizier_tpu_torch import interop
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.optimizers import vectorized as tvec

_RTOL, _ATOL = 1e-5, 1e-6


def _data(seed=0, n=16, n_pad=32, dc=3, ds=0, shift=0.0):
    """The same GPData in both packages: n rows of a smooth objective."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, dc)).astype(np.float32)
    z = rng.integers(0, 3, size=(n, ds)).astype(np.int32)
    y = (np.sin(3 * x + shift).sum(-1) + 0.1 * rng.normal(size=n)).astype(np.float32)
    md = jtypes.ModelData(
        jtypes.ContinuousAndCategorical(
            continuous=jtypes.PaddedArray.from_array(x, (n_pad, dc)),
            categorical=jtypes.PaddedArray.from_array(z, (n_pad, ds), fill_value=0),
        ),
        jtypes.PaddedArray.from_array(y[:, None], (n_pad, 1), fill_value=np.nan),
    )
    jdata = jgp.GPData.from_model_data(md)
    return jdata, interop.gp_data_from_numpy(jdata, "cpu")


def _models(dc=3, ds=0, **kw):
    return (jgp.VizierGaussianProcess(num_continuous=dc, num_categorical=ds, **kw),
            tgp.VizierGaussianProcess(num_continuous=dc, num_categorical=ds, device="cpu", **kw))


def _params(seed, members, dc=3, ds=0, noise=0.1, length_scales=(0.3, 1.0)):
    """Constrained parameters of ``members`` ensemble members, as numpy."""
    rng = np.random.default_rng(seed)
    params = {
        "amplitude": rng.uniform(0.8, 1.5, members).astype(np.float32),
        "noise_stddev": np.full(members, noise, np.float32),
        "continuous_length_scales": rng.uniform(*length_scales, (members, dc)).astype(np.float32),
    }
    if ds:
        params["categorical_length_scales"] = rng.uniform(0.5, 1.5, (members, ds)).astype(np.float32)
    return params


def _states(jmodel, tmodel, jdata, tdata, params):
    jstates = jax.vmap(lambda p: jmodel.precompute_constrained(p, jdata))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tstates = tmodel.precompute_constrained(interop.gp_params_from_numpy(params, "cpu"), tdata)
    return jstates, tstates


def _query(seed, shape, dc=3, ds=0):
    rng = np.random.default_rng(seed)
    cont = rng.uniform(size=shape + (dc,)).astype(np.float32)
    cat = rng.integers(0, 3, size=shape + (ds,)).astype(np.int32)
    return (jk.MixedFeatures(jnp.asarray(cont), jnp.asarray(cat)),
            tk.MixedFeatures(torch.tensor(cont), torch.tensor(cat)))


def _close(got, want, rtol=_RTOL, atol=_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# -- optimizers ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_adam_matches_the_jax_package(seed):
    """Same inits (the JAX draws), same NLL: final parameters within 1e-4
    relative to the largest of them (an unconstrained parameter near 0 has
    no scale of its own), the losses within 1e-4 relative, and the same
    restart chosen."""
    jdata, tdata = _data(seed)
    jmodel, tmodel = _models()
    inits = jmodel.param_collection().batch_random_init_unconstrained(jax.random.PRNGKey(seed), 4)
    want = jlbfgs.AdamOptimizer(maxiter=20)(lambda p: jmodel.neg_log_likelihood(p, jdata), inits)
    got = tlbfgs.AdamOptimizer(maxiter=20, device="cpu")(
        lambda p: tmodel.neg_log_likelihood(p, tdata),
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in inits.items()}, "cpu"))
    _close(got.losses, want.losses, rtol=1e-4)
    assert int(torch.argmin(got.losses)) == int(jnp.argmin(want.losses))
    assert set(got.params) == set(want.params)
    scale = max(float(jnp.max(jnp.abs(v))) for v in want.params.values())
    for k, v in want.params.items():
        _close(got.params[k], v, rtol=0.0, atol=1e-4 * scale)


def test_adam_keeps_each_studys_best_in_groups():
    """Two studies' restart blocks in one batch: each keeps its own best,
    as each alone would."""
    _, tdata = _data(0)
    _, tmodel = _models()
    coll = tmodel.param_collection()
    inits = coll.batch_random_init_unconstrained(torch.Generator().manual_seed(0), 6)
    adam = tlbfgs.AdamOptimizer(maxiter=5, device="cpu")
    loss = lambda p: tmodel.neg_log_likelihood(p, tdata)  # noqa: E731
    both = adam(loss, inits, best_n=1, groups=2)
    for s in range(2):
        alone = adam(loss, {k: v[3 * s: 3 * s + 3] for k, v in inits.items()}, best_n=1)
        for k in inits:
            torch.testing.assert_close(both.params[k][s], alone.params[k][0])
    assert isinstance(tlbfgs.default_optimizer("cpu"), tlbfgs.LbfgsOptimizer)


def _random_sweep_draws(key, iterations, pool, dc, ds):
    """The JAX package's VectorizedOptimizer draws for its random strategy,
    in its split order (vectorized.py: the init split, then per iteration
    split(rng, 3) and the suggest's split)."""
    rng, _ = jax.random.split(key)
    cont, cat = [], []
    for _ in range(iterations):
        rng, s_rng, _ = jax.random.split(rng, 3)
        c_rng, k_rng = jax.random.split(s_rng)
        cont.append(np.asarray(jax.random.uniform(c_rng, (pool, dc), dtype=jnp.float32)))
        cat.append(np.asarray(jax.random.uniform(k_rng, (pool, ds))))
    return tvec.RandomDraws(torch.tensor(np.stack(cont)), torch.tensor(np.stack(cat)))


class _FedRandom(tvec.RandomVectorizedStrategy):
    """The port's random strategy with a sweep's draws given."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "fed", draws)

    def sweep_draws(self, generator, iterations):
        return self.fed


def test_random_strategy_matches_with_the_jax_uniforms():
    """Identical candidates, and an identical top-k, with the JAX draws fed in."""
    sizes, dc, pool, evals = (3, 2), 2, 16, 160
    kw = dict(num_continuous=dc, num_categorical=len(sizes), category_sizes=sizes,
              suggestion_batch_size=pool)
    jstrat = jvec.RandomVectorizedStrategy(**kw)
    key = jax.random.PRNGKey(4)
    draws = _random_sweep_draws(key, evals // pool, pool, dc, len(sizes))
    tstrat = _FedRandom(draws, **kw)
    first = jstrat.suggest(None, jax.random.split(jax.random.split(key)[0], 3)[1])
    got = tstrat.apply_suggest(None, tvec.RandomDraws(draws.continuous[0], draws.categorical[0]))
    np.testing.assert_array_equal(got.continuous.numpy(), np.asarray(first.continuous))
    np.testing.assert_array_equal(got.categorical.numpy(), np.asarray(first.categorical))

    center = np.array([0.3, 0.6], np.float32)

    def jscore(f):
        return -jnp.sum((f.continuous - center) ** 2, -1) + 0.1 * (f.categorical[:, 0] == 2)

    def tscore(f):
        return -torch.sum((f.continuous - torch.tensor(center)) ** 2, -1) + 0.1 * (
            f.categorical[:, 0] == 2)

    want = jvec.VectorizedOptimizer(jstrat, max_evaluations=evals)(jscore, key, count=3)
    result = tvec.VectorizedOptimizer(tstrat, max_evaluations=evals, device="cpu")(
        tscore, torch.Generator().manual_seed(0), count=3)
    np.testing.assert_array_equal(result.features.continuous.numpy(),
                                  np.asarray(want.features.continuous))
    np.testing.assert_array_equal(result.features.categorical.numpy(),
                                  np.asarray(want.features.categorical))
    _close(result.scores, want.scores)


def test_optimize_random_returns_the_best_of_its_draws():
    result = tvec.optimize_random(
        lambda f: -torch.sum((f.continuous - 0.5) ** 2, -1), torch.Generator().manual_seed(0),
        num_continuous=2, category_sizes=(4,), count=2, max_evaluations=640)
    assert result.features.continuous.shape == (2, 2) and result.scores.shape == (2,)
    assert bool(torch.all(result.features.categorical < 4))
    assert float(result.scores[0]) >= float(result.scores[1]) > -0.05


# -- acquisitions ----------------------------------------------------------------


def _posterior(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32), rng.uniform(0.01, 2.0, n).astype(np.float32),
            np.float32(rng.normal()))


@pytest.mark.parametrize("make_j,make_t", [
    (lambda: jacq.LCB(1.8), lambda: tacq.LCB(1.8)), (jacq.PI, tacq.PI)], ids=["lcb", "pi"])
def test_lcb_and_pi_match(make_j, make_t):
    mean, std, best = _posterior(0)
    want = make_j()(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(best))
    _close(make_t()(torch.tensor(mean), torch.tensor(std), torch.tensor(best)), want)


def test_log_ei_matches_across_its_three_regimes():
    """z from −40 to 5, straddling −1 and −10. The two packages' log_ndtr
    differ in the mid regime's last digits, so there it is held to 1e-4
    relative; elsewhere to rtol 1e-5, atol 1e-6."""
    z = np.concatenate([np.linspace(-40, 5, 451), [-10.0, -1.0, -10.0001, -0.9999]]).astype(
        np.float32)
    std = np.full_like(z, 0.7)
    best = np.float32(0.3)
    mean = (z * std + best).astype(np.float32)
    zr = (mean - best) / std
    want = np.asarray(jacq.LogEI()(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(best)))
    got = tacq.LogEI()(torch.tensor(mean), torch.tensor(std), torch.tensor(best)).numpy()
    assert np.all(np.isfinite(got))
    direct = zr > -1.0
    _close(got[direct], want[direct])
    _close(got[~direct], want[~direct], rtol=1e-4, atol=0.0)


def test_sample_matches_with_the_jax_draws_and_repeats_its_draws():
    mean, std, best = _posterior(1)
    key = jax.random.PRNGKey(5)
    want = jacq.Sample(key)(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(best))
    eps = torch.tensor(np.asarray(jax.random.normal(key, mean.shape)))
    _close(tacq.Sample.apply(torch.tensor(mean), torch.tensor(std), eps), want)
    sample = tacq.Sample(seed=5)
    first = sample(torch.tensor(mean), torch.tensor(std), torch.tensor(best))
    torch.testing.assert_close(sample(torch.tensor(mean), torch.tensor(std), None), first,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["qei", "qpi", "qucb"])
def test_q_acquisition_matches_with_the_jax_draws(kind):
    rng = np.random.default_rng(2)
    means = rng.normal(size=(3, 20)).astype(np.float32)
    stds = rng.uniform(0.1, 1.0, (3, 20)).astype(np.float32)
    best = np.float32(0.5)
    key = jax.random.PRNGKey(6)
    want = jacq.q_acquisition(jnp.asarray(means), jnp.asarray(stds), key,
                              best_label=jnp.asarray(best), num_samples=32, kind=kind)
    eps = torch.tensor(np.asarray(jax.random.normal(key, (32, 3, 20))))
    got = tacq.q_acquisition(torch.tensor(means), torch.tensor(stds), eps,
                             best_label=torch.tensor(best), num_samples=32, kind=kind)
    _close(got, want)
    with pytest.raises(ValueError):
        tacq.q_acquisition(torch.tensor(means), torch.tensor(stds), eps,
                           best_label=torch.tensor(best), kind="qnope")


class _Fixed:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def predict(self, query):
        del query
        return self.mean, self.std


def test_mes_matches_with_the_jax_uniforms():
    mean, std, best = _posterior(3, n=30)
    key = jax.random.PRNGKey(7)
    want_mes = jacq.MaxValueEntropySearch.from_predictive(
        _Fixed(jnp.asarray(mean), jnp.asarray(std)), None, key, num_samples=16)
    u = jax.random.uniform(key, (16,), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got_mes = tacq.MaxValueEntropySearch.from_predictive(
        _Fixed(torch.tensor(mean), torch.tensor(std)), None, torch.tensor(np.asarray(u)),
        num_samples=16)
    _close(got_mes.y_star_samples, want_mes.y_star_samples)
    q_mean, q_std, _ = _posterior(4, n=40)
    want = want_mes(jnp.asarray(q_mean), jnp.asarray(q_std), None)
    _close(got_mes(torch.tensor(q_mean), torch.tensor(q_std), None), want, rtol=1e-5, atol=1e-5)
    drawn = tacq.MaxValueEntropySearch.from_predictive(
        _Fixed(torch.tensor(mean), torch.tensor(std)), None, torch.Generator().manual_seed(0))
    assert drawn.y_star_samples.shape == (16,) and bool(torch.isfinite(drawn.y_star_samples).all())


# -- GP posterior ------------------------------------------------------------------


@pytest.mark.parametrize("ds", [0, 2])
def test_predict_joint_matches_and_is_symmetric(ds):
    jdata, tdata = _data(0, ds=ds)
    jmodel, tmodel = _models(ds=ds)
    jstates, tstates = _states(jmodel, tmodel, jdata, tdata, _params(0, 2, ds=ds))
    jq, tq = _query(1, (5,), ds=ds)
    want_mean, want_cov = jax.vmap(lambda s: s.predict_joint(jq))(jstates)
    mean, cov = tstates.predict_joint(tq)
    _close(mean, want_mean, atol=1e-5)
    _close(cov, want_cov, atol=1e-5)
    assert torch.equal(cov, cov.transpose(-1, -2))
    # A candidate axis: each candidate's joint posterior, from one k* and one
    # K(q, q) launch.
    jq, tq = _query(2, (6, 4), ds=ds)
    want_mean, want_cov = jax.vmap(
        lambda qc, qz: jax.vmap(lambda s: s.predict_joint(jk.MixedFeatures(qc, qz)))(jstates)
    )(jq.continuous, jq.categorical)
    mean, cov = tstates.predict_joint(tq)
    assert mean.shape == (6, 2, 4) and cov.shape == (6, 2, 4, 4)
    _close(mean, want_mean, atol=1e-5)
    _close(cov, want_cov, atol=1e-5)
    assert torch.equal(cov, cov.transpose(-1, -2))


def test_predict_joint_with_input_warping_matches():
    jdata, tdata = _data(3)
    jmodel, tmodel = _models(use_input_warping=True)
    params = dict(_params(3, 2), warp_a=np.full((2, 3), 1.3, np.float32),
                  warp_b=np.full((2, 3), 0.8, np.float32))
    jstates, tstates = _states(jmodel, tmodel, jdata, tdata, params)
    jq, tq = _query(4, (3, 2))
    want_mean, want_cov = jax.vmap(
        lambda qc, qz: jax.vmap(lambda s: s.predict_joint(jk.MixedFeatures(qc, qz)))(jstates)
    )(jq.continuous, jq.categorical)
    mean, cov = tstates.predict_joint(tq)
    _close(mean, want_mean, atol=1e-5)
    _close(cov, want_cov, atol=1e-5)


def test_sample_and_per_member_predictions_match():
    jdata, tdata = _data(1)
    jmodel, tmodel = _models()
    jstates, tstates = _states(jmodel, tmodel, jdata, tdata, _params(1, 3))
    jq, tq = _query(5, (7,))
    key = jax.random.PRNGKey(8)
    want = jax.vmap(lambda s: s.sample(jq, key, 4))(jstates)  # [E, S, Q]
    eps = np.asarray(jax.random.normal(key, (4, 7)))
    got = tstates.sample(tq, torch.tensor(np.broadcast_to(eps[:, None], (4, 3, 7)).copy()))
    _close(got.transpose(0, 1), want, atol=1e-5)
    want_mean, want_std = jgp.EnsemblePredictive(jstates).predict_per_member(jq)
    mean, std = tgp.EnsemblePredictive(tstates).predict_per_member(tq)
    _close(mean, want_mean, atol=1e-5)
    _close(std, want_std, atol=1e-5)


def test_linear_mean_declares_the_same_parameter_and_nll():
    """The JAX package's ``use_linear_mean`` declares ``mean_scale`` and no
    mean reads it: the same spec, and the same NLL at the same values."""
    jdata, tdata = _data(2)
    jmodel, tmodel = _models(use_linear_mean=True)
    jspecs = {s.name: s for s in jmodel.param_collection().specs}
    tspecs = {s.name: s for s in tmodel.param_collection().specs}
    assert set(jspecs) == set(tspecs) and "mean_scale" in tspecs
    for name in ("shape", "init_low", "init_high", "prior_mu", "prior_sigma"):
        assert getattr(tspecs["mean_scale"], name) == getattr(jspecs["mean_scale"], name)
    inits = jmodel.param_collection().batch_random_init_unconstrained(jax.random.PRNGKey(2), 3)
    want = jax.vmap(lambda p: jmodel.neg_log_likelihood(p, jdata))(inits)
    got = tmodel.neg_log_likelihood(
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in inits.items()}, "cpu"), tdata)
    _close(got, want, rtol=1e-5, atol=1e-4)
