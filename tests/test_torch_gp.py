"""The port's GP model and L-BFGS against the JAX package's.

Data and parameters are made with numpy, built into the JAX package's
``GPData`` and carried into the port with ``vizier_tpu_torch.interop``; the
port runs on CPU tensors (the plain kernel path).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import types as jtypes
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import kernels as jk
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu_torch import interop
from vizier_tpu_torch import types as ttypes
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs

_ATOL = 1e-4


def _model_data(pkg_types, seed, n, n_pad, dc, ds, dc_pad=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, dc)).astype(np.float32)
    z = rng.integers(0, 3, size=(n, ds)).astype(np.int32)
    y = (np.sin(3 * x).sum(-1) + 0.1 * rng.normal(size=n)).astype(np.float32)
    features = pkg_types.ContinuousAndCategorical(
        continuous=pkg_types.PaddedArray.from_array(x, (n_pad, dc_pad or dc)),
        categorical=pkg_types.PaddedArray.from_array(z, (n_pad, ds), fill_value=0),
    )
    labels = pkg_types.PaddedArray.from_array(y[:, None], (n_pad, 1), fill_value=np.nan)
    return pkg_types.ModelData(features, labels)


def _setup(seed=0, n=20, n_pad=32, dc=3, ds=2, dc_pad=None):
    jdata = jgp.GPData.from_model_data(_model_data(jtypes, seed, n, n_pad, dc, ds, dc_pad))
    jmodel = jgp.VizierGaussianProcess(num_continuous=dc_pad or dc, num_categorical=ds)
    tmodel = tgp.VizierGaussianProcess(num_continuous=dc_pad or dc, num_categorical=ds, device="cpu")
    # A moderately conditioned point (noise 0.1): at noise ~5e-3 the float32
    # Cholesky gradient already differs by ~5e-4 relative between the JAX
    # package's own jitted and eager runs.
    rng = np.random.default_rng(seed + 100)
    constrained = {
        "amplitude": np.float32(1.3),
        "noise_stddev": np.float32(0.1),
        "continuous_length_scales": rng.uniform(0.3, 1.0, dc_pad or dc).astype(np.float32),
        "categorical_length_scales": rng.uniform(0.5, 1.5, ds).astype(np.float32),
    }
    coll = jmodel.param_collection()
    unconstrained = {
        k: np.asarray(v)
        for k, v in coll.unconstrain({s.name: constrained[s.name] for s in coll.specs}).items()
    }
    return jmodel, jdata, tmodel, interop.gp_data_from_numpy(jdata, "cpu"), unconstrained


def _batched(params):
    return {k: v[None] for k, v in interop.gp_params_from_numpy(params, "cpu").items()}


def test_gp_data_matches_the_jax_encoding():
    jdata = jgp.GPData.from_model_data(_model_data(jtypes, 0, 7, 8, 3, 1))
    tdata = tgp.GPData.from_model_data(_model_data(ttypes, 0, 7, 8, 3, 1), torch.device("cpu"))
    for field in ("continuous", "categorical", "labels", "row_mask", "cont_dim_mask", "cat_dim_mask"):
        np.testing.assert_array_equal(getattr(tdata, field).numpy(), np.asarray(getattr(jdata, field)))


@pytest.mark.parametrize("shape", [dict(), dict(n=9, n_pad=16, dc=2, ds=0), dict(dc=3, dc_pad=5)])
def test_nll_and_gradient_match(shape):
    jmodel, jdata, tmodel, tdata, params = _setup(**shape)
    want, want_grad = jax.jit(jax.value_and_grad(jmodel.neg_log_likelihood))(
        {k: jnp.asarray(v) for k, v in params.items()}, jdata
    )
    tparams = {k: v.requires_grad_(True) for k, v in _batched(params).items()}
    got = tmodel.neg_log_likelihood(tparams, tdata)
    got_grad = torch.autograd.grad(got.sum(), list(tparams.values()))
    np.testing.assert_allclose(got.detach().numpy()[0], np.asarray(want), rtol=1e-5, atol=_ATOL)
    for name, g in zip(tparams, got_grad):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(want_grad[name]), rtol=1e-4, atol=_ATOL)


@pytest.mark.parametrize("shape", [dict(n=21, n_pad=32, dc=3, ds=2, dc_pad=5), dict(n=30, n_pad=32, dc=4, ds=0)])
def test_nll_gradient_reaches_the_noise_through_the_gram_diagonal(shape):
    """d NLL / d noise_stddev flows only through the Gram's diagonal value
    (the kernel's epilogue): held against jax.grad with padded rows and dims."""
    jmodel, jdata, tmodel, tdata, params = _setup(**shape)
    want = jax.grad(jmodel.neg_log_likelihood)({k: jnp.asarray(v) for k, v in params.items()}, jdata)
    tparams = {k: v.requires_grad_(True) for k, v in _batched(params).items()}
    (got,) = torch.autograd.grad(tmodel.neg_log_likelihood(tparams, tdata).sum(), [tparams["noise_stddev"]])
    assert abs(float(want["noise_stddev"])) > 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want["noise_stddev"]), rtol=1e-4, atol=_ATOL)


def test_precompute_and_predict_match_with_padded_rows():
    jmodel, jdata, tmodel, tdata, params = _setup(n=23, n_pad=64, dc=3, ds=2)
    jstate = jax.jit(jmodel.precompute)({k: jnp.asarray(v) for k, v in params.items()}, jdata)
    tstate = tmodel.precompute(_batched(params), tdata)
    np.testing.assert_allclose(tstate.chol[0].numpy(), np.asarray(jstate.chol), atol=_ATOL)
    np.testing.assert_allclose(tstate.alpha[0].numpy(), np.asarray(jstate.alpha), atol=_ATOL)
    rng = np.random.default_rng(9)
    q = rng.uniform(size=(15, 3)).astype(np.float32)
    zq = rng.integers(0, 3, size=(15, 2)).astype(np.int32)
    for noise in (False, True):
        jmean, jstd = jstate.predict(jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq)), include_noise=noise)
        tmean, tstd = tstate.predict(tk.MixedFeatures(torch.tensor(q), torch.tensor(zq)), include_noise=noise)
        np.testing.assert_allclose(tmean[0].numpy(), np.asarray(jmean), atol=_ATOL)
        np.testing.assert_allclose(tstd[0].numpy(), np.asarray(jstd), atol=_ATOL)


def test_masked_gram_is_identity_on_padded_rows():
    """Padded rows: unit diagonal and zero cross terms (ROADMAP C1)."""
    _, _, tmodel, tdata, params = _setup(n=5, n_pad=8)
    gram = tmodel._masked_gram(tmodel.param_collection().constrain(_batched(params)), tdata)[0]
    pad = ~tdata.row_mask
    torch.testing.assert_close(gram[pad][:, pad], torch.eye(int(pad.sum())))
    assert torch.all(gram[pad][:, ~pad] == 0) and torch.all(gram[~pad][:, pad] == 0)


def test_ensemble_predictive_matches():
    jmodel, jdata, tmodel, tdata, _ = _setup(n=12, n_pad=16)
    inits = jmodel.param_collection().batch_random_init_unconstrained(jax.random.PRNGKey(3), 3)
    jstates = jax.jit(jax.vmap(lambda p: jmodel.precompute(p, jdata)))(inits)
    tstates = tmodel.precompute(
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in inits.items()}, "cpu"), tdata
    )
    rng = np.random.default_rng(2)
    q, zq = rng.uniform(size=(6, 3)).astype(np.float32), rng.integers(0, 3, size=(6, 2)).astype(np.int32)
    want = jax.jit(lambda s, f: jgp.EnsemblePredictive(s).predict(f))(
        jstates, jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq))
    )
    got = tgp.EnsemblePredictive(tstates).predict(tk.MixedFeatures(torch.tensor(q), torch.tensor(zq)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL)


def test_non_finite_loss_is_guarded():
    """A non-finite loss maps to 1e10 in both packages (ROADMAP C1)."""
    jmodel, jdata, tmodel, tdata, params = _setup()
    bad = dict(params, amplitude=np.float32(np.nan))
    want = jmodel.neg_log_likelihood({k: jnp.asarray(v) for k, v in bad.items()}, jdata)
    got = tmodel.neg_log_likelihood(_batched(bad), tdata)
    assert float(want) == 1e10 and float(got[0]) == 1e10
    inf_data = interop.gp_data_from_numpy(jdata, "cpu")
    inf_labels = inf_data.labels.clone()
    inf_labels[0] = float("inf")
    got_inf = tmodel.neg_log_likelihood(_batched(params), dataclasses.replace(inf_data, labels=inf_labels))
    assert float(got_inf[0]) == 1e10


def test_lbfgs_reaches_the_same_best_loss():
    jmodel, jdata, tmodel, tdata, _ = _setup(seed=4, n=24, n_pad=32)
    inits = jmodel.param_collection().batch_random_init_unconstrained(jax.random.PRNGKey(5), 3)
    want = jax.jit(
        lambda i: jlbfgs.LbfgsOptimizer()(lambda p: jmodel.neg_log_likelihood(p, jdata), i)
    )(inits)
    got = tlbfgs.LbfgsOptimizer(device="cpu")(
        lambda p: tmodel.neg_log_likelihood(p, tdata),
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in inits.items()}, "cpu"),
    )
    assert abs(float(got.best_loss) - float(want.best_loss)) <= 1e-3 * abs(float(want.best_loss))


def test_adam_over_a_bound_loss_runs_the_eager_loop_on_the_cpu():
    """``cuda_graph`` only captures CUDA work: on the CPU a bound loss runs
    the eager loop and gives the floats of the plain closure."""
    from vizier_tpu_torch.optimizers import graphs

    _, _, tmodel, tdata, _ = _setup(seed=6, n=12, n_pad=16)
    inits = tmodel.param_collection().batch_random_init_unconstrained(
        torch.Generator().manual_seed(7), 3)
    want = tlbfgs.AdamOptimizer(maxiter=10, device="cpu")(
        lambda p: tmodel.neg_log_likelihood(p, tdata), inits, best_n=2)
    before = dict(graphs.STATS)
    got = tlbfgs.AdamOptimizer(maxiter=10, device="cpu", cuda_graph=True)(
        graphs.BoundLoss(tmodel.neg_log_likelihood, tdata), inits, best_n=2)
    assert graphs.STATS == before
    assert torch.equal(got.losses, want.losses)
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k])


def test_graph_keys_follow_the_layout_of_the_inputs_not_their_values():
    """The graph cache's key of a GP dataset: equal for new values of one
    layout, different for another padded row count; the dataset rebuilt from
    its tensors is the same dataset."""
    from vizier_tpu_torch.optimizers import graphs

    def layout(data):
        leaves = []
        return graphs.layout(data, leaves), leaves

    _, _, _, a, _ = _setup(seed=1, n=12, n_pad=16)
    _, _, _, b, _ = _setup(seed=2, n=10, n_pad=16)
    _, _, _, c, _ = _setup(seed=1, n=12, n_pad=32)
    (key_a, leaves_a), (key_b, _), (key_c, _) = layout(a), layout(b), layout(c)
    assert key_a == key_b and hash(key_a) == hash(key_b)
    assert key_a != key_c
    rebuilt = graphs.rebuild(a, iter(leaves_a))
    assert type(rebuilt) is type(a)
    for field in dataclasses.fields(a):
        assert getattr(rebuilt, field.name) is getattr(a, field.name)


def test_lbfgs_minimizes_a_batch_of_quadratics():
    """Restarts are independent rows: each converges to its own minimum."""
    centers = torch.tensor([[1.0, -2.0], [0.5, 3.0], [-1.0, 0.0]])
    scales = torch.tensor([1.0, 10.0])
    x, f = tlbfgs.lbfgs_minimize(
        lambda x: torch.sum(scales * (x - centers) ** 2, -1) + 1.0, torch.zeros(3, 2)
    )
    torch.testing.assert_close(x, centers, atol=1e-3, rtol=0)
    torch.testing.assert_close(f, torch.ones(3), atol=1e-6, rtol=0)


def test_select_best_keeps_the_top_restarts_in_order():
    finals = {"a": torch.arange(4.0)[:, None]}
    res = tlbfgs._select_best(finals, torch.tensor([3.0, float("nan"), 1.0, 2.0]), 2)
    assert res.params["a"][:, 0].tolist() == [2.0, 3.0]
    assert float(res.best_loss) == 1.0


def test_posterior_cholesky_refactors_in_float64_what_float32_cannot():
    """A positive definite Gram whose float32 factorization fails (all-ones
    plus 2^-22·I at 1024 rows: condition ~4e9) is factored in float64 and
    rounded back; a member float32 completes keeps its float32 factor. The
    refactor is counted (one call, one member)."""
    n = 1024
    gram = torch.ones(2, n, n) + torch.stack([2.0**-22 * torch.eye(n), 0.5 * torch.eye(n)])
    plain, info = torch.linalg.cholesky_ex(gram)
    assert info.tolist()[0] > 0 and info.tolist()[1] == 0
    before = dict(tgp.FLOAT64_REFACTORS)
    chol = tgp.posterior_cholesky(gram)
    assert {k: tgp.FLOAT64_REFACTORS[k] - before[k] for k in before} == {"calls": 1, "members": 1}
    assert bool(torch.isfinite(chol).all())
    torch.testing.assert_close(chol[0], torch.linalg.cholesky(gram[0].double()).float())
    assert torch.equal(chol[1], plain[1])
