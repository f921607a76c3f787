"""The port's sharded train and pool sweep against the JAX package's, on the
JAX package's 8 virtual CPU devices and the port's 8 CPU entries.

The JAX package draws the restart inits from its key and splits one key into
per-pool keys; the tests regenerate those inits and each pool's sweep draws
(the random strategy's, in the JAX package's split order) and feed them to
the port (``inits=``, one generator per pool whose seed names its draws).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu import parallel as jparallel
from vizier_tpu import types as jtypes
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import multitask_gp as jmt
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.optimizers import vectorized as jvec
from vizier_tpu_torch import interop
from vizier_tpu_torch import parallel as tparallel
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.models import multitask_gp as tmt
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.optimizers import vectorized as tvec


@pytest.fixture
def meshes(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch)
    return jparallel.create_mesh(), tparallel.create_mesh(device="cpu")


def _data(seed=0, n=12, n_pad=16, dc=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, dc)).astype(np.float32)
    y = (-np.sum((x - 0.5) ** 2, axis=1) + 0.05 * rng.normal(size=n)).astype(np.float32)
    md = jtypes.ModelData(
        jtypes.ContinuousAndCategorical(
            continuous=jtypes.PaddedArray.from_array(x, (n_pad, dc)),
            categorical=jtypes.PaddedArray.from_array(
                np.zeros((n, 0), np.int32), (n_pad, 0), fill_value=0),
        ),
        jtypes.PaddedArray.from_array(y[:, None], (n_pad, 1), fill_value=np.nan),
    )
    jdata = jgp.GPData.from_model_data(md)
    return jdata, interop.gp_data_from_numpy(jdata, "cpu")


def _models(dc=2):
    return (jgp.VizierGaussianProcess(num_continuous=dc, num_categorical=0),
            tgp.VizierGaussianProcess(num_continuous=dc, num_categorical=0, device="cpu"))


def _torch_params(params):
    return interop.gp_params_from_numpy({k: np.asarray(v) for k, v in params.items()}, "cpu")


def _close_params(got, want, rtol=1e-4):
    """Every leaf within ``rtol`` of the largest value of the JAX package's."""
    assert set(got) == set(want)
    scale = max(float(jnp.max(jnp.abs(v))) for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0.0, atol=rtol * scale)


# -- the sharded train -----------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_start"])
def test_train_gp_sharded_equals_the_jax_packages_with_its_inits(meshes, warm):
    """8 restarts over 8 devices, the best 2 kept: the chosen members'
    parameters within 1e-4 of the largest and their NLL within 1e-4
    relative; with a warm start, restart 0 replaced in both packages."""
    jmesh, tmesh = meshes
    jdata, tdata = _data()
    jmodel, tmodel = _models()
    key = jax.random.PRNGKey(0)
    inits = jmodel.param_collection().batch_random_init_unconstrained(key, 8)
    warm_start = (jmodel.param_collection().random_init_unconstrained(jax.random.PRNGKey(5))
                  if warm else None)
    want = jparallel.train_gp_sharded(
        jmodel, jlbfgs.AdamOptimizer(maxiter=30), jdata, key, 8, 2, jmesh, warm_start)
    got = tparallel.train_gp_sharded(
        tmodel, tlbfgs.AdamOptimizer(maxiter=30, device="cpu"), tdata, None, 8, 2, tmesh,
        None if warm_start is None else _torch_params(warm_start), inits=_torch_params(inits))
    assert got.alpha.shape[0] == want.alpha.shape[0] == 2
    _close_params(got.params, want.params)
    jcoll, tcoll = jmodel.param_collection(), tmodel.param_collection()
    for member in range(2):
        jp = jcoll.unconstrain({k: v[member] for k, v in want.params.items()})
        tp = tcoll.unconstrain({k: v[member : member + 1] for k, v in got.params.items()})
        np.testing.assert_allclose(
            float(tmodel.neg_log_likelihood(tp, tdata)[0]),
            float(jmodel.neg_log_likelihood(jp, jdata)), rtol=1e-4)


def test_the_multitask_sharded_train_equals_the_jax_packages_with_its_inits(meshes):
    """The SEPARABLE joint GP over two metrics (the UCB-PE designer's
    multi-task train on a mesh): 8 restarts over 8 devices, the best 2 kept,
    the JAX package's inits fed in. The chosen members' parameters within
    1e-4 of the largest, their NLL within 1e-4 relative."""
    jmesh, tmesh = meshes
    first, _ = _data(6)
    second = first.replace(labels=0.8 * first.labels + 0.02 * jnp.sin(7.0 * first.labels))
    jdata = jmt.MultiTaskData.from_gp_datas((first, second))
    tdata = interop.multitask_data_from_numpy(jdata, "cpu")
    kind = "SEPARABLE"
    jmodel = jmt.MultiTaskGaussianProcess(2, 0, 2, jmt.MultiTaskType[kind])
    tmodel = tmt.MultiTaskGaussianProcess(2, 0, 2, tmt.MultiTaskType[kind], device="cpu")
    key = jax.random.PRNGKey(3)
    inits = jmodel.param_collection().batch_random_init_unconstrained(key, 8)
    want = jparallel.train_gp_sharded(
        jmodel, jlbfgs.AdamOptimizer(maxiter=30), jdata, key, 8, 2, jmesh)
    got = tparallel.train_gp_sharded(
        tmodel, tlbfgs.AdamOptimizer(maxiter=30, device="cpu"), tdata, None, 8, 2, tmesh,
        inits=_torch_params(inits))
    assert isinstance(got, tmt.MultiTaskGPState)
    _close_params(got.params, want.params)
    jcoll, tcoll = jmodel.param_collection(), tmodel.param_collection()
    for member in range(2):
        jp = jcoll.unconstrain({k: v[member] for k, v in want.params.items()})
        tp = tcoll.unconstrain({k: v[member : member + 1] for k, v in got.params.items()})
        np.testing.assert_allclose(
            float(tmodel.neg_log_likelihood(tp, tdata)[0]),
            float(jmodel.neg_log_likelihood(jp, jdata)), rtol=1e-4)


@dataclasses.dataclass(frozen=True)
class _Recording:
    """An optimizer that keeps each call's inits and returns them, ranked."""

    seen: Any
    device: str = "cpu"

    def __call__(self, loss_fn, init_batch, *, best_n=None, groups=1):
        self.seen.append({k: v.clone() for k, v in init_batch.items()})
        with torch.no_grad():
            losses = loss_fn(init_batch)
        return tlbfgs._select_best(init_batch, losses, best_n, groups)


def test_the_warm_start_replaces_restart_zero_and_each_device_gets_a_chunk(meshes):
    """The JAX mesh path's own semantics, copied: the warm seed takes restart
    0's row (the sequential train prepends it), 8 rows over 8 devices."""
    _, tmesh = meshes
    _, tdata = _data()
    _, tmodel = _models()
    coll = tmodel.param_collection()
    inits = coll.batch_random_init_unconstrained(torch.Generator().manual_seed(1), 8)
    warm = coll.random_init_unconstrained(torch.Generator().manual_seed(2))
    seen = []
    tparallel.train_gp_sharded(tmodel, _Recording(seen), tdata, None, 8, 1, tmesh, warm,
                               inits=inits)
    assert [len(next(iter(c.values()))) for c in seen] == [1] * 8
    for k in inits:
        torch.testing.assert_close(seen[0][k][0], warm[k])
        torch.testing.assert_close(torch.cat([c[k] for c in seen[1:]]), inits[k][1:])


@pytest.mark.parametrize("optimizer", [
    tlbfgs.AdamOptimizer(maxiter=15, device="cpu"),
    tlbfgs.LbfgsOptimizer(maxiter=10, device="cpu")], ids=["adam", "lbfgs"])
def test_the_sharded_train_selects_what_one_unsharded_call_selects(meshes, optimizer):
    """Each restart is its own row: split over the devices and selected on
    devices[0], the chosen members equal one call's over all rows."""
    _, tmesh = meshes
    _, tdata = _data(1)
    _, tmodel = _models()
    inits = tmodel.param_collection().batch_random_init_unconstrained(
        torch.Generator().manual_seed(4), 8)
    sharded = tparallel.train_gp_sharded(tmodel, optimizer, tdata, None, 8, 3, tmesh,
                                         inits=inits)
    whole = optimizer(lambda p: tmodel.neg_log_likelihood(p, tdata), inits, best_n=3)
    for k, v in tmodel.param_collection().constrain(whole.params).items():
        torch.testing.assert_close(sharded.params[k], v, rtol=1e-5, atol=1e-6)


# -- the pool sweep --------------------------------------------------------------


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


class _PoolDraws(tvec.RandomVectorizedStrategy):
    """The port's random strategy; a pool's sweep takes the draws named by
    its generator's seed."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "fed", draws)

    def sweep_draws(self, generator, iterations):
        return self.fed[generator.initial_seed()]


def _fed_sweeps(key, pools, evals, pool_size, dc, sizes):
    """Both packages' random-strategy optimizers and the port's pool
    generators, pool i fed the JAX package's i-th split key's draws."""
    kw = dict(num_continuous=dc, num_categorical=len(sizes), category_sizes=sizes,
              suggestion_batch_size=pool_size)
    draws = {i: _random_sweep_draws(k, evals // pool_size, pool_size, dc, len(sizes))
             for i, k in enumerate(jax.random.split(key, pools))}
    return (jvec.VectorizedOptimizer(jvec.RandomVectorizedStrategy(**kw), max_evaluations=evals),
            tvec.VectorizedOptimizer(_PoolDraws(draws, **kw), max_evaluations=evals, device="cpu"),
            [torch.Generator().manual_seed(i) for i in range(pools)])


def test_the_pool_sweep_and_its_merge_equal_the_jax_packages(meshes):
    """8 pools over 8 devices with the JAX package's per-pool draws: the same
    candidates, the same top 3 of 8 × 3, and that top is the best over the
    pools' own results."""
    jmesh, tmesh = meshes
    center = np.array([0.2, 0.8], np.float32)
    key = jax.random.PRNGKey(9)
    jopt, topt, generators = _fed_sweeps(key, 8, 160, 16, 2, (3,))

    def jscore(f):
        return -jnp.sum((f.continuous - center) ** 2, -1) + 0.05 * (f.categorical[:, 0] == 1)

    def tscore(f):
        return -torch.sum((f.continuous - torch.tensor(center)) ** 2, -1) + 0.05 * (
            f.categorical[:, 0] == 1)

    want = jparallel.maximize_score_fn_sharded(jopt, jscore, key, 3, 8, jmesh)
    got = tparallel.maximize_score_fn_sharded(topt, tscore, generators, 3, 8, tmesh)
    np.testing.assert_array_equal(got.features.continuous.numpy(),
                                  np.asarray(want.features.continuous))
    np.testing.assert_array_equal(got.features.categorical.numpy(),
                                  np.asarray(want.features.categorical))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    pool_best = [float(topt(tscore, g, count=1).scores[0]) for g in generators]
    assert float(got.scores[0]) == max(pool_best)
    with pytest.raises(ValueError):
        tparallel.maximize_score_fn_sharded(topt, tscore, generators[:3], 3, 8, tmesh)


def test_maximize_acquisition_sharded_equals_the_jax_packages(meshes):
    """UCB with the trust region over a 2-member ensemble, the pools fed the
    JAX package's draws: the same winners, scores within 1e-5 relative."""
    jmesh, tmesh = meshes
    jdata, tdata = _data(2)
    jmodel, tmodel = _models()
    rng = np.random.default_rng(3)
    params = {"amplitude": rng.uniform(0.8, 1.5, 2).astype(np.float32),
              "noise_stddev": np.full(2, 0.1, np.float32),
              "continuous_length_scales": rng.uniform(0.3, 1.0, (2, 2)).astype(np.float32)}
    jstates = jax.vmap(lambda p: jmodel.precompute_constrained(p, jdata))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tstates = tmodel.precompute_constrained(interop.gp_params_from_numpy(params, "cpu"), tdata)
    jscoring = jacq.ScoringFunction(
        jgp.EnsemblePredictive(jstates), jacq.UCB(1.8),
        jnp.max(jnp.where(jdata.row_mask, jdata.labels, -jnp.inf)),
        jacq.TrustRegion.from_data(jdata))
    tscoring = tacq.ScoringFunction(
        tgp.EnsemblePredictive(tstates), tacq.UCB(1.8),
        tacq.get_best_labels(tdata.labels, tdata.row_mask), tacq.TrustRegion.from_data(tdata))
    key = jax.random.PRNGKey(11)
    jopt, topt, generators = _fed_sweeps(key, 8, 200, 20, 2, ())
    want = jparallel.maximize_acquisition_sharded(jopt, jscoring, key, 2, 8, jmesh)
    got = tparallel.maximize_acquisition_sharded(topt, tscoring, generators, 2, 8, tmesh)
    np.testing.assert_array_equal(got.features.continuous.numpy(),
                                  np.asarray(want.features.continuous))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)


def test_suggest_step_sharded_equals_the_jax_packages(meshes):
    """Train → UCB → one pool per device, with the JAX package's restart
    inits and pool draws: the same two suggestions."""
    jmesh, tmesh = meshes
    jdata, tdata = _data(4)
    jmodel, tmodel = _models()
    key = jax.random.PRNGKey(7)
    train_key, acq_key = jax.random.split(key)
    inits = jmodel.param_collection().batch_random_init_unconstrained(train_key, 8)
    jopt, topt, generators = _fed_sweeps(acq_key, 8, 300, 30, 2, ())
    want = jparallel.suggest_step_sharded(
        jmodel, jlbfgs.AdamOptimizer(maxiter=20), jopt, jdata, key,
        count=2, num_restarts=8, ensemble_size=2, mesh=jmesh)
    got = tparallel.suggest_step_sharded(
        tmodel, tlbfgs.AdamOptimizer(maxiter=20, device="cpu"), topt, tdata, 0,
        count=2, num_restarts=8, ensemble_size=2, mesh=tmesh,
        inits=_torch_params(inits), generators=generators)
    assert got.features.continuous.shape == (2, 2)
    np.testing.assert_array_equal(got.features.continuous.numpy(),
                                  np.asarray(want.features.continuous))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    # Its own draws: finite, in the unit box, best first.
    own = tparallel.suggest_step_sharded(
        tmodel, tlbfgs.AdamOptimizer(maxiter=5, device="cpu"),
        tvec.VectorizedOptimizer(tvec.RandomVectorizedStrategy(
            num_continuous=2, num_categorical=0, category_sizes=(), suggestion_batch_size=10),
            max_evaluations=100, device="cpu"),
        tdata, 3, count=2, num_restarts=8, ensemble_size=1, mesh=tmesh)
    assert bool(torch.all(torch.isfinite(own.scores))) and own.scores[0] >= own.scores[1]
    assert isinstance(own.features, tk.MixedFeatures)
