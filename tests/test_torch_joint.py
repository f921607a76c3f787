"""Stacked-residual transfer (the stack and the designers' ``set_priors``),
and the joint-qEI and set-PE score functions, of the port against the JAX
package's.

The score functions are the JAX package's own, reached through its sweeps
with a probe in place of the vectorized optimizer: the probe scores one
fixed pool of candidate sets and hands the scores out. Parameters, data and
candidates are made with numpy; the Monte-Carlo normals are the JAX
package's, fed to the port.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
from test_torch_surface import _close, _data, _models, _params, _query, _states
from test_torch_surface_designers import _assert_in_bounds, _kinds, _kw, _pair, _problem, _trials

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import kernels as jk
from vizier_tpu.models import stacked_residual as jstack
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.optimizers import vectorized as jvec
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.models import stacked_residual as tstack
from vizier_tpu_torch.optimizers import vectorized as tvec


# -- stacked residual ------------------------------------------------------------


class _FixedOptimizer:
    """An ARD optimizer that returns the next of a list of parameter sets
    (unconstrained numpy), so both packages train the same stack."""

    def __init__(self, params, to_tensors):
        self.params, self.to_tensors, self.calls = list(params), to_tensors, 0

    def __call__(self, loss_fn, init_batch, *, best_n=None, groups=1):
        p = self.to_tensors(self.params[self.calls])
        self.calls += 1
        return jlbfgs.OptimizeResult(p, None, None)


def test_stacked_residual_trains_the_same_stack():
    """Levels over three datasets with the same parameters in both packages:
    each level's residual labels and the stack's prediction within 1e-4."""
    datas = [_data(s, n=12 + 4 * s, n_pad=32, shift=0.2 * s) for s in range(3)]
    jmodel, tmodel = _models()
    coll = jmodel.param_collection()
    levels = [{k: np.asarray(v) for k, v in coll.random_init_unconstrained(
        jax.random.PRNGKey(10 + s)).items()} for s in range(3)]
    jopt = _FixedOptimizer(levels, lambda p: {k: jnp.asarray(v) for k, v in p.items()})
    topt = _FixedOptimizer(levels, lambda p: interop.gp_params_from_numpy(
        {k: v[None] for k, v in p.items()}, "cpu"))
    want = jstack.train_stacked_residual_gp(
        jmodel, jopt, [d for d, _ in datas], jax.random.PRNGKey(0), num_restarts=2)
    got = tstack.train_stacked_residual_gp(
        tmodel, topt, [d for _, d in datas], torch.Generator().manual_seed(0), num_restarts=2)
    for jlevel, tlevel in zip(want.levels, got.levels):
        _close(tlevel.data.labels, jlevel.data.labels, rtol=1e-4, atol=1e-5)
    jq, tq = _query(6, (9,))
    for g, w in zip(got.predict(tq), want.predict(jq)):
        _close(g, w, rtol=1e-4, atol=1e-5)


def test_a_carried_three_level_stack_predicts_the_same():
    """A stack the JAX package trained, carried level by level (parameters
    and residual data) through ``interop``, predicts within 1e-4; one level
    is the plain GP."""
    datas = [_data(s, n=10 + 3 * s, n_pad=16, shift=0.3 * s)[0] for s in range(3)]
    jmodel, tmodel = _models()
    levels = [{k: np.asarray(v) for k, v in jmodel.param_collection().random_init_unconstrained(
        jax.random.PRNGKey(20 + s)).items()} for s in range(3)]
    want = jstack.train_stacked_residual_gp(
        jmodel, _FixedOptimizer(levels, lambda p: {k: jnp.asarray(v) for k, v in p.items()}),
        datas, jax.random.PRNGKey(1), num_restarts=2)
    got = interop.stacked_residual_from_numpy(
        tmodel, [{k: np.asarray(v) for k, v in lv.params.items()} for lv in want.levels],
        [lv.data for lv in want.levels])
    jq, tq = _query(7, (11,))
    for g, w in zip(got.predict(tq), want.predict(jq)):
        _close(g, w, rtol=1e-4, atol=1e-5)
    one = tstack.StackedResidualGP(got.levels[:1])
    for g, w in zip(one.predict(tq), tgp.EnsemblePredictive(got.levels[0]).predict(tq)):
        torch.testing.assert_close(g, w)


def _priors(vz):
    return [_trials(vz, 12, seed=1, shift=0.1), _trials(vz, 12, seed=2, shift=-0.1)]


def test_transfer_priors_suggest_with_the_reference_kind():
    """One prior study under the current one in both packages (each JAX
    level trains its own program, so one prior keeps the test short); the
    port's UCB-PE takes the same branch over two priors (the JAX package's
    gp_ucb_pe.py:1263)."""
    jd, td = _pair(lambda vz, kw: jbandit.VizierGPBandit(_problem(vz), **kw),
                   lambda vz, kw: tbandit.VizierGPBandit(_problem(vz), **kw), n=6, seed=3)
    jd.set_priors(_priors(jvz)[:1])
    td.set_priors(_priors(tvz)[:1])
    jsugg, tsugg = jd.suggest(2), td.suggest(2)
    _assert_in_bounds(tsugg, 2)
    assert _kinds(tsugg) == _kinds(jsugg) == ["ucb+priors"] * 2
    assert td.ard_train_counts == jd.ard_train_counts == {"warm": 0, "cold": 1}
    assert len(td._last_predictive.levels) == 2
    ucb = tucb.VizierGPUCBPEBandit(_problem(tvz), **_kw("torch"))
    ucb.update(tvz.CompletedTrials(_trials(tvz, 6, seed=3)))
    ucb.set_priors(_priors(tvz))
    assert _kinds(ucb.suggest(1)) == ["ucb+priors"]
    assert len(ucb._last_predictive.levels) == 3


# -- joint qEI and set-PE score functions -----------------------------------------


class _Probe:
    """A vectorized optimizer that scores one fixed candidate pool and keeps
    the scores (both packages' sweeps call ``vec_opt(score_fn, rng, ...)``).
    In a jitted JAX sweep the scores leave through a host callback."""

    def __init__(self, cont, cat):
        self.cont, self.cat, self.scores = cont, cat, []

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def _keep(self, scores):
        self.scores.append(np.asarray(scores))


class _JaxProbe(_Probe):
    def __call__(self, score_fn, rng, *, count=1, prior_features=None):
        feats = jk.MixedFeatures(jnp.asarray(self.cont), jnp.asarray(self.cat))
        scores = score_fn(feats)
        jax.debug.callback(self._keep, scores)
        return jvec.VectorizedOptimizerResult(feats, scores)


class _TorchProbe(_Probe):
    def __call__(self, score_fn, rng, *, count=1, prior_features=None):
        self.prior = prior_features
        feats = tk.MixedFeatures(torch.tensor(self.cont), torch.tensor(self.cat))
        scores = score_fn(feats)
        self._keep(scores)
        return tvec.VectorizedOptimizerResult(feats, scores)


def _candidates(jdata, q, pool=12, seed=9):
    """A pool of q-point sets; set 0 repeats a data row (a rank-deficient
    joint covariance but for the jitter) and set 1 is one data row's close
    neighbourhood."""
    rng = np.random.default_rng(seed)
    dc = jdata.continuous.shape[-1]
    pts = rng.uniform(size=(pool, q, dc)).astype(np.float32)
    row = np.asarray(jdata.continuous[0])
    pts[0] = row
    pts[1] = np.clip(row + 0.01 * rng.normal(size=(q, dc)), 0, 1)
    return pts.reshape(pool, q * dc)


@pytest.mark.parametrize("tamper", [False, True], ids=["plain", "not_positive_definite"])
def test_joint_qei_scores_match(tamper):
    """The JAX package's per-candidate qEI (its ``_maximize_q_batch`` score
    function) and the port's, on the same states, draws and candidates; a
    posterior scaled to overstate k*'s reach makes covariances that do not
    factor, which score −inf on both sides."""
    q = 3
    jdata, tdata = _data(4)
    jmodel, tmodel = _models()
    # Short length scales: most random sets lie outside the data's reach.
    jstates, tstates = _states(jmodel, tmodel, jdata, tdata,
                               _params(4, 2, length_scales=(0.05, 0.08)))
    if tamper:
        jstates = jstates.replace(linv=jstates.linv * 1.5)
        tstates = dataclasses.replace(tstates, linv=tstates.linv * 1.5)
    flat = _candidates(jdata, q)
    best = jnp.max(jnp.where(jdata.row_mask, jdata.labels, -jnp.inf))
    jtrust = jacq.TrustRegion.from_data(jdata)
    key = jax.random.PRNGKey(11)
    probe = _JaxProbe(flat, np.zeros((12, 0), np.int32))
    jbandit._maximize_q_batch(probe, jstates, best, jtrust, key, q, 16, None)
    jax.effects_barrier()
    want = probe.scores[0]
    eps = torch.tensor(np.asarray(jax.random.normal(jax.random.fold_in(key, 7), (16, 2, q))))
    query = tk.MixedFeatures(torch.tensor(flat).reshape(12, q, 3),
                             torch.zeros((12, q, 0), dtype=torch.int32))
    got = tbandit.qei_joint_scores(tstates, query, eps, torch.tensor(float(best)),
                                   tacq.TrustRegion.from_data(tdata)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    _close(got[finite], want[finite], rtol=1e-4, atol=1e-5)
    if tamper:
        assert not finite.all() and finite.any()
    else:
        assert finite.all()


def test_q_batch_sweep_draws_its_normals_once_and_tiles_the_prior():
    """Two score calls of one suggest see the same draws; the prior points
    are tiled over the q slots."""
    jdata, tdata = _data(5)
    jmodel, tmodel = _models()
    _, tstates = _states(jmodel, tmodel, jdata, tdata, _params(5, 1))
    flat = _candidates(jdata, 2, pool=6)
    prior = tbandit._prior_features_from_data(tdata)

    class Twice(_TorchProbe):
        def __call__(self, score_fn, rng, *, count=1, prior_features=None):
            super().__call__(score_fn, rng, prior_features=prior_features)
            return super().__call__(score_fn, rng, prior_features=prior_features)

    probe = Twice(flat, np.zeros((6, 0), np.int32))
    tbandit._maximize_q_batch(probe, tstates, torch.tensor(1.0), None,
                              torch.Generator().manual_seed(0), 2, 16, prior)
    np.testing.assert_array_equal(probe.scores[0], probe.scores[1])
    torch.testing.assert_close(probe.prior.continuous,
                               torch.cat([prior.continuous, prior.continuous], dim=1))


@dataclasses.dataclass(frozen=True)
class _JaxOverstated(jgp.VizierGaussianProcess):
    """The JAX model, its posteriors' k* reach overstated (L⁻¹ × 1.5)."""

    def precompute_constrained(self, p, data):
        state = super().precompute_constrained(p, data)
        return state.replace(linv=state.linv * 1.5)


@dataclasses.dataclass(frozen=True)
class _TorchOverstated(tgp.VizierGaussianProcess):
    def precompute_constrained(self, p, data):
        state = super().precompute_constrained(p, data)
        return dataclasses.replace(state, linv=state.linv * 1.5)


def _corner_prior(query):
    return -3.0 * (query.continuous - 1.0) ** 2 @ (
        torch.ones(query.continuous.shape[-1]) if isinstance(query.continuous, torch.Tensor)
        else jnp.ones(query.continuous.shape[-1]))


@pytest.mark.parametrize("tamper", [False, True], ids=["plain", "not_positive_definite"])
def test_set_pe_scores_match(tamper):
    """The JAX package's set-PE score function (through its
    ``_suggest_set_pe``) and the port's, on the same completed posterior,
    all-points rows and candidate sets, with a prior and the trust region;
    an all-points posterior whose covariances do not factor scores −inf on
    both sides."""
    q, dc = 3, 3
    jdata, tdata = _data(6)
    kw = dict(num_continuous=dc, num_categorical=0)
    jmodel = (_JaxOverstated if tamper else jgp.VizierGaussianProcess)(**kw)
    tmodel = (_TorchOverstated if tamper else tgp.VizierGaussianProcess)(**kw, device="cpu")
    params = _params(6, 2, length_scales=(0.05, 0.08))
    jstates, tstates = _states(jgp.VizierGaussianProcess(**kw),
                               tgp.VizierGaussianProcess(**kw, device="cpu"), jdata, tdata, params)
    flat = _candidates(jdata, q)
    config = jucb.UCBPEConfig()
    jprobe = _JaxProbe(flat, np.zeros((12, 0), np.int32))
    jucb._suggest_set_pe(
        jmodel, jprobe, jax.tree_util.tree_map(lambda a: a[None], jstates), jdata,
        jax.random.PRNGKey(0), q, config, True, _corner_prior)
    jax.effects_barrier()
    tprobe = _TorchProbe(flat, np.zeros((12, 0), np.int32))
    result, aux = tucb._suggest_set_pe(
        tmodel, tprobe, tstates, tdata, torch.Generator().manual_seed(0), q, tucb.UCBPEConfig(),
        True, _corner_prior)
    want, got = jprobe.scores[0], tprobe.scores[0]
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    _close(got[finite], want[finite], rtol=1e-4, atol=1e-4)
    if tamper:
        assert not finite.all() and finite.any()
    else:
        assert finite.all()
    assert result.features.continuous.shape == (q, dc) and aux["mean"].shape == (q, 1)
