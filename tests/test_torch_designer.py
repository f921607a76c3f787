"""The DEFAULT designer, end to end: the JAX package's and the port's
``VizierGPUCBPEBandit`` on the same study.

A 3-D mixed space (two floats, one categorical) with 16 completed trials,
``ard_restarts=2``, 2000 acquisition evaluations and ``count=3``. The two
packages draw different random numbers, so the designers are compared where
the comparison is deterministic: the encoded data, the posterior under the
JAX designer's trained parameters, and the best first-pick acquisition value
under that posterior.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.models import kernels as jk
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.parallel import batch_executor as tbatch

_CATS = ["red", "green", "blue"]
# The first pick is UCB in both packages (no random PE override), so the
# acquisition values compare like with like.
_KW = dict(ard_restarts=2, max_acquisition_evaluations=2000, warm_start_min_trials=10)


def _problem(vz):
    p = vz.ProblemStatement()
    p.search_space.root.add_float_param("x", 0.0, 1.0)
    p.search_space.root.add_float_param("y", -2.0, 3.0)
    p.search_space.root.add_categorical_param("c", _CATS)
    p.metric_information.append(vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    return p


def _trials(vz, n=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x, y, c = float(rng.uniform()), float(rng.uniform(-2, 3)), _CATS[int(rng.integers(3))]
        t = vz.Trial(id=i + 1, parameters={"x": x, "y": y, "c": c})
        value = (x - 0.3) ** 2 + 0.1 * (y - 1.0) ** 2 + (0.0 if c == "green" else 0.5)
        t.complete(vz.Measurement(metrics={"obj": value}))
        out.append(t)
    return out


def _assert_valid(suggestions, count):
    assert len(suggestions) == count
    for s in suggestions:
        p = s.parameters
        assert 0.0 <= p.get_value("x") <= 1.0 and -2.0 <= p.get_value("y") <= 3.0
        assert p.get_value("c") in _CATS


@pytest.fixture(scope="module")
def designers():
    jd = jucb.VizierGPUCBPEBandit(
        _problem(jvz), config=jucb.UCBPEConfig(pe_overwrite_probability=0.0), use_mesh=False, **_KW
    )
    td = tucb.VizierGPUCBPEBandit(
        _problem(tvz), config=tucb.UCBPEConfig(pe_overwrite_probability=0.0), device="cpu", **_KW
    )
    jd.update(jvz.CompletedTrials(_trials(jvz)), jvz.ActiveTrials())
    td.update(tvz.CompletedTrials(_trials(tvz)), tvz.ActiveTrials())
    return jd, td, jd.suggest(3), td.suggest(3)


def test_both_designers_make_valid_suggestions(designers):
    _, td, jsugg, tsugg = designers
    _assert_valid(jsugg, 3)
    _assert_valid(tsugg, 3)
    ns = tsugg[0].metadata.ns("gp_ucb_pe")
    assert ns["use_ucb"] == "True" and np.isfinite(ns["acquisition"])
    states, _ = td._cached_states
    assert len(states) == 1 and bool(torch.isfinite(states[0].chol).all())


def _port_state_from_jax(jd, td):
    """The port's posterior under the JAX designer's trained parameters."""
    jstates, jdatas = jd._cached_states
    params = interop.gp_params_from_numpy(
        {k: np.asarray(v)[0] for k, v in jstates.params.items()}, "cpu"
    )
    _, (tdata,) = td._train_states_me()
    for field in ("continuous", "categorical", "labels", "row_mask"):
        np.testing.assert_allclose(
            getattr(tdata, field).numpy(), np.asarray(getattr(jdatas[0], field)), atol=1e-6
        )
    return td._model.precompute_constrained(params, tdata)


def test_predict_matches_under_the_jax_trained_params(designers):
    jd, td, _, _ = designers
    tstate = _port_state_from_jax(jd, td)
    rng = np.random.default_rng(1)
    q = rng.uniform(size=(25, 2)).astype(np.float32)
    zq = rng.integers(0, 3, size=(25, 1)).astype(np.int32)
    jmean, jstd = jd._last_predictive.predict(jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq)))
    tmean, tstd = tgp.EnsemblePredictive(tstate).predict(
        tk.MixedFeatures(torch.tensor(q), torch.tensor(zq))
    )
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), atol=1e-4)


def test_first_pick_acquisition_within_two_percent(designers):
    jd, td, _, _ = designers
    jstates, jdatas = jd._cached_states
    j_all = jd._all_points_data(1)
    labels_mn = jnp.stack([d.labels for d in jdatas])
    jresult, _ = jucb._suggest_batch(
        jd._model, jd._vec_opt, jstates, j_all, labels_mn, jdatas[0].row_mask,
        jnp.zeros(1), jd._prior_features(jdatas[0]), jax.random.PRNGKey(7),
        jnp.asarray(True), jnp.asarray(True), 1, jd.config, True, None, None,
    )
    # The port's single-objective picks run over a study axis (one here).
    tstate = _port_state_from_jax(jd, td)
    one = lambda tree: tbatch.stack_pytrees([tree])  # noqa: E731
    tstates = dataclasses.replace(tstate, data=one(tstate.data))
    tresult, aux = tucb._suggest_batch_studies(
        td._vec_opt, tstates, one(td._all_points_data(1)),
        tbandit._prior_features_from_data(tstates.data), [torch.Generator().manual_seed(7)],
        torch.tensor([True]), torch.tensor([True]), 1, td.config,
    )
    assert bool(aux["use_ucb"][0, 0])
    want, got = float(jresult.scores[0]), float(tresult.scores[0, 0])
    assert abs(got - want) <= 0.02 * abs(want), (got, want)


def test_seed_suggestions_match_the_jax_designer():
    jd = jucb.VizierGPUCBPEBandit(_problem(jvz), use_mesh=False, rng_seed=3)
    td = tucb.VizierGPUCBPEBandit(_problem(tvz), device="cpu", rng_seed=3)
    jsugg, tsugg = jd.suggest(3), td.suggest(3)
    _assert_valid(tsugg, 3)
    assert [s.parameters.as_dict() for s in tsugg] == [s.parameters.as_dict() for s in jsugg]


def test_warm_start_round_trip(designers):
    _, td, _, _ = designers
    warm = td.warm_start_state()
    assert warm is not None and len(warm) == 1
    fresh = tucb.VizierGPUCBPEBandit(_problem(tvz), device="cpu", **_KW)
    assert fresh.warm_start_state() is None
    fresh.set_warm_start_state(warm)
    for k, v in fresh.warm_start_state()[0].items():
        torch.testing.assert_close(v, warm[0][k])
    with pytest.raises(ValueError):
        fresh.set_warm_start_state(warm * 2)


def test_warm_start_row_is_prepended_not_replacing_a_restart():
    """ROADMAP C3: the warm seed is one more restart row, ahead of the random ones."""
    model = tgp.VizierGaussianProcess(num_continuous=2, num_categorical=0, device="cpu")
    seen = {}

    class Spy:
        def __call__(self, loss_fn, init_batch, *, best_n=None):
            seen.update(init_batch)
            from vizier_tpu_torch.optimizers import lbfgs

            return lbfgs._select_best(init_batch, loss_fn(init_batch), best_n)

    warm = {k: v + 0.5 for k, v in model.param_collection().random_init_unconstrained(
        torch.Generator().manual_seed(1)).items()}
    rng = np.random.default_rng(0)
    data = tgp.GPData(
        continuous=torch.tensor(rng.uniform(size=(8, 2)), dtype=torch.float32),
        categorical=torch.zeros((8, 0), dtype=torch.int32),
        labels=torch.tensor(rng.normal(size=8), dtype=torch.float32),
        row_mask=torch.ones(8, dtype=torch.bool),
        cont_dim_mask=torch.ones(2, dtype=torch.bool),
        cat_dim_mask=torch.ones(0, dtype=torch.bool),
    )
    tbandit._train_gp(model, Spy(), data, torch.Generator().manual_seed(0), 3, 1, warm)
    for k, v in seen.items():
        assert v.shape[0] == 4
        torch.testing.assert_close(v[0], warm[k])


@pytest.mark.parametrize(
    "policy,budgets", [("first_pick_full", [2000, 1000]), ("per_batch", [666]), ("per_pick", [2000])]
)
def test_acquisition_budget_policies(policy, budgets):
    td = tucb.VizierGPUCBPEBandit(
        _problem(tvz), device="cpu", acquisition_budget_policy=policy, **_KW
    )
    got = [td._pick_vec_opt(3).max_evaluations]
    if policy == "first_pick_full":
        got.insert(0, td._vec_opt.max_evaluations)
    assert got == budgets


@pytest.mark.parametrize("acquisition", ["ucb", "ei", "pe"])
def test_gp_bandit_suggests_in_bounds(acquisition):
    td = tbandit.VizierGPBandit(
        _problem(tvz), acquisition=acquisition, device="cpu", ard_restarts=2,
        max_acquisition_evaluations=500,
    )
    td.update(tvz.CompletedTrials(_trials(tvz, n=10)))
    suggestions = td.suggest(2)
    _assert_valid(suggestions, 2)
    ns = suggestions[0].metadata.ns("gp_bandit")
    assert ns["acquisition_kind"] == acquisition and np.isfinite(ns["acquisition"])
