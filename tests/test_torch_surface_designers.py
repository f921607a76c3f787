"""The GP designers' single-objective surface, the port's against the JAX
package's: ``acquisition="pi"`` and ``"qei"`` (joint at count > 1), transfer
priors, UCB-PE's set acquisition and ``prior_acquisition``, the injected ARD
optimizer, the routing predicates, and the Predictor (``predict`` /
``sample``). The transfer designers are in ``test_torch_joint.py``.

A 4-D float study of 16 trials, ``AdamOptimizer(maxiter=10)`` on both sides.
The two packages draw different random numbers, so suggestions are compared
by their kinds and shapes; the Predictor's unwarp and decode are compared on
the same warped samples (the JAX designer's posterior and draws).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.surrogates import config as jsur
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.surrogates import config as tsur

_DIM = 4


def _problem(vz, goal="MAXIMIZE", metrics=("obj",), categorical=False):
    p = vz.ProblemStatement()
    for j in range(_DIM):
        p.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    if categorical:
        p.search_space.root.add_categorical_param("c", ["a", "b"])
    for name in metrics:
        p.metric_information.append(vz.MetricInformation(
            name=name, goal=getattr(vz.ObjectiveMetricGoal, goal)))
    return p


def _trials(vz, n=16, seed=0, shift=0.0, metrics=("obj",), start=1, categorical=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(size=_DIM)
        params = {f"x{j}": float(x[j]) for j in range(_DIM)}
        if categorical:
            params["c"] = "a" if i % 2 else "b"
        t = vz.Trial(id=start + i, parameters=params)
        value = 100.0 + 10.0 * float(np.sum((x - 0.4 - shift) ** 2))
        t.complete(vz.Measurement(metrics={m: value * (k + 1) for k, m in enumerate(metrics)}))
        out.append(t)
    return out


def _kw(pkg):
    if pkg == "jax":
        return dict(use_mesh=False, ard_restarts=2, max_acquisition_evaluations=400,
                    ard_optimizer=jlbfgs.AdamOptimizer(maxiter=10))
    return dict(device="cpu", ard_restarts=2, max_acquisition_evaluations=400,
                ard_optimizer=tlbfgs.AdamOptimizer(maxiter=10, device="cpu"))


def _pair(make_j, make_t, n=16, **trial_kw):
    """The JAX designer and the port's, each updated with the same trials."""
    jd, td = make_j(jvz, _kw("jax")), make_t(tvz, _kw("torch"))
    jd.update(jvz.CompletedTrials(_trials(jvz, n, **trial_kw)))
    td.update(tvz.CompletedTrials(_trials(tvz, n, **trial_kw)))
    return jd, td


def _kinds(suggestions, ns="gp_bandit"):
    return [s.metadata.ns(ns)["acquisition_kind"] for s in suggestions]


def _assert_in_bounds(suggestions, count):
    assert len(suggestions) == count
    for s in suggestions:
        values = [s.parameters.get_value(f"x{j}") for j in range(_DIM)]
        assert all(0.0 <= v <= 1.0 for v in values), values


@pytest.mark.parametrize("acquisition,count,kind", [
    ("pi", 2, "pi"), ("qei", 1, "qei"), ("qei", 3, "qei_joint")])
def test_pi_and_qei_are_accepted_with_the_reference_kinds(acquisition, count, kind):
    jd, td = _pair(lambda vz, kw: jbandit.VizierGPBandit(_problem(vz), acquisition=acquisition, **kw),
                   lambda vz, kw: tbandit.VizierGPBandit(_problem(vz), acquisition=acquisition, **kw))
    jsugg, tsugg = jd.suggest(count), td.suggest(count)
    _assert_in_bounds(tsugg, count)
    assert _kinds(tsugg) == _kinds(jsugg) == [kind] * count
    values = {s.metadata.ns("gp_bandit")["acquisition"] for s in tsugg}
    if kind == "qei_joint":  # one batch, one score
        assert len(values) == 1
    assert all(np.isfinite(v) for v in values)
    assert td.ard_train_counts == jd.ard_train_counts


def test_qei_batches_refuse_categorical_spaces():
    for vz, make, kw in ((jvz, jbandit.VizierGPBandit, _kw("jax")),
                         (tvz, tbandit.VizierGPBandit, _kw("torch"))):
        d = make(_problem(vz, categorical=True), acquisition="qei", **kw)
        d.update(vz.CompletedTrials(_trials(vz, 8, categorical=True)))
        with pytest.raises(ValueError, match="continuous"):
            d.suggest(2)


def test_a_qei_batch_stays_exact_past_the_sparse_threshold():
    """The sparse posterior has no joint covariance: the auto-switch flips
    the study sparse, and the q-batch still trains and searches exact."""
    cfg = dict(sparse_threshold_trials=8, hysteresis_trials=0, num_inducing=8)
    jd, td = _pair(
        lambda vz, kw: jbandit.VizierGPBandit(
            _problem(vz), acquisition="qei", surrogate=jsur.SurrogateConfig(**cfg), **kw),
        lambda vz, kw: tbandit.VizierGPBandit(
            _problem(vz), acquisition="qei", surrogate=tsur.SurrogateConfig(**cfg), **kw))
    jsugg, tsugg = jd.suggest(2), td.suggest(2)
    assert _kinds(tsugg) == _kinds(jsugg) == ["qei_joint"] * 2
    assert td.surrogate_mode == jd.surrogate_mode == "sparse"
    assert td.surrogate_counts == jd.surrogate_counts == {"sparse_suggests": 0, "crossovers": 1}


def _cases():
    """(name, designer kwargs, priors?, count) of the routing cases."""
    return [
        ("plain", {}, False, 1),
        ("batch", {}, False, 3),
        ("pi", dict(acquisition="pi"), False, 2),
        ("qei one", dict(acquisition="qei"), False, 1),
        ("qei batch", dict(acquisition="qei"), False, 3),
        ("priors", {}, True, 1),
    ]


@pytest.mark.parametrize("name,kwargs,priors,count", _cases(), ids=[c[0] for c in _cases()])
def test_the_bandit_routes_as_the_reference(name, kwargs, priors, count):
    jd, td = _pair(lambda vz, kw: jbandit.VizierGPBandit(_problem(vz), **kwargs, **kw),
                   lambda vz, kw: tbandit.VizierGPBandit(_problem(vz), **kwargs, **kw))
    if priors:
        jd.set_priors([_trials(jvz, 4)])
        td.set_priors([_trials(tvz, 4)])
    assert tbandit._gp_bandit_unbatchable(td, count) == jbandit._gp_bandit_unbatchable(jd, count)


def _ucb_cases():
    corner_j = lambda q: -(q.continuous - 1.0).sum(-1)  # noqa: E731
    corner_t = lambda q: -(q.continuous - 1.0).sum(-1)  # noqa: E731
    set_cfg = dict(optimize_set_acquisition_for_exploration=True)
    return [
        ("plain", {}, {}, False),
        ("set acquisition", dict(config=jucb.UCBPEConfig(**set_cfg)),
         dict(config=tucb.UCBPEConfig(**set_cfg)), False),
        ("prior_acquisition", dict(prior_acquisition=corner_j),
         dict(prior_acquisition=corner_t), False),
        ("priors", {}, {}, True),
    ]


@pytest.mark.parametrize("name,jkwargs,tkwargs,priors", _ucb_cases(),
                         ids=[c[0] for c in _ucb_cases()])
def test_ucb_pe_routes_as_the_reference(name, jkwargs, tkwargs, priors):
    """Batchable or not, and eligible for the sparse surrogate or not, equal
    to the reference's for each path."""
    sur = dict(sparse_threshold_trials=8)
    jd, td = _pair(
        lambda vz, kw: jucb.VizierGPUCBPEBandit(
            _problem(vz), surrogate=jsur.SurrogateConfig(**sur), **jkwargs, **kw),
        lambda vz, kw: tucb.VizierGPUCBPEBandit(
            _problem(vz), surrogate=tsur.SurrogateConfig(**sur), **tkwargs, **kw))
    if priors:
        jd.set_priors([_trials(jvz, 4)])
        td.set_priors([_trials(tvz, 4)])
    for count in (1, 3):
        assert tucb._ucb_pe_unbatchable(td, count) == jucb._ucb_pe_unbatchable(jd, count)
    assert td._sparse_ucb_pe_eligible() == jd._sparse_ucb_pe_eligible() == (name == "plain")


def test_designers_with_different_optimizers_or_acquisitions_never_share_a_bucket():
    def key(**kw):
        d = tbandit.VizierGPBandit(_problem(tvz), device="cpu", **kw)
        d.update(tvz.CompletedTrials(_trials(tvz, 8)))
        return tbandit.GPBanditProgram().bucket_key(d, 1)

    adam = tlbfgs.AdamOptimizer(maxiter=10, device="cpu")
    assert key(ard_optimizer=adam) == key(ard_optimizer=tlbfgs.AdamOptimizer(maxiter=10,
                                                                              device="cpu"))
    assert key(ard_optimizer=adam) != key()
    assert key(acquisition="pi") != key(acquisition="ei")


def test_set_acquisition_refuses_several_objectives():
    cfg = dict(optimize_set_acquisition_for_exploration=True)
    metrics = ("f1", "f2")
    jd, td = _pair(
        lambda vz, kw: jucb.VizierGPUCBPEBandit(
            _problem(vz, metrics=metrics), config=jucb.UCBPEConfig(**cfg), **kw),
        lambda vz, kw: tucb.VizierGPUCBPEBandit(
            _problem(vz, metrics=metrics), config=tucb.UCBPEConfig(**cfg), **kw),
        n=8, metrics=metrics)
    for d in (jd, td):
        with pytest.raises(ValueError, match="one objective"):
            d.suggest(2)


def test_set_acquisition_suggests_one_pick_then_one_set():
    """Fresh data: one UCB pick, then the exploration set, whose picks share
    the set's value and are not UCB picks, on both sides."""
    cfg = dict(optimize_set_acquisition_for_exploration=True, pe_overwrite_probability=0.0)
    jd, td = _pair(
        lambda vz, kw: jucb.VizierGPUCBPEBandit(_problem(vz), config=jucb.UCBPEConfig(**cfg), **kw),
        lambda vz, kw: tucb.VizierGPUCBPEBandit(_problem(vz), config=tucb.UCBPEConfig(**cfg), **kw))
    for d in (jd, td):
        suggestions = d.suggest(4)
        _assert_in_bounds(suggestions, 4)
        ns = [s.metadata.ns("gp_ucb_pe") for s in suggestions]
        assert [n["use_ucb"] for n in ns] == ["True", "False", "False", "False"]
        assert len({n["acquisition"] for n in ns[1:]}) == 1


def test_prior_acquisition_steers_every_pick():
    """The corner prior of the JAX package's test, on the port: greedy picks,
    the set's picks and a two-objective study's picks hug the (1, 1, 1, 1)
    corner."""
    prior = lambda q: -1e4 * torch.sum((q.continuous - 1.0) ** 2, dim=-1)  # noqa: E731
    set_pe = tucb.UCBPEConfig(optimize_set_acquisition_for_exploration=True)
    for config, metrics in ((tucb.UCBPEConfig(), ("obj",)), (set_pe, ("obj",)),
                            (tucb.UCBPEConfig(), ("f1", "f2"))):
        td = tucb.VizierGPUCBPEBandit(_problem(tvz, metrics=metrics), config=config,
                                      prior_acquisition=prior,
                                      **dict(_kw("torch"), max_acquisition_evaluations=4000))
        td.update(tvz.CompletedTrials(_trials(tvz, 8, metrics=metrics)))
        for s in td.suggest(3):
            assert all(s.parameters.get_value(f"x{j}") > 0.8 for j in range(_DIM))


def _unwarped_samples_match(jd, td, suggestions, eps_shape):
    key = jax.random.PRNGKey(3)
    want = jd.sample(suggestions, rng=key, num_samples=eps_shape[0])
    eps = torch.tensor(np.asarray(jax.random.normal(key, eps_shape)))
    got = td._samples_from_draws(suggestions, eps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bandit_predict_unwarps_and_decodes_as_the_reference():
    """MINIMIZE labels near 100: the same warped samples (the JAX posterior
    and draws) come back to the metric's scale and sign equally."""
    jd, td = _pair(lambda vz, kw: jbandit.VizierGPBandit(_problem(vz, "MINIMIZE"), **kw),
                   lambda vz, kw: tbandit.VizierGPBandit(_problem(vz, "MINIMIZE"), **kw))
    suggestions = jd.suggest(2)
    td.suggest(1)
    params = {k: np.asarray(v) for k, v in jd._last_predictive.states.params.items()}
    tdata = tgp.GPData.from_model_data(td._warped_model_data(), td.device)
    td._last_predictive = tgp.EnsemblePredictive(td._model.precompute_constrained(
        interop.gp_params_from_numpy(params, "cpu"), tdata))
    _unwarped_samples_match(jd, td, suggestions, (64, 2))
    prediction = td.predict(suggestions)
    assert prediction.mean.shape == (2,) and np.all(prediction.mean > 50.0)


def test_ucb_pe_predict_unwarps_and_decodes_as_the_reference():
    jd, td = _pair(lambda vz, kw: jucb.VizierGPUCBPEBandit(_problem(vz, "MINIMIZE"), **kw),
                   lambda vz, kw: tucb.VizierGPUCBPEBandit(_problem(vz, "MINIMIZE"), **kw))
    suggestions = jd.suggest(2)
    td.suggest(1)
    jstates, _ = jd._cached_states
    params = {k: np.asarray(v)[0] for k, v in jstates.params.items()}
    (_,), (tdata,) = td._cached_states
    td._cached_states = ([td._model.precompute_constrained(
        interop.gp_params_from_numpy(params, "cpu"), tdata)], [tdata])
    _unwarped_samples_match(jd, td, suggestions, (64, 1, 2))


@pytest.mark.parametrize("designer", ["bandit", "ucb_pe"])
def test_predict_after_suggest_does_not_retrain(designer):
    make = tbandit.VizierGPBandit if designer == "bandit" else tucb.VizierGPUCBPEBandit
    td = make(_problem(tvz), **_kw("torch"))
    td.update(tvz.CompletedTrials(_trials(tvz, 8)))
    suggestions = td.suggest(2)
    counts = td.ard_train_counts
    fit = td._last_predictive if designer == "bandit" else td._cached_states[0]
    prediction = td.predict(suggestions, rng=np.random.default_rng(0), num_samples=32)
    assert prediction.mean.shape == prediction.stddev.shape == (2,)
    assert td.ard_train_counts == counts
    assert (td._last_predictive if designer == "bandit" else td._cached_states[0]) is fit
    td.update(tvz.CompletedTrials(_trials(tvz, 1, seed=9, start=50)))
    if designer == "ucb_pe":
        assert td._cached_states is None


def test_predict_without_a_suggest_trains_once():
    td = tbandit.VizierGPBandit(_problem(tvz), **_kw("torch"))
    with pytest.raises(ValueError, match="Not enough"):
        td._require_predictive()
    td.update(tvz.CompletedTrials(_trials(tvz, 6)))
    suggestions = [tvz.TrialSuggestion(parameters={f"x{j}": 0.5 for j in range(_DIM)})]
    first = td.sample(suggestions, num_samples=8)
    assert first.shape == (8, 1) and np.all(np.isfinite(first))
    fit = td._last_predictive
    td.sample(suggestions, num_samples=8)
    assert td._last_predictive is fit


def test_ucb_pe_samples_stay_warped_before_any_label():
    for vz, make, kw in ((jvz, jucb.VizierGPUCBPEBandit, _kw("jax")),
                         (tvz, tucb.VizierGPUCBPEBandit, _kw("torch"))):
        d = make(_problem(vz), num_seed_trials=2, **kw)
        active = [vz.Trial(id=i, parameters={f"x{j}": 0.3 * i for j in range(_DIM)})
                  for i in (1, 2)]
        d.update(vz.CompletedTrials([]), vz.ActiveTrials(active))
        suggestions = d.suggest(1)
        rng = jax.random.PRNGKey(0) if vz is jvz else None
        samples = d.sample(suggestions, rng=rng, num_samples=8)
        assert samples.shape == (8, 1) and np.all(np.isfinite(samples))
        assert not d._warpers_fitted
