"""The algorithm layer's last modules of the port against the JAX package's.

L-BFGS-B acquisition maximization (the JAX package's restart draws fed to
the port) and ``DesignerAsOptimizer``; the phase timers of ``utils/profiler``
and the designers' timer names; curve early stopping (the median and
regression rules, the boosted final-objective regressor, the feasibility
classifier, the power-law curve regressor); the ensemble and meta-learning
designers; and the small host modules (embedder, spatio-temporal
converters, singleton parameters, context, parameter iterators,
validators, the optimizer and policy-factory protocols). Inputs are made
with numpy from a seed; every case is small (4-D, at most 50 trials, 4
restarts of 10 iterations).
"""

from __future__ import annotations

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu import types as jtypes
from vizier_tpu.algorithms import classification as jcls
from vizier_tpu.algorithms import early_stopping as jes
from vizier_tpu.algorithms import regression as jreg
from vizier_tpu.converters import embedder as jemb
from vizier_tpu.converters import spatio_temporal as jst
from vizier_tpu.designers import eagle_meta_learning as jeml
from vizier_tpu.designers import eagle_strategy as jeagle
from vizier_tpu.designers import ensemble as jens
from vizier_tpu.designers import gp_bandit as jgb
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers import meta_learning as jml
from vizier_tpu.designers import random as jrandom
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import kernels as jk
from vizier_tpu.optimizers import base as jbase
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.optimizers import lbfgsb_optimizer as jlbfgsb
from vizier_tpu.pythia import local_policy_supporters as jlps
from vizier_tpu.pythia import policy_factory as jpf
from vizier_tpu.pythia import singleton_params as jsp
from vizier_tpu.pyvizier import context as jctx
from vizier_tpu.pyvizier import parameter_iterators as jpi
from vizier_tpu.pyvizier import study_config as jsc
from vizier_tpu.service import policy_factory as jservice_pf
from vizier_tpu.utils import profiler as jprof
from vizier_tpu.utils import validators as jval
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import classification as tcls
from vizier_tpu_torch.algorithms import early_stopping as tes
from vizier_tpu_torch.algorithms import regression as treg
from vizier_tpu_torch.converters import embedder as temb
from vizier_tpu_torch.converters import spatio_temporal as tst
from vizier_tpu_torch.designers import eagle_meta_learning as teml
from vizier_tpu_torch.designers import eagle_strategy as teagle
from vizier_tpu_torch.designers import ensemble as tens
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.designers import meta_learning as tml
from vizier_tpu_torch.designers import random as trandom
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.optimizers import base as tbase
from vizier_tpu_torch.optimizers import lbfgsb_optimizer as tlbfgsb
from vizier_tpu_torch.pythia import local_policy_supporters as tlps
from vizier_tpu_torch.pythia import policy_factory as tpf
from vizier_tpu_torch.pythia import singleton_params as tsp
from vizier_tpu_torch.pyvizier import context as tctx
from vizier_tpu_torch.pyvizier import parameter_iterators as tpi
from vizier_tpu_torch.pyvizier import study_config as tsc
from vizier_tpu_torch.service import policy_factory as tservice_pf
from vizier_tpu_torch.utils import profiler as tprof
from vizier_tpu_torch.utils import validators as tval

_DIM = 4


def _jax_z0(key, restarts: int, dim: int) -> np.ndarray:
    """The JAX package's L-BFGS-B starting points: 2·N(0, 1) per split key."""
    keys = jax.random.split(key, restarts)
    return np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (dim,), dtype=jnp.float32) * 2.0)(keys))


def _values(s, names):
    return [s.parameters.get_value(n) for n in names]


# -- L-BFGS-B ------------------------------------------------------------------


def _quadratic(f):
    return -(f.continuous - 0.7) ** 2


# Both packages run float32 L-BFGS-B with Armijo backtracking. Through two
# iterations every restart follows the same path (points within 1e-5); past
# that, a line search accepting or halving on a last-bit difference in the
# loss sends a restart down another path, so after ten iterations only the
# best score is held (quadratic: within 1e-3 absolute of the JAX package's;
# the GP's UCB, ~3: within 1e-2 relative) and every point must lie in (0, 1).
_LBFGSB_CASES = [(2, True), (10, False)]


@pytest.mark.parametrize("maxiter,same_path", _LBFGSB_CASES)
def test_lbfgsb_on_a_quadratic_matches_the_jax_package(maxiter, same_path):
    """test_aux.py's quadratic (target 0.7 in 3-D) over 4 restarts from the
    JAX package's draws."""
    key = jax.random.PRNGKey(0)
    want = jlbfgsb.LBFGSBOptimizer(num_restarts=4, maxiter=maxiter)(
        lambda f: jnp.sum(_quadratic(f), axis=-1), key, num_continuous=3, count=4)
    got = tlbfgsb.LBFGSBOptimizer(num_restarts=4, maxiter=maxiter, device="cpu")(
        lambda f: torch.sum(_quadratic(f), dim=-1), num_continuous=3, count=4,
        z0=torch.tensor(_jax_z0(key, 4, 3)))
    x = got.features.continuous.numpy()
    assert got.features.categorical.shape == (4, 0) and np.all((x > 0) & (x < 1))
    if same_path:
        np.testing.assert_allclose(x, np.asarray(want.features.continuous), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(float(got.scores[0]), float(want.scores[0]), rtol=0, atol=1e-3)


def _gp_pair(seed=0, n=50, n_pad=64):
    """A JAX GP trained on n rows of a smooth 4-D objective (2 restarts),
    and the port's posterior at its parameters; both packages' UCB scoring
    with the trust region."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, _DIM)).astype(np.float32)
    y = (np.sin(3 * x).sum(-1) + 0.1 * rng.normal(size=n)).astype(np.float32)
    md = jtypes.ModelData(
        jtypes.ContinuousAndCategorical(
            continuous=jtypes.PaddedArray.from_array(x, (n_pad, _DIM)),
            categorical=jtypes.PaddedArray.from_array(
                np.zeros((n, 0), np.int32), (n_pad, 0), fill_value=0),
        ),
        jtypes.PaddedArray.from_array(y[:, None], (n_pad, 1), fill_value=np.nan),
    )
    jdata = jgp.GPData.from_model_data(md)
    jmodel = jgp.VizierGaussianProcess(num_continuous=_DIM, num_categorical=0)
    jstates = jgb._train_gp(jmodel, jlbfgs.LbfgsOptimizer(), jdata, jax.random.PRNGKey(seed), 2, 1)
    tdata = interop.gp_data_from_numpy(jdata, "cpu")
    tmodel = tgp.VizierGaussianProcess(num_continuous=_DIM, num_categorical=0, device="cpu")
    tstates = tmodel.precompute_constrained(
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in jstates.params.items()},
                                     "cpu"), tdata)
    jscore = jacq.ScoringFunction(
        predictive=jgp.EnsemblePredictive(jstates), acquisition=jacq.UCB(1.8),
        best_label=jacq.get_best_labels(jdata.labels, jdata.row_mask),
        trust_region=jacq.TrustRegion.from_data(jdata))
    tscore = tacq.ScoringFunction(
        predictive=tgp.EnsemblePredictive(tstates), acquisition=tacq.UCB(1.8),
        best_label=tacq.get_best_labels(tdata.labels, tdata.row_mask),
        trust_region=tacq.TrustRegion.from_data(tdata))
    return jscore, tscore


@pytest.fixture(scope="module")
def gp_pair():
    return _gp_pair()


@pytest.mark.parametrize("maxiter,same_path", _LBFGSB_CASES)
def test_lbfgsb_on_a_trained_gp_ucb_matches_the_jax_package(gp_pair, maxiter, same_path):
    """The UCB with its trust region over 4 restarts from the JAX draws (the
    GP's predictions agree to ~1e-6, scores ~3)."""
    jscore, tscore = gp_pair
    key = jax.random.PRNGKey(3)
    want = jlbfgsb.LBFGSBOptimizer(num_restarts=4, maxiter=maxiter)(
        jscore.score, key, num_continuous=_DIM, count=4)
    got = tlbfgsb.LBFGSBOptimizer(num_restarts=4, maxiter=maxiter, device="cpu")(
        tscore.score, num_continuous=_DIM, count=4, z0=torch.tensor(_jax_z0(key, 4, _DIM)))
    x = got.features.continuous.numpy()
    assert np.all((x > 0) & (x < 1))
    if same_path:
        np.testing.assert_allclose(x, np.asarray(want.features.continuous), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)
    else:
        np.testing.assert_allclose(float(got.scores[0]), float(want.scores[0]), rtol=1e-2)


def test_lbfgsb_loss_gradient_matches_jax_grad(gp_pair):
    """The loss's gradient with respect to the unconstrained queries, through
    the port's plain kernel, within 1e-5 of ``jax.grad`` of the JAX score
    (relative to the largest entry)."""
    jscore, tscore = gp_pair
    z = _jax_z0(jax.random.PRNGKey(5), 6, _DIM)

    def jloss(zz):
        feats = jk.MixedFeatures(jax.nn.sigmoid(zz), jnp.zeros((zz.shape[0], 0), jnp.int32))
        return -jnp.sum(jscore.score(feats))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    zt = torch.tensor(z).requires_grad_(True)
    loss = tlbfgsb.LBFGSBOptimizer(device="cpu").loss_fn(tscore.score)(zt)
    (got,) = torch.autograd.grad(loss.sum(), zt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_lbfgsb_draws_its_own_starts_when_none_are_given():
    opt = tlbfgsb.LBFGSBOptimizer(num_restarts=3, maxiter=5, device="cpu")
    gen = torch.Generator().manual_seed(0)
    z0 = opt.restart_draws(gen, 2)
    assert z0.shape == (3, 2)
    result = opt(lambda f: -torch.sum((f.continuous - 0.3) ** 2, -1),
                 torch.Generator().manual_seed(0), num_continuous=2, count=3)
    assert torch.all(result.scores[:-1] >= result.scores[1:])


def _line_problem(vz, metrics=("acquisition",)):
    problem = vz.ProblemStatement()
    problem.search_space.root.add_float_param("x", 0.0, 1.0)
    problem.search_space.root.add_categorical_param("c", ["a", "b"])
    for m in metrics:
        problem.metric_information.append(
            vz.MetricInformation(name=m, goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return problem


@pytest.mark.parametrize("kind", ["sequence", "dict_two_metrics"])
def test_designer_as_optimizer_with_random_matches_the_jax_package(kind):
    """The Random designer's mini-study: the same suggestions and the same
    ranking (single metric: by score; two metrics: by Pareto rank)."""
    metrics = ("acquisition",) if kind == "sequence" else ("f1", "f2")

    def score(suggestions):
        xs = np.asarray([s.parameters.get_value("x") for s in suggestions])
        bonus = np.asarray([0.1 if s.parameters.get_value("c") == "b" else 0.0
                            for s in suggestions])
        if kind == "sequence":
            return list(-(xs - 0.4) ** 2 + bonus)
        return {"f1": -(xs - 0.4) ** 2 + bonus, "f2": (xs - 0.2)[:, None] ** 2}

    want = jlbfgsb.DesignerAsOptimizer(
        lambda p: jrandom.RandomDesigner(p.search_space, seed=1), num_rounds=4, batch_size=6,
    ).optimize(score, _line_problem(jvz, metrics), count=5)
    got = tlbfgsb.DesignerAsOptimizer(
        lambda p: trandom.RandomDesigner(p.search_space, seed=1), num_rounds=4, batch_size=6,
        device="cpu",
    ).optimize(score, _line_problem(tvz, metrics), count=5)
    assert [_values(s, ("x", "c")) for s in got] == [_values(s, ("x", "c")) for s in want]


def test_optimizer_protocols_match():
    for jcls_, tcls_ in ((jbase.BranchSelector, tbase.BranchSelector),
                         (jbase.GradientFreeOptimizer, tbase.GradientFreeOptimizer)):
        assert tcls_.__abstractmethods__ == jcls_.__abstractmethods__


# -- profiler ------------------------------------------------------------------


def _profile(prof):
    """One scripted run of every profiler entry point: nested timers, a
    runtime decorator, a call beacon. Returns (latency names, tracing counts)."""

    @prof.record_runtime(name_prefix="outer", block_until_ready=True)
    def work(n):
        return np.ones(n)

    @prof.record_tracing(name="body")
    def body(n):
        return n + 1

    with prof.collect_events() as events:
        with prof.timeit("a"):
            with prof.timeit("b"):
                work(3)
        body(1)
        body(2)
    latencies = prof.get_latencies_dict(events)
    assert all(isinstance(v[0], datetime.timedelta) for v in latencies.values())
    return sorted(latencies), prof.get_tracing_counts(events)


def test_profiler_records_the_same_events():
    assert _profile(tprof) == _profile(jprof)
    # Outside collect_events nothing is kept.
    with tprof.timeit("x"):
        pass
    with tprof.collect_events() as events:
        pass
    assert events == []


def _small_study(vz, n=12, seed=0):
    problem = vz.ProblemStatement()
    for j in range(3):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    rng = np.random.default_rng(seed)
    trials = []
    for i, x in enumerate(rng.uniform(size=(n, 3))):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(3)})
        t.complete(vz.Measurement(metrics={"obj": float(np.sum((x - 0.3) ** 2))}))
        trials.append(t)
    return problem, trials


def test_default_suggest_records_the_jax_designers_phase_timers():
    """One small DEFAULT suggest in each package: the same timer names."""
    kw = dict(ard_restarts=2, max_acquisition_evaluations=500)
    problem, trials = _small_study(jvz)
    jd = jucb.VizierGPUCBPEBandit(problem, use_mesh=False, **kw)
    jd.update(jvz.CompletedTrials(trials), jvz.ActiveTrials())
    with jprof.collect_events() as jevents:
        jd.suggest(2)
    problem, trials = _small_study(tvz)
    td = tucb.VizierGPUCBPEBandit(problem, device="cpu", **kw)
    td.update(tvz.CompletedTrials(trials), tvz.ActiveTrials())
    with tprof.collect_events() as tevents:
        td.suggest(2)
    names = sorted(tprof.get_latencies_dict(tevents))
    assert names == sorted(jprof.get_latencies_dict(jevents))
    assert names == ["acquisition_optimizer", "best_candidates_to_trials", "train_gp"]


# -- early stopping ------------------------------------------------------------

_CURVE_PARAMS, _STEPS = 4, 30


def _curve_study(vz, n_trials=50, n_done=40, seed=0):
    """A learning-curve study: y_t = f(x)·(1 − e^(−t/τ(x))) + noise over
    _STEPS steps; the first ``n_done`` trials completed, the rest active at
    progress spread over 10–90%."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_trials, _CURVE_PARAMS))
    final = 1.0 - np.sum((x - 0.4) ** 2, axis=1)
    tau = 2.0 + 8.0 * x[:, 1]
    progress = np.linspace(0.1, 0.9, n_trials - n_done)
    noise = 0.01 * rng.normal(size=(n_trials, _STEPS))
    problem = vz.ProblemStatement()
    for j in range(_CURVE_PARAMS):
        problem.search_space.root.add_float_param(f"p{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="acc", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    trials = []
    for i in range(n_trials):
        t = vz.Trial(id=i + 1, parameters={f"p{j}": float(x[i, j]) for j in range(_CURVE_PARAMS)})
        last = _STEPS if i < n_done else max(1, int(progress[i - n_done] * _STEPS))
        for s in range(1, last + 1):
            value = final[i] * (1.0 - np.exp(-s / tau[i])) + noise[i, s - 1]
            t.measurements.append(vz.Measurement(metrics={"acc": float(value)}, steps=s))
        if i < n_done:
            last_value = t.measurements[-1].metrics["acc"].value
            t.complete(vz.Measurement(metrics={"acc": float(last_value)}, steps=_STEPS))
        trials.append(t)
    return problem, trials


@pytest.fixture(scope="module")
def curve_studies():
    return _curve_study(jvz), _curve_study(tvz)


def _decisions(decisions):
    return [(d.id, d.should_stop, d.reason) for d in decisions.decisions]


@pytest.mark.parametrize("rule", ["median", "median_elapsed", "regression"])
def test_early_stop_rules_match_the_jax_package(curve_studies, rule):
    """Both rules through each package's ``InRamPolicySupporter``: the same
    decisions and reasons; the regression rule's second poll reuses its fit."""
    out = []
    for (problem, trials), lps, sc, es in ((curve_studies[0], jlps, jsc, jes),
                                           (curve_studies[1], tlps, tsc, tes)):
        supporter = lps.InRamPolicySupporter(sc.StudyConfig.from_problem(problem))
        supporter.AddTrials(trials)
        if rule == "regression":
            policy = es.RegressionEarlyStopPolicy(supporter, min_num_trials=10)
        else:
            policy = es.MedianEarlyStopPolicy(supporter, use_steps=rule == "median",
                                              min_num_trials=5)
        first = policy.early_stop(_request(supporter, lps))
        out.append(_decisions(first))
        if rule == "regression":
            fitted = policy._regressor
            again = policy.early_stop(_request(supporter, lps))
            assert policy._regressor is fitted and _decisions(again) == _decisions(first)
    assert out[0] == out[1]
    assert any(stop for _, stop, _ in out[1]) and not all(stop for _, stop, _ in out[1])


def _request(supporter, lps):
    from vizier_tpu.pythia import policy as jpolicy
    from vizier_tpu_torch.pythia import policy as tpolicy

    policy_lib = jpolicy if lps is jlps else tpolicy
    active = [t.id for t in supporter.trials if not t.is_completed]
    return policy_lib.EarlyStopRequest(study_descriptor=supporter.study_descriptor(),
                                       trial_ids=active)


def test_the_port_stops_through_its_supporter():
    """``InRamPolicySupporter.EarlyStopTrials`` applies the regression
    rule's decisions to the trials: the stopped ones are exactly those whose
    predicted final is below the completed median."""
    problem, trials = _curve_study(tvz)
    supporter = tlps.InRamPolicySupporter(tsc.StudyConfig.from_problem(problem))
    supporter.AddTrials(trials)
    policy = tes.RegressionEarlyStopPolicy(supporter, min_num_trials=10)
    decisions = supporter.EarlyStopTrials(policy)
    stopped = {d.id for d in decisions.decisions if d.should_stop}
    assert stopped and stopped == {
        t.id for t in supporter.trials if t.status == tvz.TrialStatus.STOPPING}
    completed = [t for t in supporter.trials if t.is_completed]
    median = np.median([t.final_measurement.metrics["acc"].value for t in completed])
    for t in supporter.trials:
        if not t.is_completed:
            assert (policy._regressor.predict(t) < median) == (t.id in stopped)


def test_gbm_regressor_predictions_match_the_jax_package(curve_studies):
    """The port's numpy boosting against scikit-learn's through the JAX
    package: the same predictions within 1e-6, fitted on the completed
    curves and read at the active trials' partial curves."""
    (_, jtrials), (_, ttrials) = curve_studies
    jg, tg = jreg.GBMAutoRegressor("acc"), treg.GBMAutoRegressor("acc")
    assert jg.train([t for t in jtrials if t.is_completed])
    assert tg.train([t for t in ttrials if t.is_completed])
    want = np.asarray([jg.predict(t) for t in jtrials])
    got = np.asarray([tg.predict(t) for t in ttrials])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,n", [(0, 60), (1, 300)])
def test_gradient_boosting_matches_scikit_learn(seed, n):
    """The boosting alone against scikit-learn's ``GradientBoostingRegressor``
    on data with repeated values (a per-group constant column, a 4-level
    one, a constant one): predictions within 1e-12."""
    from sklearn import ensemble

    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 6))
    x[:, 0] = np.repeat(rng.uniform(size=n // 4), 4)
    x[:, 1] = np.tile([0.25, 0.5, 0.75, 1.0], n // 4)
    x[:, 2] = 7.0
    y = np.sin(3 * x[:, 0]) + x[:, 3] ** 2 + 0.1 * rng.normal(size=n)
    q = rng.uniform(size=(50, 6))
    want = ensemble.GradientBoostingRegressor(n_estimators=30, random_state=seed).fit(x, y)
    got = treg.GradientBoostingRegressor(n_estimators=30, random_state=seed).fit(x, y)
    np.testing.assert_allclose(got.predict(q), want.predict(q), rtol=0, atol=1e-12)


def test_hallucinator_matches_the_jax_package(curve_studies):
    (_, jtrials), (_, ttrials) = curve_studies
    jh, th = jreg.TrialHallucinator("acc"), treg.TrialHallucinator("acc")
    jh.train([t for t in jtrials if t.is_completed])
    th.train([t for t in ttrials if t.is_completed])
    want = jh.hallucinate_final_measurements([t for t in jtrials if not t.is_completed])
    got = th.hallucinate_final_measurements([t for t in ttrials if not t.is_completed])
    assert [t.id for t in got] == [t.id for t in want]
    np.testing.assert_allclose([t.final_measurement.metrics["acc"].value for t in got],
                               [t.final_measurement.metrics["acc"].value for t in want],
                               rtol=0, atol=1e-6)
    assert all(t.metadata.ns("regression")["hallucinated"] == "True" for t in got)


def test_trial_data_matches_the_jax_package(curve_studies):
    (_, jtrials), (_, ttrials) = curve_studies
    for jt, tt in zip(jtrials[38:42], ttrials[38:42]):
        jd, td = jreg.TrialData.from_trial(jt, "acc"), treg.TrialData.from_trial(tt, "acc")
        assert (td.steps, td.objective_values, td.parameters) == (
            jd.steps, jd.objective_values, jd.parameters)
        assert td.extrapolate_objective_value(40) == jd.extrapolate_objective_value(40)


@pytest.mark.parametrize("kind", ["gp", "logistic", "constant"])
def test_feasibility_classifier_matches_the_jax_package(kind):
    """Both packages' classifier (scikit-learn inside, as in the JAX
    package) on the same trials: equal probabilities."""
    outs = []
    for vz, cls in ((jvz, jcls), (tvz, tcls)):
        problem, trials = _small_study(vz, n=20)
        for t in trials:
            if kind != "constant" and t.parameters.get_value("x0") > 0.6:
                t.complete(vz.Measurement(), infeasibility_reason="too far")
        queries = [vz.TrialSuggestion(parameters={"x0": v, "x1": 0.5, "x2": 0.5})
                   for v in (0.1, 0.5, 0.9)]
        model = cls.FeasibilityClassifier(problem, kind="gp" if kind == "constant" else kind)
        outs.append(model.fit(trials).predict_proba_feasible(queries))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-12)


def test_curve_regressor_matches_the_jax_package(curve_studies):
    (_, jtrials), (_, ttrials) = curve_studies
    for jt, tt in zip(jtrials[:3] + jtrials[-3:], ttrials[:3] + ttrials[-3:]):
        jr_ = jcls.TrialCurveRegressor("acc").fit(jt)
        tr_ = tcls.TrialCurveRegressor("acc").fit(tt)
        assert (tr_.asymptote, tr_.predict(50.0)) == (jr_.asymptote, jr_.predict(50.0))
    assert tcls.TrialCurveRegressor("acc").fit(tvz.Trial(id=1)) is None


# -- ensemble and meta-learning designers -------------------------------------


def _run_rounds(vz, designer, problem, rounds, count, objective):
    """``rounds`` suggest(count) rounds, each completed through ``objective``;
    returns each round's parameter values and the designer's record."""
    names = [p.name for p in problem.search_space.parameters]
    out, next_id = [], 1
    for _ in range(rounds):
        batch = designer.suggest(count)
        completed = []
        for s in batch:
            t = s.to_trial(next_id)
            next_id += 1
            t.complete(vz.Measurement(metrics={"obj": objective(_values(s, names))}))
            completed.append(t)
        out.append(([_values(s, names) for s in batch],
                    [s.metadata.ns("ensemble").get("expert") for s in batch]))
        designer.update(vz.CompletedTrials(completed), vz.ActiveTrials())
    return out


def _sphere(values):
    return float(np.sum((np.asarray(values, float) - 0.3) ** 2))


def _cube(vz):
    problem = vz.ProblemStatement()
    for j in range(_DIM):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    return problem


@pytest.mark.parametrize("design", ["exp3ix", "exp3", "random", "ucb"])
def test_ensemble_designer_matches_the_jax_package(design):
    """EnsembleDesigner over the host arms (Random, Eagle) from seed 0: the
    same arm sequence and the same suggestions, round after round."""
    outs = []
    for vz, ens, rnd, eagle in ((jvz, jens, jrandom, jeagle), (tvz, tens, trandom, teagle)):
        problem = _cube(vz)
        bandit = {"exp3ix": None, "exp3": ens.EXP3UniformEnsembleDesign(2),
                  "random": ens.RandomEnsembleDesign(2), "ucb": ens.UCBEnsembleDesign(2)}[design]
        designer = ens.EnsembleDesigner(
            problem, designers={"random": rnd.RandomDesigner(problem.search_space, seed=1),
                                "eagle": eagle.EagleStrategyDesigner(problem, seed=2)},
            design=bandit, seed=0)
        outs.append(_run_rounds(vz, designer, problem, 6, 3, _sphere))
        outs.append(designer.design.probabilities)
    assert outs[2] == outs[0]
    np.testing.assert_array_equal(outs[3], outs[1])


def test_eagle_meta_learning_matches_the_jax_package():
    """eagle_meta_learning_designer through INITIALIZE, TUNE and
    USE_BEST_PARAMS: the same state sequence and the same suggestions."""
    outs = []
    for vz, eml, ml in ((jvz, jeml, jml), (tvz, teml, tml)):
        problem = _cube(vz)
        designer = eml.eagle_meta_learning_designer(
            problem, config=ml.MetaLearningConfig(
                tuning_interval=6, tuning_min_num_trials=6, tuning_max_num_trials=24), seed=0)
        states, rounds = [], []
        for _ in range(10):
            states.append(designer.state)
            rounds.append(_run_rounds(vz, designer, problem, 1, 3, _sphere))
        outs.append((states, rounds, [
            {k: v.value for k, v in t.parameters.items()} for t in designer._meta_trials]))
    assert outs[1] == outs[0]
    assert outs[1][0][0] == "INITIALIZE" and outs[1][0][-1] == "USE_BEST_PARAMS"
    assert "TUNE" in outs[1][0]
    spaces = [[(c.name, c.bounds, c.scale_type) for c in m.meta_eagle_search_space().parameters]
              for m in (jeml, teml)]
    assert len(spaces[1]) == 8 and [(n, b, str(s)) for n, b, s in spaces[1]] == [
        (n, b, str(s)) for n, b, s in spaces[0]]


# -- small host modules --------------------------------------------------------


def _prior_space(vz):
    problem = vz.ProblemStatement()
    root = problem.search_space.root
    root.add_float_param("a", 0.0, 1.0)
    root.add_int_param("b", 1, 5)
    root.add_discrete_param("c", [0.1, 0.5, 2.0])
    root.add_categorical_param("d", ["x", "y"])
    root.add_float_param("fixed", 3.0, 3.0)
    return problem


def test_embedder_matches_the_jax_package():
    outs = []
    for vz, emb in ((jvz, jemb), (tvz, temb)):
        trials = []
        for i, params in enumerate([dict(a=1.7, b=9.2, c=0.4, d="z", extra=1.0),
                                    dict(a=-0.5, b="wrong", c=1.9),
                                    dict(d="y")]):
            t = vz.Trial(id=i + 1, parameters=params)
            t.complete(vz.Measurement(metrics={"obj": float(i)}))
            trials.append(t)
        mapped = emb.ProblemAndTrialsScaler(_prior_space(vz)).map_trials(trials)
        outs.append([({k: v.value for k, v in t.parameters.items()}, t.id,
                      t.final_measurement.metrics["obj"].value) for t in mapped])
    assert outs[1] == outs[0]


def test_singleton_params_match_the_jax_package():
    outs = []
    for vz, sp in ((jvz, jsp), (tvz, tsp)):
        handler = sp.SingletonParameterHandler(_prior_space(vz))
        suggestion = vz.TrialSuggestion(parameters={"a": 0.5, "b": 2, "c": 0.5, "d": "x"})
        (augmented,) = handler.augment([suggestion])
        t = vz.Trial(id=1, parameters={"a": 0.5, "fixed": 3.0})
        (stripped,) = handler.strip([t])
        outs.append((handler.fixed_parameters,
                     [p.name for p in handler.reduced_problem.search_space.parameters],
                     {k: v.value for k, v in augmented.parameters.items()},
                     {k: v.value for k, v in stripped.parameters.items()}))
    assert outs[1] == outs[0]


def test_context_matches_the_jax_package():
    for vz, ctx in ((jvz, jctx), (tvz, tctx)):
        c = ctx.Context(description="d", parameters={"p": vz.ParameterValue(1.0)},
                        related_links={"l": "u"})
        assert c.parameters["p"].value == 1.0
        for bad in (dict(description=3), dict(parameters={1: vz.ParameterValue(1.0)}),
                    dict(parameters={"p": 1.0}), dict(related_links={"l": 2})):
            with pytest.raises(TypeError):
                ctx.Context(**bad)


def _conditional_space(vz):
    space = vz.SearchSpace()
    root = space.root
    model = root.add_categorical_param("model", ["linear", "dnn"])
    model.select_values(["dnn"]).add_int_param("layers", 1, 4)
    model.select_values(["linear"]).add_float_param("l2", 0.0, 1.0)
    root.add_float_param("lr", 1e-3, 1.0)
    return space


def test_parameter_iterators_match_the_jax_package():
    outs = []
    for vz, pi in ((jvz, jpi), (tvz, tpi)):
        walked = []
        for first in ("dnn", "linear"):
            walk = pi.SequentialParameterBuilder(_conditional_space(vz))
            seen = []
            for config in walk:
                seen.append(config.name)
                walk.choose_value({"model": first, "layers": 3, "l2": 0.5, "lr": 0.1}[
                    config.name])
            walked.append((seen, {k: v.value for k, v in walk.parameters.items()}))
        walk = pi.SequentialParameterBuilder(_conditional_space(vz))
        next(walk)
        with pytest.raises(RuntimeError):
            next(walk)
        outs.append(walked)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("name,args,fails", [
    ("assert_not_empty", ("x", []), True), ("assert_not_empty", ("x", [1]), False),
    ("assert_not_negative", ("x", -1), True), ("assert_not_negative", ("x", 0), False),
    ("assert_not_none", ("x", None), True), ("assert_between", ("x", 2, 0, 1), True),
    ("assert_between", ("x", 0.5, 0, 1), False), ("assert_re_fullmatch", ("x", "ab", "a+"), True),
    ("assert_re_fullmatch", ("x", "aa", "a+"), False),
    ("assert_shape", ("x", np.zeros((2, 3)), (2, None)), False),
    ("assert_shape", ("x", np.zeros((2, 3)), (3, None)), True),
])
def test_validators_match_the_jax_package(name, args, fails):
    messages = []
    for mod in (jval, tval):
        try:
            getattr(mod, name)(*args)
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    assert messages[0] == messages[1] and (messages[0] is not None) == fails


def test_policy_factory_protocol_matches_the_jax_package():
    assert isinstance(tservice_pf.DefaultPolicyFactory(device="cpu"), tpf.PolicyFactory)
    assert isinstance(jservice_pf.DefaultPolicyFactory(), jpf.PolicyFactory)
    assert not isinstance(object(), tpf.PolicyFactory)


def test_spatio_temporal_converters_match_the_jax_package(curve_studies):
    (jproblem, jtrials), (tproblem, ttrials) = curve_studies
    jtr, ttr = jtrials[36:44], ttrials[36:44]
    for mode in ("raw", "cummax"):
        jx = jst.TimedLabelsExtractor(jproblem.metric_information, value_mode=mode)
        tx = tst.TimedLabelsExtractor(tproblem.metric_information, value_mode=mode)
        for a, b in zip(jx.convert(jtr), tx.convert(ttr)):
            np.testing.assert_array_equal(b.positions, a.positions)
            np.testing.assert_array_equal(b.values, a.values)
        np.testing.assert_array_equal(tx.extract_all_timestamps(ttr),
                                      jx.extract_all_timestamps(jtr))
        for a, b in zip(jst.SparseSpatioTemporalConverter(jx).to_arrays(jtr),
                        tst.SparseSpatioTemporalConverter(tx).to_arrays(ttr)):
            np.testing.assert_array_equal(b, a)
        dense_j, dense_t = (jst.DenseSpatioTemporalConverter(jx, num_steps=7),
                            tst.DenseSpatioTemporalConverter(tx, num_steps=7))
        for a, b in zip(dense_j.to_xty(jtr, jproblem.search_space),
                        dense_t.to_xty(ttr, tproblem.search_space)):
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        tst.TimedLabelsExtractor(tproblem.metric_information, value_mode="bad")
