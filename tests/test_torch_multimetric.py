"""Multi-objective studies: the port against the JAX package, on the CPU.

The same numpy-seeded inputs go through each JAX function and its port:
the HV scalarization and the scalarized PE penalty, the reference point,
the per-metric mixture and PE conditioning (per-metric states carried
across by ``interop``), the SEPARABLE multi-task GP in each variant, the
Pareto ops and ``multimetric``, and the designers at a small size (4-D
DTLZ2, 20 trials). Where a function draws random numbers (the HV
directions, the hypervolume's directions) the JAX draws are fed to the
port.

Tolerances: scalarizations, penalties and the reference point rtol 1e-5;
predictions and thresholds atol 1e-4 (as ``test_torch_gp.py``), the
multi-task ``alpha`` (entries up to ~10) rtol 1e-4 as well; the multi-task NLL rtol 1e-5 and its gradient rtol 1e-4 (atol 1e-4 for entries
near zero); the port's acquisition at the JAX designer's first pick rtol 1e-5, and
the best first-pick acquisition within 2% (mean over four seeds), as
``test_torch_designer.py`` holds the single-objective one.
"""

from __future__ import annotations

import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters.synthetic import multiobjective as jmo
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import gp as jgp
from vizier_tpu.models import kernels as jk
from vizier_tpu.models import multitask_gp as jmt
from vizier_tpu.ops import pareto as jpareto
from vizier_tpu.pyvizier import multimetric as jmm
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch import surrogates as tsurrogates
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk
from vizier_tpu_torch.models import multitask_gp as tmt
from vizier_tpu_torch.ops import pareto as tpareto
from vizier_tpu_torch.pyvizier import multimetric as tmm

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_RTOL = 1e-5
_ATOL = 1e-4


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


# -- HV scalarization, penalty, reference point ------------------------------


def _hv_inputs(m, seed=0, k=64, q=30, n=25):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(m, q)).astype(np.float32)
    w = np.abs(rng.normal(size=(k, m))).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    labels = rng.normal(size=(m, n)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    ref = (labels.min(axis=1) - 0.3).astype(np.float32)
    return values, w, ref, labels, mask


@pytest.mark.parametrize("m", [2, 3])
def test_hv_scalarized_matches(m):
    values, w, ref, labels, mask = _hv_inputs(m)
    want = jucb._hv_scalarized(*map(jnp.asarray, (values, w, ref, labels, mask)))
    inv_w = 1.0 / torch.clamp(_t(w), min=1e-6)
    floor = tucb._hv_floor(inv_w, _t(ref), _t(labels), _t(mask, torch.bool))
    got = tucb._hv_scalarized(_t(values), inv_w, _t(ref), floor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL, atol=1e-7)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("mode", ["union", "intersection", "average"])
def test_scalarize_penalty_matches(m, mode):
    penalty = np.minimum(np.random.default_rng(m).normal(size=(m, 40)), 0.0).astype(np.float32)
    want = jucb._scalarize_penalty(jnp.asarray(penalty), mode)
    got = tucb._scalarize_penalty(_t(penalty), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL)


def test_config_validates_the_penalty_mode_and_multitask_type():
    with pytest.raises(ValueError):
        tucb.UCBPEConfig(multimetric_promising_region_penalty_type="sum")
    with pytest.raises(ValueError):
        tucb.UCBPEConfig(multitask_type="SEPARABLE")
    assert tucb.MultiTaskType.SEPARABLE_NORMAL is tucb.MultiTaskType.SEPARABLE
    assert tucb.UCBPEConfig().num_scalarizations == jucb.UCBPEConfig().num_scalarizations == 1000


@pytest.mark.parametrize("m", [2, 3])
def test_reference_point_matches(m):
    _, _, _, labels, mask = _hv_inputs(m, seed=3)
    want = jacq.get_reference_point(jnp.asarray(labels), jnp.asarray(mask))
    got = tacq.get_reference_point(_t(labels), _t(mask, torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL)


# -- per-metric states ----------------------------------------------------------


def _metric_datas(m, n=14, n_pad=16, dc=3, seed=0):
    """JAX GPDatas over shared features; metric 1 lacks its value on row 2
    (a padded row of its GP, a valid row of the others)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, dc), np.float32)
    x[:n] = rng.uniform(size=(n, dc))
    datas = []
    for j in range(m):
        labels = np.zeros(n_pad, np.float32)
        labels[:n] = np.sin((j + 2) * x[:n]).sum(-1) + 0.1 * rng.normal(size=n)
        mask = np.arange(n_pad) < n
        if j == 1:
            mask[2] = False
            labels[2] = 0.0
        datas.append(jgp.GPData(
            continuous=jnp.asarray(x), categorical=jnp.zeros((n_pad, 0), jnp.int32),
            labels=jnp.asarray(labels), row_mask=jnp.asarray(mask),
            cont_dim_mask=jnp.ones(dc, bool), cat_dim_mask=jnp.ones(0, bool),
        ))
    return datas


def _metric_params(m, e, dc=3, seed=0, noise=0.1):
    """Constrained params [M, E, ...]."""
    rng = np.random.default_rng(seed + 10)
    return {
        "amplitude": rng.uniform(0.8, 1.5, (m, e)).astype(np.float32),
        "noise_stddev": np.full((m, e), noise, np.float32),
        "continuous_length_scales": rng.uniform(0.3, 1.0, (m, e, dc)).astype(np.float32),
    }


def _jax_states(datas, params):
    jmodel = jgp.VizierGaussianProcess(num_continuous=3, num_categorical=0)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    return jax.vmap(
        lambda d, q: jax.vmap(lambda r: jmodel.precompute_constrained(r, d))(q)
    )(stacked, p)


def _port_states(datas, params):
    tmodel = tgp.VizierGaussianProcess(num_continuous=3, num_categorical=0, device="cpu")
    return interop.gp_states_from_numpy(tmodel, params, datas)


@pytest.mark.parametrize("m,e", [(2, 1), (3, 2)])
def test_mixture_predict_matches_per_metric(m, e):
    datas, params = _metric_datas(m), _metric_params(m, e)
    q = np.random.default_rng(5).uniform(size=(9, 3)).astype(np.float32)
    want = jucb._mixture_predict(
        _jax_states(datas, params), jk.MixedFeatures(jnp.asarray(q), jnp.zeros((9, 0), jnp.int32))
    )
    got = tucb._mixture_predict(
        _port_states(datas, params), tk.MixedFeatures(_t(q), torch.zeros((9, 0), dtype=torch.int32))
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL)


@pytest.mark.parametrize("noise", [0.1, 2.0])
def test_pe_conditioning_matches_per_metric(noise):
    """Thresholds [M], the one noise_is_high over metrics and members, and
    the PE parameters (noise 2.0 puts every SNR under 0.7)."""
    datas, params = _metric_datas(2), _metric_params(2, 2, noise=noise)
    # The all-points rows: the completed ones plus two pending.
    all_np = _metric_datas(1, n=16, seed=0)[0]
    want_pe, want_high, want_thr = jucb._pe_conditioning(
        _jax_states(datas, params), all_np, jucb.UCBPEConfig()
    )
    got_pe, got_high, got_thr = tucb._pe_conditioning(
        _port_states(datas, params), interop.gp_data_from_numpy(all_np, "cpu"), tucb.UCBPEConfig()
    )
    assert bool(got_high) == bool(want_high) == (noise > 1.0)
    np.testing.assert_allclose(got_thr.numpy(), np.asarray(want_thr), atol=_ATOL)
    for j, p in enumerate(got_pe):
        np.testing.assert_allclose(p["noise_stddev"].numpy(), np.asarray(want_pe["noise_stddev"])[j])


@pytest.mark.parametrize("m", [2, 3])
def test_hv_scalarized_scoring_matches_with_injected_directions(m):
    datas = _metric_datas(m)
    params = _metric_params(m, 1)
    rng = np.random.default_rng(m)
    w = np.abs(rng.normal(size=(32, m))).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    ref = np.full(m, -1.5, np.float32)
    q = rng.uniform(size=(20, 3)).astype(np.float32)
    jstates = jax.tree_util.tree_map(lambda a: a[:, 0], _jax_states(datas, params))
    want = jacq.HVScalarizedScoring(
        metric_states=jstates, directions=jnp.asarray(w), reference_point=jnp.asarray(ref)
    ).score(jk.MixedFeatures(jnp.asarray(q), jnp.zeros((20, 0), jnp.int32)))
    got = tacq.HVScalarizedScoring(
        metric_states=_port_states(datas, params), directions=_t(w), reference_point=_t(ref)
    ).score(tk.MixedFeatures(_t(q), torch.zeros((20, 0), dtype=torch.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


# -- the multi-task GP ------------------------------------------------------------

_MT_TYPES = ["SEPARABLE", "SEPARABLE_LKJ", "SEPARABLE_DIAG"]


def _mt_setup(kind, m=2, seed=0):
    """Both models, the data (padded rows; task 1 lacks row 3) and
    unconstrained parameters for two restarts."""
    datas = _metric_datas(m, n=12, n_pad=16, seed=seed)
    datas[1] = datas[1].replace(row_mask=datas[1].row_mask.at[3].set(False).at[2].set(True))
    jdata = jmt.MultiTaskData.from_gp_datas(tuple(datas))
    jmodel = jmt.MultiTaskGaussianProcess(3, 0, m, jmt.MultiTaskType[kind])
    tmodel = tmt.MultiTaskGaussianProcess(3, 0, m, tmt.MultiTaskType[kind], device="cpu")
    rng = np.random.default_rng(seed + 7)
    ntril = m * (m - 1) // 2
    unconstrained = []
    for _ in range(2):
        constrained = {
            "amplitude": np.float32(rng.uniform(0.8, 1.5)),
            "noise_stddev": np.float32(0.1),
            "continuous_length_scales": rng.uniform(0.3, 1.0, 3).astype(np.float32),
            "task_chol_diag": rng.uniform(0.5, 1.5, m).astype(np.float32),
            "task_chol_offdiag": rng.uniform(-0.8, 0.8, ntril).astype(np.float32),
            "task_corr_chol_vec": rng.uniform(-0.8, 0.8, ntril).astype(np.float32),
            "task_sqrt_diag": rng.uniform(0.4, 0.9, m).astype(np.float32),
        }
        coll = jmodel.param_collection()
        unconstrained.append({
            k: np.asarray(v)
            for k, v in coll.unconstrain({s.name: constrained[s.name] for s in coll.specs}).items()
        })
    batched = {k: np.stack([u[k] for u in unconstrained]) for k in unconstrained[0]}
    return jmodel, jdata, tmodel, interop.multitask_data_from_numpy(jdata, "cpu"), unconstrained, batched


@pytest.mark.parametrize("kind", _MT_TYPES)
def test_multitask_task_covariance_matches(kind):
    jmodel, _, tmodel, _, unconstrained, batched = _mt_setup(kind, m=3)
    tp = tmodel.param_collection().constrain(interop.gp_params_from_numpy(batched, "cpu"))
    got_cov = tmodel._task_cov(tp)
    got_reg = tmodel._extra_regularization(tp) + tmodel.param_collection().regularization(tp)
    for i, u in enumerate(unconstrained):
        jp = jmodel.param_collection().constrain({k: jnp.asarray(v) for k, v in u.items()})
        np.testing.assert_allclose(got_cov[i].numpy(), np.asarray(jmodel._task_cov(jp)), rtol=_RTOL, atol=1e-6)
        want_reg = jmodel._extra_regularization(jp) + jmodel.param_collection().regularization(jp)
        np.testing.assert_allclose(float(got_reg[i]), float(want_reg), rtol=_RTOL, atol=1e-6)
    if kind == "SEPARABLE_LKJ":
        vec = np.asarray(unconstrained[0]["task_corr_chol_vec"])
        np.testing.assert_allclose(
            tmt._corr_cholesky(_t(vec), 3).numpy(), np.asarray(jmt._corr_cholesky(jnp.asarray(vec), 3)),
            rtol=_RTOL, atol=1e-7,
        )


@pytest.mark.parametrize("kind", _MT_TYPES)
def test_multitask_nll_and_gradient_match(kind):
    jmodel, jdata, tmodel, tdata, unconstrained, batched = _mt_setup(kind)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in batched.items()}
    loss = tmodel.neg_log_likelihood(leaves, tdata)
    loss.sum().backward()
    got = loss.detach()
    for i, u in enumerate(unconstrained):
        want, want_grad = jax.value_and_grad(jmodel.neg_log_likelihood)(
            {k: jnp.asarray(v) for k, v in u.items()}, jdata
        )
        np.testing.assert_allclose(float(got[i]), float(want), rtol=_RTOL)
        for k, g in want_grad.items():
            np.testing.assert_allclose(leaves[k].grad[i].numpy(), np.asarray(g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", _MT_TYPES)
def test_multitask_precompute_and_predict_match(kind):
    jmodel, jdata, tmodel, tdata, unconstrained, batched = _mt_setup(kind)
    tstate = tmodel.precompute(interop.gp_params_from_numpy(batched, "cpu"), tdata)
    q = np.random.default_rng(9).uniform(size=(7, 3)).astype(np.float32)
    got_mean, got_std = tstate.predict(tk.MixedFeatures(_t(q), torch.zeros((7, 0), dtype=torch.int32)))
    for i, u in enumerate(unconstrained):
        jstate = jmodel.precompute({k: jnp.asarray(v) for k, v in u.items()}, jdata)
        np.testing.assert_allclose(tstate.alpha[i].numpy(), np.asarray(jstate.alpha),
                                   rtol=1e-4, atol=_ATOL)
        mean, std = jstate.predict(jk.MixedFeatures(jnp.asarray(q), jnp.zeros((7, 0), jnp.int32)))
        np.testing.assert_allclose(got_mean[i].numpy(), np.asarray(mean), atol=_ATOL)
        np.testing.assert_allclose(got_std[i].numpy(), np.asarray(std), atol=_ATOL)


def test_multitask_mixture_and_metric_zero_predictive_match():
    jmodel, jdata, tmodel, tdata, unconstrained, batched = _mt_setup("SEPARABLE")
    jstates = jax.vmap(lambda p: jmodel.precompute(p, jdata))(
        {k: jnp.asarray(v) for k, v in batched.items()})
    tstates = tmodel.precompute(interop.gp_params_from_numpy(batched, "cpu"), tdata)
    q = np.random.default_rng(4).uniform(size=(6, 3)).astype(np.float32)
    jq = jk.MixedFeatures(jnp.asarray(q), jnp.zeros((6, 0), jnp.int32))
    tq = tk.MixedFeatures(_t(q), torch.zeros((6, 0), dtype=torch.int32))
    for got, want in zip(tucb._mt_mixture_predict(tstates, tq), jucb._mt_mixture_predict(jstates, jq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)
    for got, want in zip(tucb._MetricZeroMTPredictive(tstates).predict(tq),
                         jucb._MetricZeroMTPredictive(jstates).predict(jq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)


def test_multitask_append_row_marks_every_task():
    _, jdata, _, tdata, _, _ = _mt_setup("SEPARABLE")
    x = np.full((1, 3), 0.25, np.float32)
    want = jucb._append_row_mt(jdata, jk.MixedFeatures(jnp.asarray(x), jnp.zeros((1, 0), jnp.int32)))
    got = tucb._append_row_mt(tdata, tk.MixedFeatures(_t(x), torch.zeros((1, 0), dtype=torch.int32)))
    np.testing.assert_array_equal(got.task_mask.numpy(), np.asarray(want.task_mask))
    np.testing.assert_array_equal(got.features_data.continuous.numpy(),
                                  np.asarray(want.features_data.continuous))


# -- Pareto ops and multimetric ------------------------------------------------------


def _pareto_points(seed=0, n=40, m=3):
    rng = np.random.default_rng(seed)
    points = rng.integers(0, 4, size=(n, m)).astype(np.float32)  # many ties
    points[5] = points[6]  # a duplicate
    mask = rng.uniform(size=n) < 0.8
    return points, mask


@pytest.mark.parametrize("masked", [False, True])
def test_pareto_ops_match(masked):
    points, mask = _pareto_points()
    jm, tm = (jnp.asarray(mask), _t(mask, torch.bool)) if masked else (None, None)
    jp, tp = jnp.asarray(points), _t(points)
    np.testing.assert_array_equal(tpareto.domination_matrix(tp).numpy(),
                                  np.asarray(jpareto.domination_matrix(jp)))
    np.testing.assert_array_equal(tpareto.dominates(tp[0], tp[1]).numpy(),
                                  np.asarray(jpareto.dominates(jp[0], jp[1])))
    np.testing.assert_array_equal(tpareto.is_frontier(tp, valid_mask=tm).numpy(),
                                  np.asarray(jpareto.is_frontier(jp, valid_mask=jm)))
    np.testing.assert_array_equal(tpareto.pareto_rank(tp, valid_mask=tm).numpy(),
                                  np.asarray(jpareto.pareto_rank(jp, valid_mask=jm)))
    layers = jpareto.nondomination_layers(jp, valid_mask=jm)
    np.testing.assert_array_equal(tpareto.nondomination_layers(tp, valid_mask=tm).numpy(),
                                  np.asarray(layers))
    # Continuous points for the crowding distance (ties would make the sort
    # order, and so the gaps, depend on the sort's tie-breaking).
    cont = np.random.default_rng(1).normal(size=points.shape).astype(np.float32)
    clayers = jpareto.nondomination_layers(jnp.asarray(cont), valid_mask=jm)
    np.testing.assert_allclose(
        tpareto.crowding_distance(_t(cont), _t(clayers, torch.int64), valid_mask=tm).numpy(),
        np.asarray(jpareto.crowding_distance(jnp.asarray(cont), clayers, valid_mask=jm)),
        rtol=_RTOL,
    )


def _jax_directions(key, k, m):
    v = jnp.abs(jax.random.normal(key, (k, m), dtype=jnp.float32))
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("masked", [False, True])
def test_cum_hypervolume_matches_with_the_jax_draws(masked):
    points, mask = _pareto_points(seed=2, m=2)
    key = jax.random.PRNGKey(3)
    want = jpareto.cum_hypervolume_origin(
        jnp.asarray(points), key, num_vectors=500, valid_mask=jnp.asarray(mask) if masked else None)
    got = tpareto.cum_hypervolume_origin(
        _t(points), _t(_jax_directions(key, 500, 2)),
        valid_mask=_t(mask, torch.bool) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL)


def test_multimetric_matches():
    points, _ = _pareto_points(seed=4, m=2)
    jalg, talg = jmm.ParetoOptimalAlgorithm(), tmm.ParetoOptimalAlgorithm(device="cpu")
    np.testing.assert_array_equal(talg.is_pareto_optimal(points), jalg.is_pareto_optimal(points))
    np.testing.assert_array_equal(talg.pareto_rank(points), jalg.pareto_rank(points))
    origin = np.array([-0.5, -1.0], np.float32)
    jfront = jmm.ParetoFrontier(points, origin, num_vectors=400, seed=1)
    tfront = tmm.ParetoFrontier(points, origin, num_vectors=400, seed=1, device="cpu")
    tfront._directions = _t(_jax_directions(jax.random.PRNGKey(1), 400, 2))
    np.testing.assert_allclose(tfront.hypervolume(), jfront.hypervolume(), rtol=_RTOL)
    np.testing.assert_allclose(tfront.hypervolume(is_cumulative=True),
                               jfront.hypervolume(is_cumulative=True), rtol=_RTOL)


def test_safety_checker_matches():
    def trials(vz):
        out = []
        for i, value in enumerate([0.2, 0.6, None, 0.9]):
            t = vz.Trial(id=i + 1, parameters={"x0": 0.5})
            metrics = {"f1": 1.0} if value is None else {"f1": 1.0, "safe": value}
            t.complete(vz.Measurement(metrics=metrics))
            out.append(t)
        return out

    got = tmm.SafetyChecker(_problem(tvz, safety=True).metric_information).warp_unsafe_trials(trials(tvz))
    want = jmm.SafetyChecker(_problem(jvz, safety=True).metric_information).warp_unsafe_trials(trials(jvz))
    assert [t.infeasibility_reason for t in got] == [t.infeasibility_reason for t in want]
    assert [t.infeasibility_reason is None for t in got] == [False, True, True, True]


# -- the designers ----------------------------------------------------------------

_DIM = 4
_KW = dict(ard_restarts=2, max_acquisition_evaluations=2000, warm_start_min_trials=10)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_dtlz2_is_the_repo_function():
    """chip_smoke's multi-objective phase builds its study through the port's
    DTLZ2 experimenter: the points of seed 0 and the JAX package's DTLZ2
    labels, bit for bit, with the checksum it prints."""
    chip_smoke = _load_chip_smoke()
    problem, trials = chip_smoke._dtlz2_study(tvz)
    dim = chip_smoke._DIM
    x = np.random.default_rng(0).uniform(size=(chip_smoke._NUM_TRIALS, dim))
    got = np.array([[t.parameters.get_value(f"x{j}") for j in range(dim)] for t in trials])
    names = [m.name for m in problem.metric_information]
    labels = np.array([[t.final_measurement.metrics[k].value for k in names] for t in trials])
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(labels, jmo.dtlz2(x, num_objectives=2))
    digest = hashlib.sha256(np.concatenate([x, labels], axis=1).tobytes()).hexdigest()
    assert chip_smoke._study_checksum(trials, problem) == digest[:16]


def _problem(vz, safety=False):
    p = vz.ProblemStatement()
    for j in range(_DIM):
        p.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    p.metric_information.append(vz.MetricInformation(name="f1", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    if safety:
        p.metric_information.append(vz.MetricInformation(
            name="safe", goal=vz.ObjectiveMetricGoal.MAXIMIZE, safety_threshold=0.5))
    p.metric_information.append(vz.MetricInformation(name="f2", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    return p


def _trials(vz, n=20, seed=0, safety=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, _DIM))
    f = jmo.dtlz2(x, num_objectives=2)
    out = []
    for i in range(n):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[i, j]) for j in range(_DIM)})
        metrics = {"f1": float(f[i, 0]), "f2": float(f[i, 1])}
        if safety:
            metrics["safe"] = 1.0
        t.complete(vz.Measurement(metrics=metrics))
        out.append(t)
    return out


def _assert_valid(suggestions, count, m=2):
    assert len(suggestions) == count
    for s in suggestions:
        values = [s.parameters.get_value(f"x{j}") for j in range(_DIM)]
        assert all(0.0 <= v <= 1.0 for v in values)
        pred = s.metadata.ns("gp_ucb_pe").ns("prediction_in_warped_y_space")
        for key in ("mean", "stddev", "stddev_from_all"):
            array = np.array([float(v) for v in pred[key].strip("[]").split(",")])
            assert array.shape == (m,) and np.all(np.isfinite(array))


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
    return jd, td, td.suggest(3)


def test_multiobjective_suggestions_are_valid(designers):
    _, td, suggestions = designers
    _assert_valid(suggestions, 3)
    assert suggestions[0].metadata.ns("gp_ucb_pe")["use_ucb"] == "True"
    states, datas = td._cached_states
    assert len(states) == len(datas) == 2
    assert all(bool(torch.isfinite(s.chol).all()) for s in states)
    assert td.ard_train_counts == {"cold": 1, "warm": 0}


def test_warm_start_state_round_trips_per_metric(designers):
    _, td, _ = designers
    warm = td.warm_start_state()
    assert warm is not None and len(warm) == 2
    fresh = tucb.VizierGPUCBPEBandit(_problem(tvz), device="cpu", **_KW)
    assert fresh.warm_start_state() is None and len(fresh._warm_params_me) == 2
    fresh.set_warm_start_state(warm)
    for got, want in zip(fresh.warm_start_state(), warm):
        for k, v in want.items():
            torch.testing.assert_close(got[k], v)
    with pytest.raises(ValueError):
        fresh.set_warm_start_state(warm[:1])


def test_first_pick_acquisition_within_two_percent(designers, monkeypatch):
    """The JAX designer's trained per-metric posteriors in both packages, the
    same HV directions (each JAX pick's draws, fed to the port), UCB forced
    on the first pick. The port's acquisition at the JAX pick is the JAX
    value; and the best value each package's sweep finds agrees within 2%
    on the mean over four seeds: the two eagle sweeps draw different
    numbers, and one sweep's best spreads by about ±2% at this budget in
    either package, so one pair alone is not a fair comparison."""
    jd, td, _ = designers
    jstates, jdatas = jd._train_states_me()
    labels_mn = jnp.stack([d.labels for d in jdatas])
    ref = jacq.get_reference_point(labels_mn, jdatas[0].row_mask)
    tstates = interop.gp_states_from_numpy(td._model, jstates.params, jdatas)
    _, tdatas = td._train_states_me()
    for t, j in zip(tdatas, jdatas):
        np.testing.assert_allclose(t.labels.numpy(), np.asarray(j.labels), atol=1e-6)
    tlabels = torch.stack([d.labels for d in tdatas])
    tref = tacq.get_reference_point(tlabels, tdatas[0].row_mask)
    np.testing.assert_allclose(tref.numpy(), np.asarray(ref), rtol=_RTOL)
    tall = td._all_points_data(1)
    want, got = [], []
    for seed in (7, 8, 9, 10):
        key = jax.random.PRNGKey(seed)
        jresult, jaux = jucb._suggest_batch(
            jd._model, jd._vec_opt, jstates, jd._all_points_data(1), labels_mn,
            jdatas[0].row_mask, ref, jd._prior_features(jdatas[0]), key, jnp.asarray(True),
            jnp.asarray(True), 1, jd.config, True, None, None,
        )
        _, _, w_key, _ = jax.random.split(key, 4)
        weights = _t(_jax_directions(w_key, jd.config.num_scalarizations, 2))
        monkeypatch.setattr(tucb.pareto_ops, "draw_directions", lambda *args, w=weights: w)
        tresult, aux = tucb._suggest_batch(
            td._vec_opt, tstates, tall, tbandit._prior_features_from_data(tdatas[0]),
            torch.Generator().manual_seed(seed), True, True, 1, td.config,
            labels_mn=tlabels, labels_mask=tdatas[0].row_mask, ref_point=tref,
        )
        assert bool(aux["use_ucb"][0]) and bool(jaux["use_ucb"][0])
        assert aux["mean"].shape == (1, 2)
        want.append(float(jresult.scores[0]))
        got.append(float(tresult.scores[0]))
        if seed == 7:
            pe_params, _, threshold = tucb._pe_conditioning(tstates, tall, td.config)
            states_all = [td._model.precompute_constrained(p, tall) for p in pe_params]
            inv_w = 1.0 / torch.clamp(weights, min=1e-6)
            hv = (inv_w, tref, tucb._hv_floor(inv_w, tref, tlabels, tdatas[0].row_mask))
            score = tucb._score_fn(tstates, states_all, td.config, torch.tensor(True), threshold,
                                   hv, tacq.TrustRegion.from_data(tall))
            at_jax_pick = score(tk.MixedFeatures(
                _t(jresult.features.continuous[:1]), torch.zeros((1, 0), dtype=torch.int32)))
            np.testing.assert_allclose(float(at_jax_pick[0]), want[-1], rtol=_RTOL)
    assert abs(np.mean(got) - np.mean(want)) <= 0.02 * abs(np.mean(want)), (got, want)


def test_safety_metric_is_left_out_of_the_objectives():
    jd = jucb.VizierGPUCBPEBandit(_problem(jvz, safety=True), use_mesh=False, **_KW)
    td = tucb.VizierGPUCBPEBandit(
        _problem(tvz, safety=True), device="cpu", ard_restarts=2, max_acquisition_evaluations=300)
    assert td._objective_indices() == jd._objective_indices() == [0, 2]
    td.update(tvz.CompletedTrials(_trials(tvz, n=12, safety=True)), tvz.ActiveTrials())
    _assert_valid(td.suggest(2), 2)
    assert len(td._cached_states[1]) == 2


def test_multiobjective_default_stays_exact_past_the_sparse_threshold():
    cfg = dict(sparse_threshold_trials=10, hysteresis_trials=2, num_inducing=8)
    td = tucb.VizierGPUCBPEBandit(
        _problem(tvz), surrogate=tsurrogates.SurrogateConfig(**cfg), device="cpu",
        ard_restarts=2, max_acquisition_evaluations=300)
    td.update(tvz.CompletedTrials(_trials(tvz, n=14)), tvz.ActiveTrials())
    _assert_valid(td.suggest(2), 2)
    assert td.surrogate_mode == "exact" and td.surrogate_counts["sparse_suggests"] == 0
    # The service's configuration, far past its 512-trial threshold.
    service = tucb.VizierGPUCBPEBandit(
        _problem(tvz), surrogate=tsurrogates.SurrogateConfig(), device="cpu")
    service._trials = _trials(tvz, n=600)
    assert not service._sparse_ucb_pe_eligible()
    assert service._refresh_ucb_pe_surrogate_mode() == "exact"


def test_multitask_designer_suggests():
    td = tucb.VizierGPUCBPEBandit(
        _problem(tvz), config=tucb.UCBPEConfig(multitask_type=tucb.MultiTaskType.SEPARABLE),
        device="cpu", ard_restarts=2, max_acquisition_evaluations=300)
    td.update(tvz.CompletedTrials(_trials(tvz, n=12)), tvz.ActiveTrials())
    _assert_valid(td.suggest(2), 2)
    states, _ = td._cached_states
    assert isinstance(states, tmt.MultiTaskGPState)
    assert states.chol.shape[-1] == 2 * 16 and bool(torch.isfinite(states.chol).all())
    assert td.ard_train_counts == {"cold": 1, "warm": 0} and td.warm_start_state() is None


def test_gp_bandit_multiobjective_suggests():
    td = tbandit.VizierGPBandit(
        _problem(tvz), device="cpu", ard_restarts=2, max_acquisition_evaluations=300)
    td.update(tvz.CompletedTrials(_trials(tvz, n=10)))
    suggestions = td.suggest(2)
    assert len(suggestions) == 2
    for s in suggestions:
        assert all(0.0 <= s.parameters.get_value(f"x{j}") <= 1.0 for j in range(_DIM))
        ns = s.metadata.ns("gp_bandit")
        assert ns["acquisition_kind"] == "hv_scalarized_ucb" and np.isfinite(ns["acquisition"])
    assert td.ard_train_counts == {"cold": 1, "warm": 0}


def test_gp_bandit_per_metric_train_keeps_the_best_restart():
    """``_train_gp_per_metric``: each metric's state is the lowest-loss
    restart of its own data, as the JAX package's."""
    datas = [interop.gp_data_from_numpy(d, "cpu") for d in _metric_datas(2)]
    model = tgp.VizierGaussianProcess(num_continuous=3, num_categorical=0, device="cpu")
    states = tbandit._train_gp_per_metric(
        model, tbandit.lbfgs_lib.LbfgsOptimizer(maxiter=5, device="cpu"), datas,
        torch.Generator().manual_seed(0), 3)
    assert len(states) == 2
    for state, data in zip(states, datas):
        assert state.params["amplitude"].shape == (1,)
        assert torch.equal(state.data.row_mask, data.row_mask)
