"""The GP designers on a mesh: counterparts of the JAX package's
``tests/parallel/test_designer_mesh.py`` on the port's 8 CPU entries
(``torch_mesh_devices``), beside the JAX package's designers on its 8
virtual devices.

The two packages draw different random numbers (ROADMAP C4), so a whole
mesh suggest is held where the JAX package's test holds its own: near the
objective's optimum and near the single-device suggest, and near the JAX
package's mesh suggest on the same study. The UCB-PE pick loop on a mesh is
held to the JAX package's numerically: both run the JAX-trained posterior,
the port's pools fed the JAX package's per-pick pool draws (and HV
directions) through a random-strategy sweep, as ``test_torch_sharding``
feeds the sharded sweep.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_sharding as sharding
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu import parallel as jparallel
from vizier_tpu import pyvizier as jvz
from vizier_tpu.algorithms import core as jcore
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import multitask_gp as jmtgp
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.optimizers import vectorized as jvec
from vizier_tpu_torch import interop
from vizier_tpu_torch import parallel
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import core as tcore
from vizier_tpu_torch.compute import registry
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.models import multitask_gp
from vizier_tpu_torch.optimizers import eagle
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.optimizers import vectorized
from vizier_tpu_torch.parallel import batch_executor as tbatch
from vizier_tpu_torch.surrogates import config as surrogate_config

_OPTIMUM = np.array([0.62, 0.31])


@pytest.fixture
def eight(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch)


def _problem(vz, metrics=("obj",)):
    p = vz.ProblemStatement()
    p.search_space.root.add_float_param("x", 0.0, 1.0)
    p.search_space.root.add_float_param("y", 0.0, 1.0)
    for name in metrics:
        p.metric_information.append(
            vz.MetricInformation(name=name, goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _trials(vz, n=12, seed=0, metrics=("obj",)):
    """The JAX test's studies: a peaked objective, or its two-metric one
    (the second metric 0.8 of the first plus noise)."""
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(n):
        x, y = rng.uniform(), rng.uniform()
        base = -((x - 0.62) ** 2) - (y - 0.31) ** 2
        values = {metrics[0]: base}
        if len(metrics) > 1:
            values[metrics[1]] = 0.8 * base + 0.01 * rng.normal()
        t = vz.Trial(id=i + 1, parameters={"x": float(x), "y": float(y)})
        t.complete(vz.Measurement(metrics=values))
        trials.append(t)
    return trials


def _suggest_xy(designer, vz, core, count=1, **trial_kw):
    designer.update(core.CompletedTrials(_trials(vz, **trial_kw)))
    return np.array([[float(s.parameters["x"].value), float(s.parameters["y"].value)]
                     for s in designer.suggest(count)])


def _kw(**extra):
    return dict(dict(ard_restarts=8, max_acquisition_evaluations=2000, num_seed_trials=2,
                     rng_seed=3), **extra)


def _port(cls, use_mesh, **extra):
    return cls(_problem(tvz, extra.pop("metrics", ("obj",))), use_mesh=use_mesh, device="cpu",
               ard_optimizer=tlbfgs.LbfgsOptimizer(maxiter=25, device="cpu"), **_kw(**extra))


def _jax(cls, use_mesh, **extra):
    return cls(_problem(jvz, extra.pop("metrics", ("obj",))), use_mesh=use_mesh,
               ard_optimizer=jlbfgs.LbfgsOptimizer(maxiter=25), **_kw(**extra))


def test_the_gp_bandit_builds_a_mesh_on_its_own(eight, monkeypatch):
    monkeypatch.delenv("VIZIER_TORCH_DISABLE_MESH", raising=False)
    d = tbandit.VizierGPBandit(_problem(tvz), device="cpu")
    assert d._mesh is not None and d._mesh.size == 8 and d._mesh_size() == 8
    monkeypatch.setenv("VIZIER_TORCH_DISABLE_MESH", "1")
    assert tbandit.VizierGPBandit(_problem(tvz), device="cpu")._mesh is None


def test_one_device_builds_no_mesh_unless_asked():
    """The CPU (or one card) is one device: no auto-mesh; ``use_mesh=True``
    builds a mesh of that one device, one pool and restarts unrounded."""
    assert tbandit.VizierGPBandit(_problem(tvz), device="cpu")._mesh is None
    d = tbandit.VizierGPBandit(_problem(tvz), device="cpu", use_mesh=True)
    assert d._mesh.devices == (torch.device("cpu"),) and d._mesh_restarts(5) == 5


def test_a_mesh_suggest_lands_with_the_single_device_and_the_jax_mesh_suggests(eight):
    single = _suggest_xy(_port(tbandit.VizierGPBandit, False), tvz, tcore)[0]
    meshed_designer = _port(tbandit.VizierGPBandit, True)
    assert meshed_designer._mesh.size == 8
    meshed = _suggest_xy(meshed_designer, tvz, tcore)[0]
    reference_designer = _jax(jbandit.VizierGPBandit, True)
    assert len(reference_designer._mesh.devices.flat) == 8
    reference = _suggest_xy(reference_designer, jvz, jcore)[0]
    for name, xy in (("single", single), ("mesh", meshed), ("jax mesh", reference)):
        assert np.linalg.norm(xy - _OPTIMUM) < 0.25, (name, xy)
    assert np.linalg.norm(single - meshed) < 0.3
    assert np.linalg.norm(meshed - reference) < 0.3


_PICKS = 2
_POOL_EVALS, _POOL_SIZE = 160, 16


def _fed_pick_pools(monkeypatch, key, count, dc):
    """The JAX package's pick loop splits ``rng, _, w_key, opt_key`` per pick
    and ``opt_key`` once per pool. Both packages get a random-strategy sweep;
    the port's pick ``b`` gets pools seeded ``8b + i``, pool ``i`` fed the
    draws of the JAX package's ``i``-th key of that pick. Returns the two
    optimizers and each pick's direction key."""
    rng, draws, w_keys = key, {}, []
    for b in range(count):
        rng, _, w_key, opt_key = jax.random.split(rng, 4)
        w_keys.append(w_key)
        for i, k in enumerate(jax.random.split(opt_key, 8)):
            draws[8 * b + i] = sharding._random_sweep_draws(
                k, _POOL_EVALS // _POOL_SIZE, _POOL_SIZE, dc, 0)
    picks = iter(range(count))

    def pool_generators(generator, num_pools, mesh):
        del generator, mesh
        b = next(picks)
        return [torch.Generator().manual_seed(8 * b + i) for i in range(num_pools)]

    monkeypatch.setattr(parallel, "pool_generators", pool_generators)
    kw = dict(num_continuous=dc, num_categorical=0, category_sizes=(),
              suggestion_batch_size=_POOL_SIZE)
    return (jvec.VectorizedOptimizer(jvec.RandomVectorizedStrategy(**kw),
                                     max_evaluations=_POOL_EVALS),
            vectorized.VectorizedOptimizer(sharding._PoolDraws(draws, **kw),
                                           max_evaluations=_POOL_EVALS, device="cpu"),
            w_keys)


def _jax_directions(key, k, m):
    """The JAX pick loop's HV directions from its ``w_key``."""
    v = jnp.abs(jax.random.normal(key, (k, m), dtype=jnp.float32))
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _coins_fixed(pkg, **kw):
    """UCB on the first pick and PE on the next, in both packages, without
    drawing a coin that could differ."""
    return pkg.UCBPEConfig(pe_overwrite_probability=0.0, ucb_overwrite_probability=0.0, **kw)


def _assert_picks_equal(got, got_aux, want, want_aux):
    """The same picks, bit for bit, their acquisition values within 1e-4
    relative, UCB then PE in both."""
    np.testing.assert_array_equal(got.features.continuous.numpy(),
                                  np.asarray(want.features.continuous))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    assert got_aux["use_ucb"].reshape(-1).tolist() == [True] + [False] * (_PICKS - 1)
    assert np.asarray(want_aux["use_ucb"]).reshape(-1).tolist() == [True] + [False] * (_PICKS - 1)


def test_ucb_pe_runs_on_the_mesh_as_the_jax_package(eight, monkeypatch):
    """The port's mesh UCB-PE serves a valid exact batch; its pick loop over
    8 pools per pick (``_suggest_batch_studies`` → ``_sweep_one_study``) gives
    the JAX package's ``_suggest_batch`` picks on its mesh, at the JAX-trained
    posterior with the JAX package's pool draws fed in."""
    kw = dict(max_acquisition_evaluations=600)
    port = _port(tucb.VizierGPUCBPEBandit, True, config=tucb.UCBPEConfig(num_scalarizations=16),
                 **kw)
    assert port._mesh is not None
    got = _suggest_xy(port, tvz, tcore, count=3)
    assert got.shape == (3, 2) and np.all((0.0 <= got) & (got <= 1.0))
    assert np.unique(np.round(got, 3), axis=0).shape[0] == 3
    # A mesh designer takes no batched program and stays exact.
    assert registry.resolve(port, 3) is None
    assert not port._sparse_ucb_pe_eligible()

    jd = _jax(jucb.VizierGPUCBPEBandit, False, **kw)
    jd.update(jcore.CompletedTrials(_trials(jvz)))
    jstates, jdatas = jd._train_states_me()
    jall = jd._all_points_data(_PICKS)
    key = jax.random.PRNGKey(7)
    jopt, topt, _ = _fed_pick_pools(monkeypatch, key, _PICKS, jall.continuous.shape[-1])
    want, want_aux = jucb._suggest_batch(
        jd._model, jopt, jstates, jall, jnp.stack([d.labels for d in jdatas]),
        jdatas[0].row_mask, jnp.zeros(1), None, key, jnp.asarray(True), jnp.asarray(True),
        _PICKS, _coins_fixed(jucb), True, jparallel.create_mesh(), None)
    one = lambda tree: tbatch.stack_pytrees([tree])  # noqa: E731
    tdata = interop.gp_data_from_numpy(jdatas[0], "cpu")
    tstate = port._model.precompute_constrained(interop.gp_params_from_numpy(
        {k: np.asarray(v)[0] for k, v in jstates.params.items()}, "cpu"), tdata)
    got, got_aux = tucb._suggest_batch_studies(
        topt, dataclasses.replace(tstate, data=one(tdata)),
        one(interop.gp_data_from_numpy(jall, "cpu")), None, [torch.Generator().manual_seed(0)],
        torch.tensor([True]), torch.tensor([True]), _PICKS, _coins_fixed(tucb),
        mesh=port._mesh)
    _assert_picks_equal(tbatch.slice_pytree(got, 0), tbatch.slice_pytree(got_aux, 0), want,
                        want_aux)


def test_mesh_restarts_round_up_and_the_warm_seed_replaces_restart_zero(eight, monkeypatch):
    """5 restarts on 8 devices train 8 rows (the JAX designer's rounding);
    the warm seed takes row 0 rather than adding a ninth."""
    d = _port(tbandit.VizierGPBandit, True, ard_restarts=5, warm_start_min_trials=0)
    assert d._mesh_restarts(d.ard_restarts) == 8
    reference = _jax(jbandit.VizierGPBandit, True, ard_restarts=5)
    ndev = reference._mesh_size()
    assert -(-reference.ard_restarts // ndev) * ndev == 8
    calls = []
    real = parallel.train_gp_sharded

    def recording(model, optimizer, data, generator, num_restarts, ensemble_size, mesh,
                  warm_start=None, **kw):
        calls.append((num_restarts, warm_start is not None))
        return real(model, optimizer, data, generator, num_restarts, ensemble_size, mesh,
                    warm_start, **kw)

    monkeypatch.setattr(parallel, "train_gp_sharded", recording)
    _suggest_xy(d, tvz, tcore)
    assert calls == [(8, True)]
    assert d.ard_train_counts == {"warm": 0, "cold": 1}
    assert d.warm_start_state() is not None


def _mt_designer(port: bool, use_mesh: bool):
    kw = dict(max_acquisition_evaluations=600, rng_seed=5, metrics=("m1", "m2"))
    if port:
        return _port(tucb.VizierGPUCBPEBandit, use_mesh, config=tucb.UCBPEConfig(
            multitask_type=multitask_gp.MultiTaskType.SEPARABLE, num_scalarizations=16), **kw)
    return _jax(jucb.VizierGPUCBPEBandit, use_mesh, config=jucb.UCBPEConfig(
        multitask_type=jmtgp.MultiTaskType.SEPARABLE, num_scalarizations=16), **kw)


def test_separable_multitask_suggests_on_the_mesh(eight, monkeypatch):
    """The SEPARABLE multi-task mesh designer serves a valid batch; its
    HV-scalarized pick loop over 8 pools per pick (``_suggest_batch``) gives
    the JAX package's picks on its mesh, at the JAX-trained joint posterior
    with the JAX package's pool draws and directions fed in."""
    port, reference = _mt_designer(True, True), _mt_designer(False, False)
    got = _suggest_xy(port, tvz, tcore, count=3, n=10, metrics=("m1", "m2"))
    assert got.shape == (3, 2) and np.all((0.0 <= got) & (got <= 1.0))
    states, _ = port._train_states_me()
    assert isinstance(states, multitask_gp.MultiTaskGPState)

    reference.update(jcore.CompletedTrials(_trials(jvz, n=10, metrics=("m1", "m2"))))
    jstates, jdatas = reference._train_states_me()
    assert isinstance(jstates, jmtgp.MultiTaskGPState)
    feats = reference._all_points_data(_PICKS)
    jall = jmtgp.MultiTaskData(
        features_data=feats, task_labels=jnp.zeros((2,) + feats.labels.shape, jnp.float32),
        task_mask=jnp.tile(feats.row_mask[None, :], (2, 1)))
    labels_mn = jnp.stack([d.labels for d in jdatas])
    ref_point = jacq.get_reference_point(labels_mn, jdatas[0].row_mask)
    key = jax.random.PRNGKey(8)
    jopt, topt, w_keys = _fed_pick_pools(monkeypatch, key, _PICKS, feats.continuous.shape[-1])
    mt = dict(multitask_type=jmtgp.MultiTaskType.SEPARABLE, num_scalarizations=16)
    want, want_aux = jucb._suggest_batch(
        reference._mt_model(2), jopt, jstates, jall, labels_mn, jdatas[0].row_mask, ref_point,
        None, key, jnp.asarray(True), jnp.asarray(True), _PICKS, _coins_fixed(jucb, **mt),
        True, jparallel.create_mesh(), None)

    directions = iter([torch.tensor(np.asarray(_jax_directions(k, 16, 2))) for k in w_keys])
    monkeypatch.setattr(tucb.pareto_ops, "draw_directions", lambda *args: next(directions))
    tmodel = port._mt_model(2)
    tstates = tmodel.precompute_constrained(
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in jstates.params.items()},
                                     "cpu"),
        interop.multitask_data_from_numpy(jmtgp.MultiTaskData.from_gp_datas(tuple(jdatas)),
                                          "cpu"))
    tlabels = torch.tensor(np.asarray(labels_mn))
    got, got_aux = tucb._suggest_batch(
        topt, tstates, interop.multitask_data_from_numpy(jall, "cpu"), None,
        torch.Generator().manual_seed(0), True, True, _PICKS,
        _coins_fixed(tucb, multitask_type=multitask_gp.MultiTaskType.SEPARABLE,
                     num_scalarizations=16),
        labels_mn=tlabels, labels_mask=torch.tensor(np.asarray(jdatas[0].row_mask)),
        ref_point=torch.tensor(np.asarray(ref_point)), mesh=port._mesh)
    _assert_picks_equal(got, got_aux, want, want_aux)


def test_the_sharded_joint_train_equals_the_unsharded_one(eight):
    """The same seed stream, 8 restarts on 8 devices: the sharded multi-task
    train selects what the unsharded one selects (the JAX test holds its
    packages' pair to rtol 0.1; the port's split is exact on the CPU)."""
    meshed, plain = _mt_designer(True, True), _mt_designer(True, False)
    for d in (meshed, plain):
        d.update(tcore.CompletedTrials(_trials(tvz, n=10, metrics=("m1", "m2"))))
    sharded, _ = meshed._train_states_me()
    unsharded, _ = plain._train_states_me()
    for k, v in unsharded.params.items():
        torch.testing.assert_close(sharded.params[k], v, rtol=1e-5, atol=1e-6)


def test_mesh_qei_batch_is_valid_and_distinct(eight):
    d = _port(tbandit.VizierGPBandit, True, rng_seed=5, ard_restarts=2,
              max_acquisition_evaluations=300, acquisition="qei")
    d._ard = tlbfgs.LbfgsOptimizer(maxiter=10, device="cpu")
    pts = _suggest_xy(d, tvz, tcore, count=3)
    assert pts.shape == (3, 2) and np.all((0.0 <= pts) & (pts <= 1.0))
    assert np.unique(np.round(pts, 3), axis=0).shape[0] > 1


def test_mesh_qei_merge_is_the_best_over_its_pools(eight):
    """The mechanism joint qEI rides: a deterministic score over the
    flattened (q·D)-space, the sharded result the best of its pools."""
    q, dc = 2, 2
    target = torch.tensor([0.2, 0.8, 0.7, 0.3])

    def score_fn(feats):
        return -torch.sum((feats.continuous - target) ** 2, dim=-1)

    vec = vectorized.VectorizedOptimizer(
        eagle.VectorizedEagleStrategy(num_continuous=q * dc, category_sizes=()),
        max_evaluations=300, device="cpu")
    mesh = parallel.create_mesh(device="cpu")
    generators = parallel.pool_generators(9, mesh.size, mesh)
    sharded = parallel.maximize_score_fn_sharded(vec, score_fn, generators, 1, mesh.size, mesh)
    seeds = [g.initial_seed() for g in generators]
    pool_best = [float(vec(score_fn, torch.Generator().manual_seed(s), count=1).scores[0])
                 for s in seeds]
    assert float(sharded.scores[0]) == pytest.approx(max(pool_best), rel=1e-6)
    np.testing.assert_allclose(sharded.features.continuous[0].numpy(), target.numpy(), atol=0.1)


def test_a_mesh_bandit_serves_its_sparse_suggest_on_one_device(eight):
    """As the JAX package's: past the threshold the mesh bandit trains the
    sparse surrogate, unsharded; the sharded train never runs."""
    cfg = surrogate_config.SurrogateConfig(sparse=True, sparse_threshold_trials=16, num_inducing=8)
    d = _port(tbandit.VizierGPBandit, True, surrogate=cfg, max_acquisition_evaluations=200)
    d.update(tcore.CompletedTrials(_trials(tvz, n=24)))
    suggestions = d.suggest(1)
    assert d.surrogate_mode == surrogate_config.MODE_SPARSE
    assert d.surrogate_counts["sparse_suggests"] == 1 and len(suggestions) == 1
    assert registry.resolve(d, 1) is None
