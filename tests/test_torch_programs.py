"""The port's batched designer programs: slot i of a flush is study i alone.

The contract of the JAX package's ``tests/compute/test_program_parity.py``,
held by the port on the CPU: for each of the four programs (exact and sparse
GP-UCB-PE, exact and sparse GP-bandit), at ``count`` 1 and 5 (5 takes the
two-phase ``first_pick_full`` flow), slot i of
``program.device_program(items, pad_to=4)`` gives study i's sequential
``suggest``: the same picks and the same acquisition values, float for
float. (A study's sequential suggest is its program over one study; the
batch-size-dependent CPU op, the batched matrix-vector ``matmul``, is kept
off the path by ``models.gp.matvec``.)

Then the programs against the JAX package: ``bucket_key`` / unbatchable on
the same designers, and the batched train's NLL (exact and sparse) and warm
seeds at the same parameters. Cheap settings throughout: 3-D, 2 restarts,
200 acquisition evaluations.
"""

from __future__ import annotations

import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu import types as jtypes
from vizier_tpu.compute import registry as jregistry
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.models import gp as jgp
from vizier_tpu.surrogates import config as jconfig
from vizier_tpu.surrogates import sparse_gp as jsparse
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch import types as ttypes
from vizier_tpu_torch.compute import registry as tregistry
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.surrogates import config as tconfig
from vizier_tpu_torch.surrogates import sparse_gp as tsparse

_STUDIES = 3
_KW = dict(ard_restarts=2, max_acquisition_evaluations=200)
# Studies of 24-26 trials: one 32-row bucket; the sparse threshold (20) puts
# them on the sparse programs, with 8 inducing points.
_SPARSE = dict(sparse_threshold_trials=20, hysteresis_trials=4, num_inducing=8)


def _problem(vz, categorical=False):
    p = vz.ProblemStatement()
    for j in range(3):
        p.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    if categorical:
        p.search_space.root.add_categorical_param("c", ["a", "b", "c"])
    p.metric_information.append(vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _trials(vz, seed, n, categorical=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(size=3)
        params = {f"x{j}": float(x[j]) for j in range(3)}
        if categorical:
            params["c"] = "abc"[int(rng.integers(3))]
        t = vz.Trial(id=i + 1, parameters=params)
        t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.5) ** 2) + 0.1 * rng.normal())}))
        out.append(t)
    return out


_KINDS = {
    "gp_ucb_pe": (tucb.VizierGPUCBPEBandit, {}),
    "gp_ucb_pe_sparse": (tucb.VizierGPUCBPEBandit, dict(surrogate=tconfig.SurrogateConfig(**_SPARSE))),
    "gp_bandit": (tbandit.VizierGPBandit, {}),
    "gp_bandit_sparse": (tbandit.VizierGPBandit, dict(surrogate=tconfig.SurrogateConfig(**_SPARSE))),
}


def _designer(kind, study, categorical=False):
    cls, extra = _KINDS[kind]
    d = cls(_problem(tvz, categorical), device="cpu", rng_seed=study, **_KW, **extra)
    d.update(tvz.CompletedTrials(_trials(tvz, study, 24 + study, categorical)))
    return d


def _values(suggestions, ns):
    return [(s.parameters.as_dict(), s.metadata.ns(ns)["acquisition"]) for s in suggestions]


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_slot_i_of_a_flush_equals_study_i_alone(kind, count):
    ns = "gp_ucb_pe" if kind.startswith("gp_ucb_pe") else "gp_bandit"
    categorical = kind == "gp_ucb_pe"
    alone = [_designer(kind, s, categorical) for s in range(_STUDIES)]
    want = [_values(d.suggest(count), ns) for d in alone]
    batched = [_designer(kind, s, categorical) for s in range(_STUDIES)]
    resolved = [tregistry.resolve(d, count) for d in batched]
    program = resolved[0][0]
    assert program.kind == kind
    assert len({key for _, key in resolved}) == 1
    items = [program.prepare(d, count) for d in batched]
    outputs = program.device_program(items, pad_to=4)
    got = [_values(program.finalize(d, i, o), ns) for d, i, o in zip(batched, items, outputs)]
    assert got == want
    for a, b in zip(alone, batched):
        assert a.ard_train_counts == b.ard_train_counts
        assert a.surrogate_counts == b.surrogate_counts
        for k, v in (a.warm_start_state()[0] if ns == "gp_ucb_pe" else a.warm_start_state()).items():
            w = b.warm_start_state()[0] if ns == "gp_ucb_pe" else b.warm_start_state()
            assert torch.equal(v, w[k])


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("kind", ["gp_ucb_pe", "gp_ucb_pe_sparse"])
def test_a_cached_fit_suggests_through_the_study_axis_loop(kind, count, monkeypatch):
    """A second suggest with no new labels reuses the fit (no train, no
    program) and runs the same single-objective loop over a study axis of
    one, seeded from the same stream: after a flush or after a suggest
    alone, study i's next suggest is the same. The multi-objective loop is
    never entered."""
    alone = [_designer(kind, s) for s in range(_STUDIES)]
    for d in alone:
        d.suggest(count)
    batched = [_designer(kind, s) for s in range(_STUDIES)]
    program = tregistry.resolve(batched[0], count)[0]
    items = [program.prepare(d, count) for d in batched]
    for d, i, o in zip(batched, items, program.device_program(items, pad_to=4)):
        program.finalize(d, i, o)

    def multiobjective_only(*args, **kwargs):
        raise AssertionError("a single-objective suggest entered the multi-objective loop")

    monkeypatch.setattr(tucb, "_suggest_batch", multiobjective_only)
    for a, b in zip(alone, batched):
        assert tregistry.resolve(a, count) is None  # the cached fit is unbatchable
        trains = a.ard_train_counts
        want, got = _values(a.suggest(count), "gp_ucb_pe"), _values(b.suggest(count), "gp_ucb_pe")
        assert got == want and len(got) == count
        assert a.ard_train_counts == trains == b.ard_train_counts


def test_a_singleton_through_the_executor_is_the_sequential_path():
    stats = pytypes.SimpleNamespace(counts={}, increment=lambda f, n=1: stats.counts.__setitem__(
        f, stats.counts.get(f, 0) + n))
    executor = batch_executor.BatchExecutor(max_wait_ms=1.0, stats=stats)
    try:
        got = executor.suggest(_designer("gp_ucb_pe", 0), 2)
    finally:
        executor.close()
    want = _designer("gp_ucb_pe", 0).suggest(2)
    assert _values(got, "gp_ucb_pe") == _values(want, "gp_ucb_pe")
    assert stats.counts == {"batch_flushes": 1}


def _pair(kind_cls, trials, jextra=None, textra=None, **kw):
    """The JAX package's and the port's designer on the same study."""
    jcls, tcls = kind_cls
    jd = jcls(_problem(jvz), use_mesh=False, **_KW, **(jextra or {}), **kw)
    td = tcls(_problem(tvz), device="cpu", **_KW, **(textra or {}), **kw)
    if trials:
        jd.update(jvz.CompletedTrials(_trials(jvz, 0, trials)), jvz.ActiveTrials())
        td.update(tvz.CompletedTrials(_trials(tvz, 0, trials)), tvz.ActiveTrials())
    return jd, td


def _key_fields(key):
    if key is None:
        return None
    fields = (key.kind, key.pad_trials, key.cont_width, key.cat_width, key.metric_count, key.count)
    # GP-UCB-PE's first static is the all-points rows' padded size.
    return fields + ((key.statics[0],) if key.kind.startswith("gp_ucb_pe") else ())


_UCB = (jucb.VizierGPUCBPEBandit, tucb.VizierGPUCBPEBandit)
_BANDIT = (jbandit.VizierGPBandit, tbandit.VizierGPBandit)


@pytest.mark.parametrize("case", [
    "ucb_seeding", "ucb_exact", "ucb_sparse", "ucb_cached_fit", "bandit_seeding", "bandit_exact",
    "bandit_sparse",
])
def test_bucket_keys_match_the_jax_package(case):
    family, stage = case.split("_", 1)
    classes = _UCB if family == "ucb" else _BANDIT
    sparse = stage == "sparse"
    extras = dict(
        jextra=dict(surrogate=jconfig.SurrogateConfig(**_SPARSE)) if sparse else None,
        textra=dict(surrogate=tconfig.SurrogateConfig(**_SPARSE)) if sparse else None,
    )
    jd, td = _pair(classes, 0 if stage == "seeding" else (24 if sparse else 12), **extras)
    if stage == "cached_fit":
        jd.suggest(1)
        td.suggest(1)
    for count in (1, 3):
        jres = jregistry.resolve(jd, count)
        tres = tregistry.resolve(td, count)
        assert _key_fields(tres and tres[1]) == _key_fields(jres and jres[1])


def test_multiobjective_studies_are_unbatchable_in_both_packages():
    def problem(vz):
        p = _problem(vz)
        p.metric_information.append(vz.MetricInformation(name="z", goal=vz.ObjectiveMetricGoal.MINIMIZE))
        return p

    for jcls, tcls in (_UCB, _BANDIT):
        jd, td = jcls(problem(jvz), use_mesh=False), tcls(problem(tvz), device="cpu")
        assert jregistry.resolve(jd, 2) is None and tregistry.resolve(td, 2) is None


def _stacked_data(n_pad=32):
    """Three studies' model data in both packages, and the port's stacked
    ``GPData`` (one study axis)."""
    jdatas, tmds = [], []
    for s in range(_STUDIES):
        rng = np.random.default_rng(s)
        n = 24 + 2 * s
        x = rng.uniform(size=(n, 3)).astype(np.float32)
        y = (np.sin(3 * x).sum(-1) + 0.1 * rng.normal(size=n)).astype(np.float32)
        for pkg, out in ((jtypes, jdatas), (ttypes, tmds)):
            md = pkg.ModelData(
                pkg.ContinuousAndCategorical(
                    pkg.PaddedArray.from_array(x, (n_pad, 3)),
                    pkg.PaddedArray.from_array(np.zeros((n, 0), np.int32), (n_pad, 0), fill_value=0),
                ),
                pkg.PaddedArray.from_array(y[:, None], (n_pad, 1), fill_value=np.nan),
            )
            out.append(jgp.GPData.from_model_data(md) if pkg is jtypes else md)
    tdata = tgp.GPData.from_model_data(batch_executor.stack_pytrees(tmds), torch.device("cpu"))
    jdata = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jdatas)
    return jdata, tdata


def _params(members, seed=7):
    """Moderately conditioned parameters: amplitude²/noise² ≤ 44. Far past
    that the collapsed bound's trace term, n·amp²/σ² − ΣA², cancels two
    numbers of ~6 000 in float32 and the two packages' NLLs part by ~1e-3,
    as a study alone shows in either of them."""
    rng = np.random.default_rng(seed)
    return {
        "amplitude": rng.uniform(0.5, 1.0, members).astype(np.float32),
        "noise_stddev": rng.uniform(0.15, 0.3, members).astype(np.float32),
        "continuous_length_scales": rng.uniform(0.2, 1.5, (members, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("sparse", [False, True])
def test_batched_train_nll_matches_the_jax_package(sparse):
    """S studies × E restarts of the port's grouped NLL (the loss one
    L-BFGS batch minimizes in a flush) against the JAX NLL vmapped over
    studies and restarts, at the same parameters."""
    jdata, tdata = _stacked_data()
    restarts = 2
    jmodel = jgp.VizierGaussianProcess(num_continuous=3, num_categorical=0)
    tmodel = tgp.VizierGaussianProcess(num_continuous=3, num_categorical=0, device="cpu")
    coll = jmodel.param_collection()
    unconstrained = {k: np.asarray(v) for k, v in coll.unconstrain(_params(_STUDIES * restarts)).items()}
    per_study = {k: v.reshape(_STUDIES, restarts, *v.shape[1:]) for k, v in unconstrained.items()}
    if sparse:
        jsm = jsparse.SparseGaussianProcess(base=jmodel, num_inducing=8)
        tsm = tsparse.SparseGaussianProcess(base=tmodel, num_inducing=8)
        jsdata = jax.vmap(lambda d: jsparse.select_inducing_kcenter(d, 8))(jdata)
        tsdata = tsparse.select_inducing_kcenter(tdata, 8)
        np.testing.assert_array_equal(tsdata.inducing_indices.numpy(), np.asarray(jsdata.inducing_indices))
        jloss, data_j, data_t, tloss = jsm.neg_log_likelihood, jsdata, tsdata, tsm.neg_log_likelihood
    else:
        jloss, data_j, data_t, tloss = jmodel.neg_log_likelihood, jdata, tdata, tmodel.neg_log_likelihood
    want = np.asarray(jax.vmap(lambda p, d: jax.vmap(lambda q: jloss(q, d))(p))(per_study, data_j))
    got = tloss({k: torch.tensor(v) for k, v in unconstrained.items()}, data_t).numpy()
    if not sparse:
        np.testing.assert_allclose(got, want.reshape(-1), rtol=1e-5)
        return
    # The collapsed bound sums terms ~20x its value that cancel: each float32
    # NLL lies ~5e-6 from the float64 one, in either package, and the two
    # part by up to twice that. Both are held to the float64 NLL.
    exact = tloss(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in unconstrained.items()},
        batch_executor.tree_map(lambda t: t.double() if t.is_floating_point() else t, data_t),
    ).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5)
    np.testing.assert_allclose(want.reshape(-1), exact, rtol=1e-5)
    np.testing.assert_allclose(got, want.reshape(-1), rtol=2e-5)


def test_warm_seeds_match_the_jax_package():
    """Each study's next warm seed: its best member's params, unconstrained
    (the JAX package's ``_warm_next_batched`` at the same states)."""
    ensemble = 2
    constrained = _params(_STUDIES * ensemble, seed=9)
    jmodel = jgp.VizierGaussianProcess(num_continuous=3, num_categorical=0)
    tmodel = tgp.VizierGaussianProcess(num_continuous=3, num_categorical=0, device="cpu")
    jstates = pytypes.SimpleNamespace(params={
        k: jnp.asarray(v.reshape(_STUDIES, ensemble, *v.shape[1:])) for k, v in constrained.items()})
    tstates = pytypes.SimpleNamespace(params={k: torch.tensor(v) for k, v in constrained.items()})
    want = jbandit._warm_next_batched(jmodel, jstates)
    got = tbandit._warm_next_batched(tmodel, tstates, _STUDIES)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5)


def test_to_host_packs_every_leaf_into_one_copy():
    tree = dict(
        f=torch.arange(6, dtype=torch.float32).reshape(2, 3), b=torch.tensor([True, False]),
        i=torch.tensor([[7]], dtype=torch.int64), s=torch.tensor(2.5), n=np.zeros(2), k="static",
    )
    host = batch_executor.to_host(tree)
    for k in ("f", "b", "i", "s"):
        assert host[k] is not tree[k] and torch.equal(host[k], tree[k]) and host[k].dtype == tree[k].dtype
    assert host["n"] is tree["n"] and host["k"] == "static"


def test_stack_and_slice_pad_with_slot_zero():
    trees = [dict(a=np.full(2, s), t=torch.full((2,), float(s))) for s in range(3)]
    stacked = batch_executor.stack_pytrees(trees, pad_to=5)
    assert stacked["a"].shape == (5, 2) and stacked["t"].shape == (5, 2)
    assert list(stacked["a"][:, 0]) == [0, 1, 2, 0, 0]
    assert torch.equal(batch_executor.slice_pytree(stacked, 1)["t"], trees[1]["t"])
