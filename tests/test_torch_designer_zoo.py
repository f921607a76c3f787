"""The port's designer zoo against the JAX package's, on the CPU.

- Host designers (Eagle, CMA-ES, BOCS in its surrogate/optimizer modes,
  Harmonica with and without the lasso, PyCMAES's protocol through an
  injected module): the same seed over several rounds of suggest/update on
  the same completed trials gives the same parameters, value for value
  (tolerance: none).
- NSGA2: the nondomination layers and crowding distances of seeded float32
  populations (ties and non-finite rows included) are bit-identical, and so
  is the surviving order; the designer's suggestions over ten generations of
  ZDT1 are identical; state dumped by either package (with and without
  ``num_suggested``) restores in the other with identical next suggestions.
- Scalarizations: bit-identical float32 values; ``random_hv_directions``
  with the JAX package's normals fed in within 1e-7.
- Wrappers: the scalarized, unsafe-as-infeasible and scheduled rewrites are
  identical; with the GP bandit inside (``AdamOptimizer(maxiter=10)``, 4-D,
  16 trials), the inner designer's suggestion has the reference's kind, and
  its posterior at the JAX package's trained parameters gives the JAX
  package's samples within rtol 1e-4 / atol 1e-4 (the GP designer tests'
  tolerance): the inner GP sees the same data.
"""

from __future__ import annotations

import json
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.algorithms import core as jcore
from vizier_tpu.benchmarks.experimenters.synthetic import multiobjective as jmo
from vizier_tpu.designers import bocs as jbocs
from vizier_tpu.designers import cmaes as jcmaes
from vizier_tpu.designers import eagle_strategy as jeagle
from vizier_tpu.designers import evolution as jevolution
from vizier_tpu.designers import gp_bandit as jbandit
from vizier_tpu.designers import harmonica as jharmonica
from vizier_tpu.designers import pycmaes as jpycmaes
from vizier_tpu.designers import scalarization as jscal
from vizier_tpu.designers import scalarizing_designer as jscalarizing
from vizier_tpu.designers import scheduled_designer as jscheduled
from vizier_tpu.designers import unsafe_as_infeasible_designer as junsafe
from vizier_tpu.ops import pareto as jpareto
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import core as tcore
from vizier_tpu_torch.benchmarks.experimenters.synthetic import multiobjective as tmo
from vizier_tpu_torch.designers import bocs as tbocs
from vizier_tpu_torch.designers import cmaes as tcmaes
from vizier_tpu_torch.designers import eagle_strategy as teagle
from vizier_tpu_torch.designers import evolution as tevolution
from vizier_tpu_torch.designers import gp_bandit as tbandit
from vizier_tpu_torch.designers import harmonica as tharmonica
from vizier_tpu_torch.designers import pycmaes as tpycmaes
from vizier_tpu_torch.designers import scalarization as tscal
from vizier_tpu_torch.designers import scalarizing_designer as tscalarizing
from vizier_tpu_torch.designers import scheduled_designer as tscheduled
from vizier_tpu_torch.designers import unsafe_as_infeasible_designer as tunsafe
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs

_SIDES = {"jax": (jvz, jcore), "port": (tvz, tcore)}


def _values(suggestions):
    return [s.parameters.as_dict() for s in suggestions]


def _float_problem(vz, dim, metric="obj", goal="MINIMIZE"):
    p = vz.ProblemStatement()
    for j in range(dim):
        p.search_space.root.add_float_param(f"x{j}", -5.0, 5.0)
    p.metric_information.append(vz.MetricInformation(
        name=metric, goal=getattr(vz.ObjectiveMetricGoal, goal)))
    return p


def _mixed_problem(vz):
    p = vz.ProblemStatement()
    p.search_space.root.add_float_param("x", 0.0, 1.0)
    p.search_space.root.add_float_param("lr", 1e-4, 1.0, scale_type=vz.ScaleType.LOG)
    p.search_space.root.add_categorical_param("c", ["a", "b", "z"])
    p.search_space.root.add_int_param("i", 1, 4)
    p.metric_information.append(vz.MetricInformation(
        name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _binary_problem(vz, dim):
    p = vz.ProblemStatement()
    for i in range(dim):
        p.search_space.root.add_bool_param(f"b{i}")
    p.metric_information.append(vz.MetricInformation(
        name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _objective(params) -> float:
    """A deterministic value of any of this file's parameter dicts."""
    total = 0.0
    for k, v in sorted(params.items()):
        if isinstance(v, str):
            total += {"a": 0.3, "b": -0.2, "z": 0.1, "True": 1.0, "False": 0.0}[v]
        else:
            total += -(float(v) - 0.4) ** 2 * (1.0 + len(k) % 3)
    return total


def _complete(vz, suggestions, start, metric="obj", value=None):
    trials = []
    for i, s in enumerate(suggestions):
        t = s.to_trial(start + i)
        v = _objective(t.parameters.as_dict()) if value is None else value
        t.complete(vz.Measurement(metrics={metric: v}))
        trials.append(t)
    return trials


def _lockstep(make, rounds, count, metric="obj", value=None):
    """Both packages' designers through the same suggest/update rounds:
    the suggestions (and their metadata) of each round must be identical."""
    designers = {side: make(vz) for side, (vz, _) in _SIDES.items()}
    tid = 1
    for _ in range(rounds):
        out = {}
        for side, (vz, core) in _SIDES.items():
            suggestions = designers[side].suggest(count)
            out[side] = (_values(suggestions),
                         [dict(s.metadata.ns("eagle").items()) for s in suggestions])
            designers[side].update(core.CompletedTrials(
                _complete(vz, suggestions, tid, metric, value)))
        assert out["port"] == out["jax"]
        tid += count
    return designers


# -- Eagle ---------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["bbob3d", "mixed"])
def test_eagle_rounds_are_identical(problem):
    make = (lambda vz: _float_problem(vz, 3)) if problem == "bbob3d" else _mixed_problem
    mod = {jvz: jeagle, tvz: teagle}
    d = _lockstep(lambda vz: mod[vz].EagleStrategyDesigner(make(vz), seed=4), rounds=8, count=6)
    # Past the pool's capacity: moves, perturbations and settles ran.
    assert d["port"]._pool.keys() == d["jax"]._pool.keys()
    assert len(d["port"]._pool) == d["port"]._capacity


def test_eagle_many_suggests_before_any_update_are_identical():
    jd = jeagle.EagleStrategyDesigner(_float_problem(jvz, 2), seed=0)
    td = teagle.EagleStrategyDesigner(_float_problem(tvz, 2), seed=0)
    assert _values(td.suggest(td._capacity + 5)) == _values(jd.suggest(jd._capacity + 5))


def test_eagle_pool_refills_after_eviction_identically():
    mod = {jvz: jeagle, tvz: teagle}
    d = _lockstep(lambda vz: mod[vz].EagleStrategyDesigner(
        _float_problem(vz, 2), seed=0, config=mod[vz].FireflyConfig(penalize_factor=0.01)),
        rounds=10, count=4, value=1.0)
    assert _values(d["port"].suggest(3)) == _values(d["jax"].suggest(3))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eagle_state_crosses_packages(writer):
    mod = {"jax": jeagle, "port": teagle}
    vz = _SIDES[writer][0]
    source = mod[writer].EagleStrategyDesigner(_mixed_problem(vz), seed=3)
    tid = 1
    for _ in range(4):
        s = source.suggest(5)
        source.update(_SIDES[writer][1].CompletedTrials(_complete(vz, s, tid)))
        tid += 5
    state = source.dump()["eagle"]
    out = {}
    for side, (rvz, _) in _SIDES.items():
        reader = mod[side].EagleStrategyDesigner(_mixed_problem(rvz), seed=8)
        md = rvz.Metadata()
        md["eagle"] = state
        reader.load(md)
        out[side] = (_values(reader.suggest(6)), reader.dump()["eagle"])
    assert out["port"] == out["jax"]
    assert out["port"][1] == state


# -- NSGA2 -----------------------------------------------------------------------


def _population_points(seed, n, m):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(n, m)).astype(np.float32)
    points[7::7] = points[1:n - 6:7]  # duplicate rows: ties everywhere
    points[:, 0] = np.round(points[:, 0], 1)  # ties within one objective
    points[3, 1] = np.nan
    points[5] = -np.inf
    points[11, 0] = np.inf
    return points


def _jax_ranking(objectives):
    points = np.asarray(objectives, dtype=np.float32)
    finite = np.all(np.isfinite(points), axis=1)
    points = np.where(finite[:, None], points, -1e30)
    layers = np.asarray(jpareto.nondomination_layers(points))
    crowding = np.asarray(jpareto.crowding_distance(points, layers))
    return layers, crowding


@pytest.mark.parametrize("seed,n,m", [(0, 40, 2), (1, 64, 3), (2, 17, 4), (3, 120, 2)])
def test_nsga2_layers_crowding_and_survival_order_are_bit_identical(seed, n, m):
    objectives = _population_points(seed, n, m).astype(np.float64)
    want_layers, want_crowding = _jax_ranking(objectives)
    layers, crowding = tevolution.survival_ranking(objectives, torch.device("cpu"))
    np.testing.assert_array_equal(layers, want_layers)
    assert crowding.dtype == want_crowding.dtype == np.float32
    assert crowding.tobytes() == want_crowding.tobytes()
    assert np.isinf(crowding).any() and len(np.unique(layers)) > 2
    rng = np.random.default_rng(seed)
    pops = [cls(continuous=rng.uniform(size=(n, 3)), categorical=np.zeros((n, 1), np.int32),
                objectives=objectives) for cls in (jevolution.Population, tevolution.Population)]
    rng = np.random.default_rng(seed)
    pops[1].continuous = rng.uniform(size=(n, 3))
    want = jevolution.nsga2_survival(pops[0], n // 2)
    got = tevolution.nsga2_survival(pops[1], n // 2, device="cpu")
    assert got.continuous.tobytes() == want.continuous.tobytes()
    assert got.objectives.tobytes() == want.objectives.tobytes()


def _zdt1(vz_mo, dim=6):
    return vz_mo.MultiObjectiveExperimenter.zdt("zdt1", dimension=dim)


def _nsga2_generations(generations, population_size=10, seed=2):
    out, designers = {}, {}
    for side, (vz, core) in _SIDES.items():
        exp = _zdt1(jmo if side == "jax" else tmo)
        kw = {} if side == "jax" else {"device": "cpu"}
        mod = jevolution if side == "jax" else tevolution
        d = mod.NSGA2Designer(exp.problem_statement(), population_size=population_size,
                              seed=seed, **kw)
        rounds, tid = [], 1
        for _ in range(generations):
            trials = [s.to_trial(tid + i) for i, s in enumerate(d.suggest(population_size))]
            tid += len(trials)
            exp.evaluate(trials)
            d.update(core.CompletedTrials(trials))
            rounds.append([t.parameters.as_dict() for t in trials])
        out[side], designers[side] = rounds, d
    return out, designers


def test_nsga2_suggestions_over_ten_generations_of_zdt1_are_identical():
    out, designers = _nsga2_generations(10)
    assert out["port"] == out["jax"]
    assert (designers["port"]._population.objectives.tobytes()
            == designers["jax"]._population.objectives.tobytes())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("with_num_suggested", [True, False])
def test_nsga2_state_crosses_packages(writer, with_num_suggested):
    _, designers = _nsga2_generations(3, population_size=8)
    state = json.loads(designers[writer].dump()["population"])
    if not with_num_suggested:  # an older checkpoint
        del state["num_suggested"]
    text = json.dumps(state)
    out = {}
    for side, (vz, _) in _SIDES.items():
        mod = jevolution if side == "jax" else tevolution
        kw = {} if side == "jax" else {"device": "cpu"}
        reader = mod.NSGA2Designer(_zdt1(jmo if side == "jax" else tmo).problem_statement(),
                                   population_size=8, seed=5, **kw)
        md = vz.Metadata()
        md["population"] = text
        reader.load(md)
        out[side] = (reader._num_suggested, _values(reader.suggest(6)))
    assert out["port"] == out["jax"]
    assert out["port"][0] == (24 if with_num_suggested else 8)


# -- CMA-ES and PyCMAES ------------------------------------------------------------


def test_cmaes_rounds_are_identical():
    mod = {jvz: jcmaes, tvz: tcmaes}
    d = _lockstep(lambda vz: mod[vz].CMAESDesigner(_float_problem(vz, 3), seed=1),
                  rounds=6, count=8)
    assert d["port"]._state.generation == d["jax"]._state.generation > 0
    assert d["port"]._state.cov.tobytes() == d["jax"]._state.cov.tobytes()


def test_cmaes_rejects_categorical_parameters_as_the_reference():
    for mod, vz in ((jcmaes, jvz), (tcmaes, tvz)):
        with pytest.raises(ValueError, match="continuous"):
            mod.CMAESDesigner(_mixed_problem(vz))


def _stub_cma():
    calls = {}

    class FakeEvolution:
        def __init__(self, x0, sigma0, options):
            calls.update(x0=np.array(x0), sigma0=sigma0, options=dict(options))
            self.popsize = options.get("popsize", 4)

        def feed_for_resume(self, features, labels):
            calls.update(features=np.array(features), labels=np.array(labels))

        def ask(self, count):
            return np.random.default_rng(0).uniform(-0.2, 1.2, size=(count, len(calls["x0"])))

    module = types.ModuleType("cma")
    module.CMAEvolutionStrategy = FakeEvolution
    return module, calls


def test_pycmaes_gate_validation_and_protocol_match_the_reference():
    out = {}
    for side, (vz, core) in _SIDES.items():
        mod = jpycmaes if side == "jax" else tpycmaes
        with pytest.raises(ValueError, match="popsize"):
            mod.PyCMAESDesigner(_float_problem(vz, 2), popsize=1)
        with pytest.raises(ValueError, match="continuous"):
            mod.PyCMAESDesigner(_mixed_problem(vz))
        with pytest.raises(ImportError, match="pycma"):
            mod.PyCMAESDesigner(_float_problem(vz, 2)).suggest(1)
        d = mod.PyCMAESDesigner(_float_problem(vz, 2), popsize=4)
        rng = np.random.default_rng(1)
        trials = []
        for i in range(7):
            t = vz.Trial(id=i + 1, parameters={f"x{j}": float(v)
                                               for j, v in enumerate(rng.uniform(-5, 5, 2))})
            if i == 2:
                t.complete(vz.Measurement(), infeasibility_reason="diverged")
            else:
                t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
            trials.append(t)
        d.update(core.CompletedTrials(trials))
        module, calls = _stub_cma()
        out[side] = (_values(d._suggest_with(module, 3)), calls)
    assert out["port"][0] == out["jax"][0]
    for key in ("x0", "features", "labels"):
        assert out["port"][1][key].tobytes() == out["jax"][1][key].tobytes()
    assert out["port"][1]["features"].shape == (4, 2)


# -- BOCS and Harmonica --------------------------------------------------------------


@pytest.mark.parametrize("surrogate,optimizer", [("horseshoe", "sa"), ("ridge", "sdp"),
                                                 ("horseshoe", "sdp"), ("ridge", "sa")])
def test_bocs_rounds_are_identical(surrogate, optimizer):
    mod = {jvz: jbocs, tvz: tbocs}
    _lockstep(lambda vz: mod[vz].BOCSDesigner(
        _binary_problem(vz, 6), surrogate=surrogate, acquisition_optimizer=optimizer,
        anneal_steps=60, gibbs_samples=20, seed=3), rounds=4, count=3)


@pytest.mark.parametrize("lasso", [True, False])
def test_harmonica_rounds_are_identical(lasso, monkeypatch):
    if not lasso:  # the fit without scikit-learn: ridge, in both packages
        monkeypatch.setitem(sys.modules, "sklearn", None)
    mod = {jvz: jharmonica, tvz: tharmonica}
    d = _lockstep(lambda vz: mod[vz].HarmonicaDesigner(
        _binary_problem(vz, 8), samples_per_stage=8, seed=2), rounds=8, count=4)
    assert d["port"]._fixed == d["jax"]._fixed and d["port"]._stage == d["jax"]._stage == 3


@pytest.mark.parametrize("designer", ["bocs", "harmonica"])
def test_binary_designers_refuse_other_spaces_as_the_reference(designer):
    for vz, mod in ((jvz, {"bocs": jbocs, "harmonica": jharmonica}),
                    (tvz, {"bocs": tbocs, "harmonica": tharmonica})):
        make = getattr(mod[designer], "BOCSDesigner" if designer == "bocs"
                       else "HarmonicaDesigner")
        with pytest.raises(ValueError, match="binary"):
            make(_mixed_problem(vz))
    assert tharmonica._binary_dim is tbocs._binary_dim


# -- scalarizations ------------------------------------------------------------------


def _objective_rows(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)) * rng.uniform(0.1, 10.0, size=m)).astype(np.float32)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_scalarizations_are_bit_identical_in_float32(m):
    rows = _objective_rows(m, 257, m)
    weights = tuple(np.random.default_rng(m).uniform(0.1, 1.0, size=m).tolist())
    reference = tuple((-np.abs(rows).max(axis=0) * 0.3).tolist())
    for name, kwargs in (("LinearScalarization", {}), ("ChebyshevScalarization", {}),
                         ("ChebyshevScalarization", dict(reference_point=reference, rho=0.1)),
                         ("HyperVolumeScalarization", {}),
                         ("HyperVolumeScalarization", dict(reference_point=reference))):
        want = np.asarray(getattr(jscal, name)(weights=weights, **kwargs)(jax.numpy.asarray(rows)))
        got = getattr(tscal, name)(weights=weights, **kwargs)(torch.from_numpy(rows)).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), (name, kwargs)


def test_random_hv_directions_with_the_reference_normals():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jscal.random_hv_directions(key, 64, 3))
    normals = torch.from_numpy(np.array(jax.random.normal(key, (64, 3))))
    got = tscal.random_hv_directions(None, 64, 3, normals=normals).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-7)
    drawn = tscal.random_hv_directions(torch.Generator().manual_seed(0), 64, 3)
    assert drawn.shape == (64, 3) and bool((drawn >= 0).all())
    np.testing.assert_allclose(torch.linalg.norm(drawn, dim=-1).numpy(), 1.0, atol=1e-6)


# -- the wrappers --------------------------------------------------------------------


class _Recorder:
    """An inner designer that keeps what it is told and suggests nothing."""

    def __init__(self, problem, **values):
        self.problem, self.values, self.trials = problem, values, []

    def update(self, completed, all_active=None):
        self.trials.extend(completed.trials)

    def suggest(self, count=None):
        return []


def _seen(recorder):
    return [(t.id, t.infeasible, t.infeasibility_reason,
             {k: m.value for k, m in t.final_measurement.metrics.items()}
             if t.final_measurement else None) for t in recorder.trials]


def _multiobjective_trials(vz, n=24, seed=0):
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(n):
        x = rng.uniform(size=3)
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(3)})
        metrics = {"f1": float(np.sum(x ** 2)) * 7.3, "f2": float(np.sum((x - 1) ** 2)) / 3.1,
                   "safe": float(x[0] - 0.3)}
        if i == 4:
            del metrics["f2"]  # a missing objective: infeasible for the inner designer
        if i == 6:
            t.complete(vz.Measurement(metrics=metrics), infeasibility_reason="crashed")
        else:
            t.complete(vz.Measurement(metrics=metrics))
        trials.append(t)
    return trials


def _multiobjective_problem(vz, dim=3):
    p = vz.ProblemStatement()
    for j in range(dim):
        p.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    p.metric_information.append(vz.MetricInformation(name="f1", goal=vz.ObjectiveMetricGoal.MINIMIZE))
    p.metric_information.append(vz.MetricInformation(name="f2", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    p.metric_information.append(vz.MetricInformation(
        name="safe", goal=vz.ObjectiveMetricGoal.MAXIMIZE, safety_threshold=0.0))
    return p


@pytest.mark.parametrize("scalarization", [None, "LinearScalarization",
                                           "HyperVolumeScalarization"])
def test_scalarizing_designer_rewrites_labels_identically(scalarization):
    seen = {}
    for side, (vz, core) in _SIDES.items():
        mod, smod = ((jscalarizing, jscal) if side == "jax" else (tscalarizing, tscal))
        kw = {} if side == "jax" else {"device": "cpu"}
        s = (getattr(smod, scalarization)(weights=(0.7, 0.3)) if scalarization else None)
        d = mod.ScalarizingDesigner(_multiobjective_problem(vz), scalarization=s,
                                    designer_factory=lambda p, **k: _Recorder(p), **kw)
        d.update(core.CompletedTrials(_multiobjective_trials(vz)))
        d.update(core.CompletedTrials([]))
        seen[side] = _seen(d._inner)
    assert seen["port"] == seen["jax"]
    assert [row[1] for row in seen["port"]].count(True) == 2
    assert [row[2] for row in seen["port"]][4:7] == ["NaN", None, "crashed"]


def _gp_kw(side):
    if side == "jax":
        return dict(use_mesh=False, ard_restarts=2, max_acquisition_evaluations=400,
                    ard_optimizer=jlbfgs.AdamOptimizer(maxiter=10))
    return dict(device="cpu", ard_restarts=2, max_acquisition_evaluations=400,
                ard_optimizer=tlbfgs.AdamOptimizer(maxiter=10, device="cpu"))


def test_scalarizing_designer_feeds_the_gp_bandit_the_reference_data():
    designers = {}
    for side, (vz, core) in _SIDES.items():
        mod, bandit = (jscalarizing, jbandit) if side == "jax" else (tscalarizing, tbandit)
        kw = {} if side == "jax" else {"device": "cpu"}
        d = mod.ScalarizingDesigner(
            _multiobjective_problem(vz, dim=4),
            designer_factory=lambda p, _b=bandit, _s=side, **k: _b.VizierGPBandit(p, **_gp_kw(_s)),
            **kw)
        rng = np.random.default_rng(1)
        trials = []
        for i in range(16):
            x = rng.uniform(size=4)
            t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(4)})
            t.complete(vz.Measurement(metrics={"f1": float(np.sum((x - 0.3) ** 2)),
                                               "f2": float(-np.sum((x - 0.6) ** 2)),
                                               "safe": 1.0}))
            trials.append(t)
        d.update(core.CompletedTrials(trials))
        designers[side] = d
    jd, td = designers["jax"], designers["port"]
    jsugg, tsugg = jd.suggest(1), td.suggest(1)
    assert ([s.metadata.ns("gp_bandit")["acquisition_kind"] for s in tsugg]
            == [s.metadata.ns("gp_bandit")["acquisition_kind"] for s in jsugg])
    assert td._inner.ard_train_counts == jd._inner.ard_train_counts
    for s in tsugg:
        assert all(0.0 <= s.parameters.get_value(f"x{j}") <= 1.0 for j in range(4))
    # The port's inner GP at the JAX package's trained parameters, on the
    # port's own (scalarized, warped) data, gives the JAX package's samples.
    params = {k: np.asarray(v) for k, v in jd._inner._last_predictive.states.params.items()}
    tdata = tgp.GPData.from_model_data(td._inner._warped_model_data(), td._inner.device)
    td._inner._last_predictive = tgp.EnsemblePredictive(td._inner._model.precompute_constrained(
        interop.gp_params_from_numpy(params, "cpu"), tdata))
    key = jax.random.PRNGKey(3)
    want = jd._inner.sample(jsugg, rng=key, num_samples=64)
    got = td._inner._samples_from_draws(jsugg, torch.tensor(np.asarray(
        jax.random.normal(key, (64, 1)))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unsafe_trials_reach_the_inner_designer_as_infeasible():
    seen = {}
    for side, (vz, core) in _SIDES.items():
        mod = junsafe if side == "jax" else tunsafe
        with pytest.raises(ValueError, match="designer_factory"):
            mod.UnsafeAsInfeasibleDesigner(_multiobjective_problem(vz))
        d = mod.UnsafeAsInfeasibleDesigner(_multiobjective_problem(vz),
                                           designer_factory=lambda p, **k: _Recorder(p))
        d.update(core.CompletedTrials(_multiobjective_trials(vz)))
        seen[side] = _seen(d._inner)
    assert seen["port"] == seen["jax"]
    unsafe = [row for row in seen["port"] if row[2] == "Safety violation."]
    assert unsafe and all(row[1] for row in unsafe)


def test_scheduled_designer_rebuilds_at_the_reference_points():
    logs = {}
    for side, (vz, core) in _SIDES.items():
        mod = jscheduled if side == "jax" else tscheduled
        log = []

        def factory(p, _log=log, **values):
            recorder = _Recorder(p, **values)
            _log.append(recorder)
            return recorder

        d = mod.ScheduledDesigner(
            problem=_float_problem(vz, 2), designer_factory=factory,
            scheduled_params={"a": mod.ExponentialSchedule(2.5, 0.8),
                              "b": mod.LinearSchedule(1.0, 0.3),
                              "c": mod.ExponentialSchedule(1.0, 0.1, rate=2.0)},
            expected_total_num_trials=40)
        tid = 1
        for _ in range(12):
            d.suggest(4)
            suggestions = [vz.TrialSuggestion(parameters={"x0": 0.1 * tid, "x1": 0.0})
                           for _ in range(4)]
            d.update(core.CompletedTrials(_complete(vz, suggestions, tid)))
            tid += 4
        logs[side] = [(r.values, len(r.trials)) for r in log]
    assert logs["port"] == logs["jax"]
    assert 3 < len(logs["port"]) < 12


@pytest.mark.parametrize("preset", ["scheduled_gp_ucb_pe", "scheduled_gp_bandit"])
def test_scheduled_gp_presets_round_the_reference_coefficients(preset):
    built = {}
    for side, (vz, _) in _SIDES.items():
        mod = jscheduled if side == "jax" else tscheduled
        kw = {} if side == "jax" else {"device": "cpu"}
        d = getattr(mod, preset)(_float_problem(vz, 2), expected_total_num_trials=50, seed=3,
                                 **kw)
        rows = []
        for n in (0, 7, 25, 50, 80):
            values = {k: s(n / 50) for k, s in d.scheduled_params.items()}
            inner = d.designer_factory(d.problem, **values)
            config = getattr(inner, "config", None)
            rows.append((values, inner.rng_seed, inner.ucb_coefficient if config is None else (
                config.ucb_coefficient, config.explore_region_ucb_coefficient)))
        built[side] = rows
    assert built["port"] == built["jax"]
