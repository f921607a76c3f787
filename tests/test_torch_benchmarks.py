"""The port's benchmark layer against the JAX package's, on the CPU.

Experimenter values at seeded numpy points (every BBOB function, Branin, the
classics, ZDT and DTLZ) must be the same floats, bit for bit: both sides are
the same numpy code. ``shifted_bbob_instance`` gives the same trial values
for seeds 1-5 at dims 2 and 20; the DEFAULT designer's quasi-random seed
round gives the same 10 parameter sets for seeds 1-5; the runner gives the
same completed trials with the quasi-random designer; the t-test score and
the best-so-far curves are equal; the hypervolume curve, with the JAX
package's random directions fed to both sides, agrees within 1e-5. Then the
port's regret run: its lockstep mode (every study through one batch
executor) equals its sequential mode (each study through the runner) trial
for trial on the CPU, and its parity gate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import benchmarks as jbench
from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.analyzers import convergence_curve as jcc
from vizier_tpu.benchmarks.experimenters import experimenter_factory as jfactory
from vizier_tpu.benchmarks.experimenters.synthetic import bbob as jbbob
from vizier_tpu.benchmarks.experimenters.synthetic import classic as jclassic
from vizier_tpu.benchmarks.experimenters.synthetic import multiobjective as jmo
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers import quasi_random as jqr
from vizier_tpu_torch import benchmarks as tbench
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.benchmarks import regret
from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as tcc
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory as tfactory
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob as tbbob
from vizier_tpu_torch.benchmarks.experimenters.synthetic import classic as tclassic
from vizier_tpu_torch.benchmarks.experimenters.synthetic import multiobjective as tmo
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.designers import quasi_random as tqr

_SEEDS = (1, 2, 3, 4, 5)


def _points(seed: int, n: int, dim: int, low: float, high: float) -> np.ndarray:
    return np.random.default_rng(seed).uniform(low, high, size=(n, dim))


def _same(a, b) -> bool:
    """Equal floats, bit for bit (NaN where NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(jbbob.BBOB_FUNCTIONS) + sorted(jbbob.EXTRA_FUNCTIONS))
def test_bbob_functions_are_bit_equal(name):
    fn_j = jbbob.BBOB_FUNCTIONS.get(name) or jbbob.EXTRA_FUNCTIONS[name]
    fn_t = tbbob.BBOB_FUNCTIONS.get(name) or tbbob.EXTRA_FUNCTIONS[name]
    for dim in ((2,) if name == "Branin" else (2, 5, 20)):
        # Past the [-5, 5] box too, so the boundary penalties are held.
        x = _points(dim, 64, dim, -6.0, 6.0)
        assert _same(fn_t(x), fn_j(x)), (name, dim)


def test_classic_experimenters_are_bit_equal():
    x = _points(0, 64, 2, -5.0, 15.0)
    assert _same(tclassic.branin(x), jclassic.branin(x))
    for make in ("from_3d", "from_6d"):
        exp_t, exp_j = getattr(tclassic.HartmannExperimenter, make)(), getattr(
            jclassic.HartmannExperimenter, make)()
        dim = len(exp_j.problem_statement().search_space.parameters)
        x = _points(dim, 64, dim, 0.0, 1.0)
        assert _same(exp_t._impl(x), exp_j._impl(x))
    values = {}
    for side, pkg, vz in (("t", tclassic, tvz), ("j", jclassic, jvz)):
        trials = [vz.Trial(id=i + 1, parameters={"x1": float(a), "x2": float(b)})
                  for i, (a, b) in enumerate(_points(1, 16, 2, 0.0, 10.0))]
        pkg.Branin2DExperimenter().evaluate(trials)
        arms = [vz.Trial(parameters={"arm": a}) for a in "abcab" * 4]
        pkg.BernoulliMultiArmExperimenter({"a": 0.2, "b": 0.5, "c": 0.9}, seed=3).evaluate(arms)
        pkg.FixedMultiArmExperimenter({"a": 1.0, "b": 2.0, "c": 0.5}).evaluate(arms[:5])
        values[side] = [t.final_measurement.metrics[k].value
                        for t, k in zip(trials + arms, ["value"] * 16 + ["reward"] * 20)]
    assert values["t"] == values["j"]


@pytest.mark.parametrize("name", ["zdt1", "zdt2", "zdt3", "zdt4", "zdt6", "dtlz1", "dtlz2"])
def test_multiobjective_functions_are_bit_equal(name):
    x = _points(7, 64, 7, 0.0, 1.0)
    if name.startswith("zdt"):
        assert _same(tmo.ZDT_FUNCTIONS[name](x), jmo.ZDT_FUNCTIONS[name](x))
        exp_t, exp_j = tmo.MultiObjectiveExperimenter.zdt(name, dimension=7), \
            jmo.MultiObjectiveExperimenter.zdt(name, dimension=7)
    else:
        for m in (2, 3):
            assert _same(getattr(tmo, name)(x, m), getattr(jmo, name)(x, m))
        exp_t, exp_j = tmo.MultiObjectiveExperimenter.dtlz(name, dimension=7, num_objectives=3), \
            jmo.MultiObjectiveExperimenter.dtlz(name, dimension=7, num_objectives=3)
    metrics = {}
    for side, exp, vz in (("t", exp_t, tvz), ("j", exp_j, jvz)):
        trials = [vz.Trial(id=i + 1, parameters={f"x{j}": float(v) for j, v in enumerate(row)})
                  for i, row in enumerate(x)]
        exp.evaluate(trials)
        metrics[side] = [{k: m.value for k, m in t.final_measurement.metrics.items()}
                         for t in trials]
    assert metrics["t"] == metrics["j"]
    assert [m.name for m in exp_t.problem_statement().metric_information] == [
        m.name for m in exp_j.problem_statement().metric_information]


@pytest.mark.parametrize("fn,dim", [("Sphere", 2), ("Sphere", 20), ("Rastrigin", 2),
                                    ("Rastrigin", 20), ("Branin", 2)])
def test_shifted_bbob_instance_gives_the_same_trial_values(fn, dim):
    for seed in _SEEDS:
        x = _points(seed, 32, dim, -5.0, 5.0)
        values = {}
        for side, factory, vz in (("t", tfactory, tvz), ("j", jfactory, jvz)):
            exp = factory.shifted_bbob_instance(fn, seed, dim=dim)
            trials = [vz.Trial(id=i + 1, parameters={f"x{j}": float(v) for j, v in enumerate(row)})
                      for i, row in enumerate(x)]
            exp.evaluate(trials)
            values[side] = [t.final_measurement.metrics["bbob_eval"].value for t in trials]
        assert values["t"] == values["j"], (fn, dim, seed)


def test_factory_wrappers_give_the_same_values():
    """Noise (additive and the named models), shift and discretization."""
    for kw in (dict(noise_std=0.5, seed=4), dict(noise_type="moderate_uniform", seed=2),
               dict(noise_type="SEVERE_SELDOM_CAUCHY", seed=1),
               dict(shift=np.full(4, 1.5), discrete_dict={"x1": [-1.0, 0.0, 1.0]})):
        values = {}
        for side, factory, vz in (("t", tfactory, tvz), ("j", jfactory, jvz)):
            exp = factory.SingleObjectiveExperimenterFactory("Rastrigin", dim=4, **kw)()
            params = exp.problem_statement().search_space.parameters
            trials = [vz.Trial(id=i + 1, parameters={p.name: float(v) for p, v in zip(params, row)})
                      for i, row in enumerate(_points(9, 24, 4, -1.0, 1.0))]
            exp.evaluate(trials)
            values[side] = [{k: m.value for k, m in t.final_measurement.metrics.items()}
                            for t in trials]
            values[side + "space"] = [(p.name, p.type.name, p.feasible_values if p.type.name
                                       == "DISCRETE" else p.bounds) for p in params]
        assert values["t"] == values["j"], kw
        assert values["tspace"] == values["jspace"], kw


@pytest.mark.parametrize("fn,dim", [("Sphere", 20), ("Branin", 2)])
def test_quasi_random_seed_round_gives_the_same_parameters(fn, dim):
    """The regret run's first suggest(10): no completed trials, so the
    DEFAULT designer's seeding stage (quasi-random) for every seed."""
    for seed in _SEEDS:
        picks = {}
        for side, factory, ucb in (("t", tfactory, tucb), ("j", jfactory, jucb)):
            problem = factory.shifted_bbob_instance(fn, seed, dim=dim).problem_statement()
            kw = dict(device="cpu") if side == "t" else {}
            designer = ucb.VizierGPUCBPEBandit(
                problem, rng_seed=seed, max_acquisition_evaluations=25_000, num_seed_trials=5,
                acquisition_budget_policy="first_pick_full", **kw)
            picks[side] = [s.parameters.as_dict() for s in designer.suggest(10)]
        assert len(picks["t"]) == 10
        assert picks["t"] == picks["j"], (fn, seed)


def _runner_trials(bench, vz, qr, factory):
    exp = factory.shifted_bbob_instance("Sphere", 3, dim=4)
    state = bench.BenchmarkState.from_designer_factory(
        exp, lambda p, seed=None: qr.QuasiRandomDesigner(p.search_space, seed=seed), seed=7)
    prior = vz.Trial(parameters={f"x{j}": 0.5 * j for j in range(4)})
    exp.evaluate([prior])
    bench.BenchmarkRunner([bench.AddPriorTrials([prior])]).run(state)
    bench.BenchmarkRunner([
        bench.GenerateSuggestions(3), bench.EvaluateActiveTrials(2), bench.EvaluateActiveTrials(),
        bench.GenerateAndEvaluate(2),
    ], num_repeats=3).run(state)
    return [(t.id, t.status.name, t.parameters.as_dict(),
             t.final_measurement.metrics["bbob_eval"].value)
            for t in state.algorithm.supporter.GetTrials()]


def test_benchmark_runner_gives_the_same_completed_trials():
    got = _runner_trials(tbench, tvz, tqr, tfactory)
    want = _runner_trials(jbench, jvz, jqr, jfactory)
    assert len(got) == 16 and all(status == "COMPLETED" for _, status, _, _ in got)
    assert got == want


def test_t_test_mean_score_is_equal():
    rng = np.random.default_rng(5)
    base, cand = rng.normal(size=8), rng.normal(0.4, 1.0, size=6)
    for goal in ("MINIMIZE", "MAXIMIZE"):
        for c in (cand, cand[:1]):
            got = tbench.t_test_mean_score(base, c, getattr(tvz.ObjectiveMetricGoal, goal))
            want = jbench.t_test_mean_score(base, c, getattr(jvz.ObjectiveMetricGoal, goal))
            assert got == want


def _curve_trials(vz, seed: int):
    values = np.random.default_rng(seed).normal(size=20)
    trials = []
    for i, v in enumerate(values):
        t = vz.Trial(id=i + 1, parameters={"x": float(i)})
        if i == 4:
            t.complete(infeasibility_reason="infeasible")
        else:
            t.complete(vz.Measurement(metrics={"y": float(v)}))
        trials.append(t)
    return trials


def test_best_so_far_curves_and_comparators_are_equal():
    out = {}
    for side, cc, vz in (("t", tcc, tvz), ("j", jcc, jvz)):
        rows = []
        for goal in ("MINIMIZE", "MAXIMIZE"):
            info = vz.MetricInformation(name="y", goal=getattr(vz.ObjectiveMetricGoal, goal))
            for flip in (False, True):
                curves = [cc.ConvergenceCurveConverter(info, flip_signs_for_min=flip).convert(
                    _curve_trials(vz, seed)) for seed in (1, 2, 3)]
                rows.append([(c.xs.tolist(), c.ys.tolist(), c.trend.value) for c in curves])
                base = cc.ConvergenceCurve.align_xs(curves[:2])
                other = cc.ConvergenceCurve.align_xs(curves[2:]).extrapolate_ys(3)
                rows.append([base.ys.tolist(), other.ys.tolist(),
                             base.interpolate_at(np.array([1.5, 7.25])).ys.tolist()])
                rows.append([
                    cc.LogEfficiencyConvergenceCurveComparator(base).score(curves[2]),
                    cc.WinRateComparator(base).score(curves[2]),
                    cc.PercentageBetterComparator(base).score(curves[2]),
                    cc.OptimalityGapComparator(base, optimum=-3.0).score(curves[2]),
                    cc.SimpleRegretComparator(-3.0, info.goal).regret(base, at_trial=10),
                ])
        out[side] = rows
    assert out["t"] == out["j"]


def test_hypervolume_curve_with_the_same_directions(monkeypatch):
    """The JAX converter's directions (its key, |normal| normalized) fed to
    the port's: the curves agree within 1e-5 relative."""
    exp_t = tmo.MultiObjectiveExperimenter.zdt("zdt1", dimension=6)
    exp_j = jmo.MultiObjectiveExperimenter.zdt("zdt1", dimension=6)
    x = _points(11, 40, 6, 0.0, 1.0)
    curves = {}
    for side, exp, vz, cc in (("t", exp_t, tvz, tcc), ("j", exp_j, jvz, jcc)):
        trials = [vz.Trial(id=i + 1, parameters={f"x{j}": float(v) for j, v in enumerate(row)})
                  for i, row in enumerate(x)]
        exp.evaluate(trials)
        converter = cc.HypervolumeCurveConverter(
            list(exp.problem_statement().metric_information),
            reference_point=np.array([-1.1, -6.0], dtype=np.float32), num_vectors=500, seed=3)
        curves[side] = converter.convert(trials)

    def jax_directions(generator, num_vectors, num_metrics):
        v = jnp.abs(jax.random.normal(jax.random.PRNGKey(3), (num_vectors, num_metrics),
                                      dtype=jnp.float32))
        return torch.from_numpy(np.array(v / jnp.linalg.norm(v, axis=-1, keepdims=True)))

    monkeypatch.setattr(tcc.pareto_ops, "draw_directions", jax_directions)
    trials = [tvz.Trial(id=i + 1, parameters={f"x{j}": float(v) for j, v in enumerate(row)})
              for i, row in enumerate(x)]
    exp_t.evaluate(trials)
    fed = tcc.HypervolumeCurveConverter(
        list(exp_t.problem_statement().metric_information),
        reference_point=np.array([-1.1, -6.0], dtype=np.float32), num_vectors=500,
        seed=3).convert(trials)
    want = curves["j"].ys
    assert fed.trend == tcc.ConvergenceCurve.YTrend.INCREASING
    np.testing.assert_array_equal(fed.xs, curves["j"].xs)
    assert float(np.max(np.abs(fed.ys - want) / np.maximum(np.abs(want), 1e-30))) <= 1e-5
    # The port's own directions (a torch generator) give another estimate of
    # the same hypervolume.
    assert float(np.max(np.abs(curves["t"].ys[0, -1] - want[0, -1]))) <= 0.05 * want[0, -1]


def test_regret_lockstep_equals_sequential_trial_for_trial():
    """Every study through one executor (slot i of a flush) gives what it
    gives alone through the runner: the same trials, float for float."""
    kw = dict(fn="Sphere", dim=4, seeds=(1, 2), trials=20, batch=5, evals=1000, device="cpu")
    executor, stats = regret.make_executor()
    try:
        lockstep, info = regret.run_lockstep(**kw, executor=executor, serving_stats=stats)
    finally:
        executor.close()
    sequential, _ = regret.run_sequential(**kw)
    rounds = info["executor"]["rounds"]
    # The seed round runs inline; each later round is one flush of both.
    assert [r["batched_suggests"] for r in rounds] == [0, 2, 2, 2]
    assert info["executor"]["batch_fallbacks"] == info["executor"]["batch_slot_errors"] == 0
    for a, b in zip(lockstep, sequential):
        assert (a.fn, a.seed, len(a.trials)) == (b.fn, b.seed, 20)
        assert [t.parameters.as_dict() for t in a.trials] == [
            t.parameters.as_dict() for t in b.trials]
        assert [t.final_measurement.metrics["bbob_eval"].value for t in a.trials] == [
            t.final_measurement.metrics["bbob_eval"].value for t in b.trials]
        assert a.regret == b.regret


def test_regret_parity_gate(monkeypatch, capsys):
    """The reference's own rows pass; regrets above every reference run fail
    the rank test (p = 1/252); Branin is held by its median. A run at another
    configuration is not compared: parity raises and the command exits 2."""
    reference_file = __import__("json").loads(regret.REFERENCE.read_text())
    config = {k: reference_file[k] for k in ("seeds", "trials", "batch", "evals")}
    assert regret.parity({**config, "per_run": {}}) == {}
    ref = reference_file["per_run"]
    keys = ("Sphere20d:first_pick_full", "Rastrigin20d:first_pick_full",
            "Branin2d:first_pick_full")
    same = regret.parity({**config, "per_run": {k: ref[k] for k in keys}})
    assert all(row["passed"] for row in same.values())
    worse = regret.parity({**config, "per_run": {k: [v + 1000.0 for v in ref[k]] for k in keys}})
    assert worse[keys[0]]["p"] == pytest.approx(1 / 252) and not worse[keys[0]]["passed"]
    assert not worse[keys[2]]["passed"]
    for key, value in (("trials", 20), ("batch", 5), ("evals", 1000), ("seeds", [1, 2])):
        with pytest.raises(regret.NotComparable):
            regret.parity({**config, key: value, "per_run": {k: ref[k] for k in keys}})
    monkeypatch.setattr(regret, "run", lambda *a, **k: {
        **config, "trials": 20, "per_run": {k: ref[k] for k in keys}})
    assert regret.main(["--trials", "20", "--device", "cpu"]) == 2
    assert "no parity gate applies" in capsys.readouterr().out


def test_regret_suite_configs_run_on_the_cpu():
    """regret_suite.py's GP-bandit, mixed-space and two-objective configs
    through the port's runner at a small budget: values of the right kind."""
    best = regret.branin_gp_ucb(1, trials=12, evals=300, device="cpu")
    assert 0.397887 <= best < 60.0
    acc = regret.mixed_default_ucbpe(1, trials=12, evals=300, device="cpu")
    assert 0.0 < acc <= 1.05
    hv, completed = regret.zdt1_gp_hv_ucb(trials=15, evals=300, device="cpu")
    assert len(completed) == 15 and np.isfinite(hv) and hv > 0.0


@pytest.mark.parametrize("entry", ["lockstep", "sequential", "branin_gp_ucb",
                                   "mixed_default_ucbpe", "zdt1_gp_hv_ucb"])
def test_regret_entry_points_run_on_cuda_unless_asked(monkeypatch, entry):
    calls = {
        "lockstep": lambda: regret.run("lockstep", functions=(("Branin", 2),), seeds=(1,)),
        "sequential": lambda: regret.run("sequential", functions=(("Branin", 2),), seeds=(1,)),
        "branin_gp_ucb": lambda: regret.branin_gp_ucb(1),
        "mixed_default_ucbpe": lambda: regret.mixed_default_ucbpe(1),
        "zdt1_gp_hv_ucb": lambda: regret.zdt1_gp_hv_ucb(),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
