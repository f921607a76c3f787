"""The port's benchmark analyzers against the JAX package's, on the CPU.

The converters, the exploration scores, the state and record analyzers and
the plots are host numpy in both packages: on the same trials they give the
same floats, bit for bit (tolerance: none). The one exception is the
hypervolume curve behind ``MultiMetricCurveConverter`` on two objectives,
whose random directions come from a JAX key on one side and a torch
generator on the other: there the JAX package's directions are fed to the
port's converter, and the curves agree within 1e-5 relative (as in
``test_torch_benchmarks.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks import BenchmarkRunner as JRunner
from vizier_tpu.benchmarks import BenchmarkState as JState
from vizier_tpu.benchmarks import GenerateAndEvaluate as JGenerate
from vizier_tpu.benchmarks import NumpyExperimenter as JNumpy
from vizier_tpu.benchmarks import bbob_problem as jbbob_problem
from vizier_tpu.benchmarks.analyzers import convergence_curve as jcc
from vizier_tpu.benchmarks.analyzers import exploration_score as jexp
from vizier_tpu.benchmarks.analyzers import plot_utils as jplot
from vizier_tpu.benchmarks.analyzers import state_analyzer as jsa
from vizier_tpu.benchmarks.experimenters.synthetic import bbob as jbbob
from vizier_tpu.designers import random as jrandom
from vizier_tpu_torch import benchmarks as tbench
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.benchmarks import analyzers as tanalyzers
from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as tcc
from vizier_tpu_torch.benchmarks.analyzers import exploration_score as texp
from vizier_tpu_torch.benchmarks.analyzers import plot_utils as tplot
from vizier_tpu_torch.benchmarks.analyzers import state_analyzer as tsa
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob as tbbob
from vizier_tpu_torch.designers import random as trandom

matplotlib.use("Agg")

_SIDES = {
    "jax": dict(vz=jvz, cc=jcc, exp=jexp, sa=jsa, plot=jplot, bbob=jbbob, random=jrandom,
                Runner=JRunner, State=JState, Generate=JGenerate, Numpy=JNumpy,
                bbob_problem=jbbob_problem),
    "port": dict(vz=tvz, cc=tcc, exp=texp, sa=tsa, plot=tplot, bbob=tbbob, random=trandom,
                 Runner=tbench.BenchmarkRunner, State=tbench.BenchmarkState,
                 Generate=tbench.GenerateAndEvaluate, Numpy=tbench.NumpyExperimenter,
                 bbob_problem=tbench.bbob_problem),
}


def _curve_bits(curve) -> tuple:
    return (np.asarray(curve.xs).tobytes(), np.asarray(curve.ys).dtype.str,
            np.asarray(curve.ys).shape, np.asarray(curve.ys).tobytes(), curve.trend.name)


def _trials(vz, n=24, seed=0, metrics=("obj",), safe=False):
    """Completed trials over ``metrics`` (uniform values), every fifth one
    infeasible; with ``safe``, a safety metric ``safe`` in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = vz.Trial(id=i + 1, parameters={"x": float(rng.uniform())})
        values = {m: float(rng.normal()) for m in metrics}
        if safe:
            values["safe"] = float(rng.uniform())
        if i % 5 == 4:
            t.complete(infeasibility_reason="infeasible")
        else:
            t.complete(vz.Measurement(metrics=values))
        out.append(t)
    return out


def _config(vz, goals, safe=False):
    metrics = [vz.MetricInformation(name=name, goal=getattr(vz.ObjectiveMetricGoal, goal))
               for name, goal in goals]
    if safe:
        metrics.append(vz.MetricInformation(name="safe", goal=vz.ObjectiveMetricGoal.MAXIMIZE,
                                            safety_threshold=0.3))
    return vz.MetricsConfig(metrics)


@pytest.mark.parametrize("goal", ["MAXIMIZE", "MINIMIZE"])
@pytest.mark.parametrize("safe", [False, True], ids=["plain", "with_safety"])
@pytest.mark.parametrize("flip", [False, True], ids=["raw", "flipped"])
def test_multi_metric_converter_on_one_objective_is_bit_equal(goal, safe, flip):
    curves = {}
    for side, m in _SIDES.items():
        trials = _trials(m["vz"], safe=safe)
        converter = m["cc"].MultiMetricCurveConverter.from_metrics_config(
            _config(m["vz"], [("obj", goal)], safe=safe), flip_signs_for_min=flip)
        curves[side] = _curve_bits(converter.convert(trials))
        assert all(t.infeasibility_reason in (None, "infeasible") for t in trials)
    assert curves["port"] == curves["jax"]


def test_multi_metric_converter_on_two_objectives_with_the_same_directions(monkeypatch):
    def jax_directions(generator, num_vectors, num_metrics):
        v = jnp.abs(jax.random.normal(jax.random.PRNGKey(4), (num_vectors, num_metrics),
                                      dtype=jnp.float32))
        return torch.from_numpy(np.array(v / jnp.linalg.norm(v, axis=-1, keepdims=True)))

    monkeypatch.setattr(tcc.pareto_ops, "draw_directions", jax_directions)
    curves = {}
    for side, m in _SIDES.items():
        goals = [("f1", "MAXIMIZE"), ("f2", "MINIMIZE")]
        converter = m["cc"].MultiMetricCurveConverter.from_metrics_config(
            _config(m["vz"], goals, safe=True), reference_point=np.array([-3.0, -3.0]),
            num_vectors=400, seed=4)
        assert type(converter.converter).__name__ == "HypervolumeCurveConverter"
        curves[side] = converter.convert(_trials(m["vz"], metrics=("f1", "f2"), safe=True))
    assert curves["port"].trend == tcc.ConvergenceCurve.YTrend.INCREASING
    np.testing.assert_allclose(curves["port"].ys, curves["jax"].ys, rtol=1e-5, atol=1e-6)
    assert curves["port"].ys[0, -1] > 0


def test_multi_metric_converter_refuses_no_trials_in_both():
    for side, m in _SIDES.items():
        converter = m["cc"].MultiMetricCurveConverter.from_metrics_config(
            _config(m["vz"], [("obj", "MAXIMIZE")]))
        with pytest.raises(ValueError, match="No trials"):
            converter.convert([])


@pytest.mark.parametrize("min_trials,rate", [(0, 2.0), (10, 2.0), (5, 3.0)])
def test_restarting_converter_streams_the_same_curves(min_trials, rate):
    curves, builds = {}, {}
    for side, m in _SIDES.items():
        count = []

        def factory(m=m, count=count):
            count.append(1)
            return m["cc"].ConvergenceCurveConverter(
                m["vz"].MetricInformation(name="obj", goal=m["vz"].ObjectiveMetricGoal.MINIMIZE),
                flip_signs_for_min=True)

        converter = m["cc"].RestartingCurveConverter(factory, restart_min_trials=min_trials,
                                                     restart_rate=rate)
        trials = _trials(m["vz"], n=30, seed=2)
        curves[side] = [_curve_bits(converter.convert(trials[i:i + 4]))
                        for i in range(0, 30, 4)] + [_curve_bits(converter.convert([]))]
        builds[side] = len(count)
    assert curves["port"] == curves["jax"]
    assert builds["port"] == builds["jax"] > 1


@pytest.mark.parametrize("kw,error", [(dict(restart_rate=1.0), "restart_rate"),
                                      (dict(restart_min_trials=-1), "restart_min_trials")])
def test_restarting_converter_refuses_what_the_jax_package_refuses(kw, error):
    for side, m in _SIDES.items():
        with pytest.raises(ValueError, match=error):
            m["cc"].RestartingCurveConverter(lambda: None, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_convergence_curve_is_equal(seed):
    rng = np.random.default_rng(seed)
    baseline = np.maximum.accumulate(rng.normal(size=20)).tolist()
    compared = np.maximum.accumulate(rng.normal(size=15)).tolist()
    got = {side: m["cc"].build_convergence_curve(baseline, compared)
           for side, m in _SIDES.items()}
    assert got["port"] == got["jax"]
    assert all(isinstance(v, float) for v in got["port"])


# -- exploration scores ----------------------------------------------------------


def _space(vz):
    space = vz.SearchSpace()
    root = space.root
    root.add_float_param("f", -2.0, 3.0)
    root.add_float_param("g", 1e-3, 1.0, scale_type=vz.ScaleType.LOG)
    root.add_int_param("i", 0, 6)
    root.add_discrete_param("d", [0.5, 1.0, 4.0])
    root.add_categorical_param("c", ["a", "b", "c", "d"])
    root.add_bool_param("b")
    return space


@pytest.mark.parametrize("n", [1, 7, 100, 500])
def test_parameter_entropies_are_bit_equal(n):
    got = {}
    for side, m in _SIDES.items():
        space = _space(m["vz"])
        trials = [m["vz"].Trial(id=i + 1, parameters=p) for i, p in enumerate(
            m["random"].sample_point(space, np.random.default_rng(n)) for _ in range(n))]
        got[side] = [np.float64(m["exp"].compute_parameter_entropy(
            config, [t.parameters.get(config.name) for t in trials])).tobytes()
            for config in space.parameters]
    assert got["port"] == got["jax"]


def test_parameter_entropy_refuses_out_of_bound_values_in_both():
    messages = {}
    for side, m in _SIDES.items():
        space = _space(m["vz"])
        errors = []
        for name, value in (("f", 9.0), ("c", "z"), ("i", -1)):
            with pytest.raises(ValueError) as info:
                m["exp"].compute_parameter_entropy(space.get(name),
                                                   [m["vz"].ParameterValue(value)])
            errors.append(str(info.value))
        messages[side] = errors
        assert m["exp"].compute_parameter_entropy(space.get("f"), [None]) == 0.0
    assert messages["port"] == messages["jax"]


def test_average_marginal_entropy_is_bit_equal():
    got = {}
    for side, m in _SIDES.items():
        vz = m["vz"]
        results = {}
        for algorithm, seed in (("random", 1), ("other", 2)):
            studies = {}
            for s in range(3):
                problem = vz.ProblemStatement(search_space=_space(vz))
                rng = np.random.default_rng(10 * seed + s)
                trials = [vz.Trial(id=i + 1, parameters=m["random"].sample_point(
                    problem.search_space, rng)) for i in range(40)]
                studies[s] = vz.ProblemAndTrials(problem=problem, trials=trials)
            results[algorithm] = {"spec": studies}
        got[side] = np.float64(m["exp"].compute_average_marginal_parameter_entropy(
            results)).tobytes()
        assert m["exp"].compute_average_marginal_parameter_entropy({}) == 0.0
    assert got["port"] == got["jax"]
    assert (tanalyzers.compute_parameter_entropy is texp.compute_parameter_entropy
            and tbench.compute_average_marginal_parameter_entropy
            is texp.compute_average_marginal_parameter_entropy)


# -- state and record analyzers, plots ----------------------------------------------


def _states(m, repeats=2):
    """Random-designer benchmark states on two BBOB functions."""
    states = []
    for fn, seed in (("Sphere", 0), ("Rastrigin", 1), ("Sphere", 2)):
        experimenter = m["Numpy"](getattr(m["bbob"], fn), m["bbob_problem"](3))
        state = m["State"].from_designer_factory(
            experimenter, lambda p, _s=seed, **kw: m["random"].RandomDesigner(p.search_space,
                                                                              seed=_s))
        m["Runner"]([m["Generate"](4)], num_repeats=repeats).run(state)
        states.append(state)
    return states


def _records_bits(records):
    return [{k: (np.asarray(v).tobytes() if isinstance(v, np.ndarray) else v)
             for k, v in r.items()} for r in records]


def test_state_analyzer_records_and_frame_are_equal():
    records, frames = {}, {}
    for side, m in _SIDES.items():
        states = _states(m)
        records[side] = _records_bits(m["sa"].BenchmarkStateAnalyzer.to_records(
            states, algorithm_names=["a", "b", "a"]))
        frame = m["sa"].BenchmarkStateAnalyzer.to_dataframe(states)
        frames[side] = (list(frame.columns), frame[["algorithm", "num_trials",
                                                    "best_objective"]].to_dict("list"))
    assert records["port"] == records["jax"]
    assert frames["port"] == frames["jax"]
    assert records["port"][0]["num_trials"] == 8


def _record_set(m):
    cc = m["cc"]
    rng = np.random.default_rng(5)
    out = []
    for algorithm in ("baseline", "candidate"):
        for fn in ("Sphere", "Rastrigin"):
            ys = np.maximum.accumulate(rng.normal(size=(3, 12 if algorithm == "baseline"
                                                         else 9)), axis=1)
            curve = cc.ConvergenceCurve(xs=np.arange(1, ys.shape[1] + 1), ys=ys,
                                        trend=cc.ConvergenceCurve.YTrend.INCREASING)
            out.append(m["sa"].BenchmarkRecord(
                algorithm=algorithm, experimenter_metadata={"fn": fn, "dim": "3"},
                plot_elements={"objective": m["sa"].PlotElement(curve=curve)}))
    out.append(m["sa"].BenchmarkRecord(algorithm="lonely",
                                       experimenter_metadata={"fn": "Ackley"}))
    return out


def test_record_analyzer_scores_and_summaries_are_equal():
    got = {}
    for side, m in _SIDES.items():
        records = m["sa"].BenchmarkRecordAnalyzer.add_comparison_metrics(
            _record_set(m), "baseline")
        rows = m["sa"].BenchmarkRecordAnalyzer.summarize(records)
        frame = m["sa"].BenchmarkRecordAnalyzer.summarize_dataframe(records)
        got[side] = (json_rows(rows), [r.experimenter_key for r in records],
                     sorted(frame.columns))
    assert got["port"] == got["jax"]
    assert "log_efficiency_vs_baseline" in got["port"][2]


def json_rows(rows):
    return [sorted((k, np.float64(v).tobytes() if isinstance(v, float) else v)
                   for k, v in row.items()) for row in rows]


def _plotted(ax):
    lines = [line.get_xydata().tobytes() for line in ax.lines]
    bands = [p.get_paths()[0].vertices.tobytes() for p in ax.collections]
    return (lines, bands, ax.get_xscale(), ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
            [t.get_text() for t in ax.get_legend().get_texts()])


def test_plots_draw_the_same_lines():
    import matplotlib.pyplot as plt

    got = {}
    for side, m in _SIDES.items():
        cc = m["cc"]
        xs = np.arange(1, 11)
        curve = cc.ConvergenceCurve(xs=xs, ys=np.stack([xs * 0.1, xs * 0.12, xs * 0.09]),
                                    trend=cc.ConvergenceCurve.YTrend.INCREASING)
        one = m["plot"].plot_median_convergence({"algo": curve}, title="t", log_x=True)
        states = m["plot"].plot_states(_states(m), algorithm_names=["x", "y", "x"])
        got[side] = (_plotted(one), _plotted(states))
        with pytest.raises(ValueError, match="percentiles"):
            m["plot"].plot_median_convergence({"algo": curve}, percentiles=(50.0,))
        plt.close("all")
    assert got["port"] == got["jax"]
