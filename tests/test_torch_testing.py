"""The port's testing harnesses, held to the JAX package's on the CPU.

- ``failing`` and ``chaos``: the failing designers; ``ChaosDesigner``
  resolving to a ``ChaosProgram`` through the compute registry (kind,
  algorithms, bucket key and ``shardable_batch_axis`` of the inner program)
  and reading through to the inner designer; the strikes through the port's
  ``BatchExecutor`` (``testing/chaos_flushes.py``: a per-slot strike
  degrades only its slot, the others equal an unstruck flush; a
  device-program strike runs the whole-batch sequential fallback; the
  counters equal the injected strikes); the datastore and stub proxies
  striking the JAX package's sites in its order.
- ``numpy_assertions`` over dicts, lists, NamedTuples, dataclasses, numpy
  arrays and tensors; ``test_studies``' spaces and metrics equal the JAX
  package's; ``RandomMetricsRunner`` and ``optimizer_test_utils`` on the
  port's designers.
- ``SimpleKDExperimenter`` (its problem and ``evaluate`` on the same
  trials) equal the JAX package's; ``SimpleKDConvergenceTester`` and
  ``SimpleRegretComparisonTester`` pass at the JAX gates' thresholds
  (``tests/designers/test_convergence_gates.py``) with the port's designers
  on ``device="cpu"``; ``EfficiencyComparisonTester``'s score equals the JAX
  package's on seeded random designers.
- ``stress.run_stress_round`` through the port's in-process service.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

import vizier_tpu.testing as jtesting
from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters.synthetic import simplekd as jsimplekd
from vizier_tpu.designers import random as jrandom
from vizier_tpu.testing import chaos as jchaos
from vizier_tpu.testing import comparator_runner as jcomparator
from vizier_tpu.testing import test_runners as jtest_runners
from vizier_tpu.testing import test_studies as jtest_studies
import vizier_tpu_torch.testing as testing
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.benchmarks import NumpyExperimenter, bbob_problem
from vizier_tpu_torch.benchmarks.experimenters import wrappers
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob
from vizier_tpu_torch.benchmarks.experimenters.synthetic import simplekd
from vizier_tpu_torch.compute import registry
from vizier_tpu_torch.designers import random as random_designer
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.testing import chaos
from vizier_tpu_torch.testing import chaos_flushes
from vizier_tpu_torch.testing import comparator_runner
from vizier_tpu_torch.testing import failing
from vizier_tpu_torch.testing import numpy_assertions
from vizier_tpu_torch.testing import optimizer_test_utils
from vizier_tpu_torch.testing import simplekd_runner
from vizier_tpu_torch.testing import test_runners
from vizier_tpu_torch.testing import test_studies

_FAST_ARD = lbfgs.AdamOptimizer(maxiter=40, device="cpu")


def test_exports_equal_the_jax_package():
    jax_exports = sorted(n for n, v in vars(jtesting).items()
                         if not n.startswith("_") and not inspect.ismodule(v))
    assert testing.__all__ == jax_exports
    for name in testing.__all__:
        assert getattr(testing, name).__name__ == getattr(jtesting, name).__name__


# -- failing and chaos ----------------------------------------------------------


def _problem(dims=2):
    problem = vz.ProblemStatement()
    for j in range(dims):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(vz.MetricInformation(name="y"))
    return problem


def test_failing_designers():
    with pytest.raises(failing.FailedSuggestError):
        failing.FailingDesigner().suggest(1)
    inner = random_designer.RandomDesigner(_problem().search_space, seed=3)
    alternate = failing.AlternateFailingDesigner(inner)
    with pytest.raises(failing.FailedSuggestError):
        alternate.suggest(1)
    assert len(alternate.suggest(2)) == 2
    with pytest.raises(failing.FailedSuggestError):
        alternate.suggest(1)


def test_chaos_designer_resolves_a_chaos_program():
    inner = chaos_flushes.designer("cpu", 7)
    wrapped = chaos.ChaosDesigner(inner, chaos.ChaosMonkey(seed=0, failure_prob=0.0))
    program, key = registry.resolve(wrapped, 1)
    inner_program, inner_key = registry.resolve(inner, 1)
    assert isinstance(program, chaos.ChaosProgram)
    assert program.kind == inner_program.kind == key.kind == "gp_bandit"
    assert key == inner_key and program.algorithms == inner_program.algorithms
    assert program.shardable_batch_axis == inner_program.shardable_batch_axis == "study"
    assert program.matches_algorithm("GAUSSIAN_PROCESS_BANDIT")
    # Reads reach the inner designer; the crossover listener lands on it.
    assert wrapped.ard_train_counts == inner.ard_train_counts == {"cold": 0, "warm": 0}
    from vizier_tpu_torch.surrogates import config as surrogate_config

    seen = []
    surrogate_config.install_crossover_listener(wrapped, lambda a, b: seen.append((a, b)))
    surrogate_config.fire_crossover_hook(inner, "exact", "sparse")
    assert seen == [("exact", "sparse")]
    # A plain suggest strikes on "designer.suggest".
    monkey = chaos.ChaosMonkey(seed=0, failure_prob=1.0)
    with pytest.raises(failing.FailedSuggestError):
        chaos.ChaosDesigner(inner, monkey).suggest(1)
    assert monkey.counts() == {"designer.suggest": {"calls": 1, "faults": 1, "latencies": 0}}
    # A placement passes through to the inner program's device body.
    from vizier_tpu_torch.parallel.mesh import DevicePlacement

    placement = DevicePlacement(0, [torch.device("cpu")] * 2)
    quiet = chaos.ChaosDesigner(inner, chaos.ChaosMonkey(failure_prob=0.0))
    item = inner_program.prepare(inner, 1)
    (out,) = quiet.batch_execute([item], pad_to=placement.pad_to(1, 8), placement=placement)
    assert out["result"].features.continuous.shape == (1, 3)


def test_per_slot_strike_degrades_only_its_slot():
    out = chaos_flushes.per_slot_strike("cpu")
    assert out["faults"] == 1 and out["equal"] == [True, True]


def test_device_program_strike_runs_the_sequential_fallback():
    out = chaos_flushes.device_program_strike("cpu")
    assert out["faults"] == 1 and out["equal"] == [True, True]
    assert out["counters"]["batch_fallbacks"] == 2


class _Store:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args, **kwargs):
            self.calls.append(name)
            return name

        return method


@pytest.mark.parametrize("proxy", ["ChaosDataStore", "ChaosServiceStub"])
def test_proxies_strike_the_same_sites(proxy):
    outcomes = []
    for pkg in (jchaos, chaos):
        monkey = pkg.ChaosMonkey(seed=4, failure_prob=0.4)
        store = _Store()
        wrapped = getattr(pkg, proxy)(store, monkey)
        methods = list(getattr(pkg, proxy).DEFAULT_METHODS) + ["untouched"]
        seen = []
        for i in range(40):
            name = methods[i % len(methods)]
            try:
                seen.append(getattr(wrapped, name)(i))
            except pkg.InjectedFaultError:
                seen.append("fault")
        outcomes.append((seen, store.calls, monkey.counts()))
    assert outcomes[0] == outcomes[1]
    assert "fault" in outcomes[1][0]


# -- assertions, studies, runners -----------------------------------------------


_Pair = collections.namedtuple("_Pair", "a b")


@dataclasses.dataclass
class _Box:
    values: object
    scale: float


def test_numpy_assertions():
    tree = {"a": {"b": torch.arange(3.0), "c": np.ones(2)}, "d": 1.5}
    numpy_assertions.assert_arraytree_allclose(tree, {"a": {"b": np.arange(3.0), "c": np.ones(2)},
                                                      "d": 1.5})
    with pytest.raises(AssertionError):
        numpy_assertions.assert_arraytree_allclose(tree, {"a": {"b": np.arange(3.0) + 1,
                                                                "c": np.ones(2)}, "d": 1.5})
    with pytest.raises(AssertionError):
        numpy_assertions.assert_arraytree_allclose(tree, {"a": {}, "d": 1.5})
    t1 = [_Pair(torch.ones(2), None), _Box({"k": (1.0, np.zeros(2))}, 2.0)]
    t2 = [_Pair(np.ones(2), None), _Box({"k": (1.0 + 1e-9, torch.zeros(2))}, 2.0)]
    numpy_assertions.assert_pytree_allclose(t1, t2, rtol=1e-6)
    with pytest.raises(AssertionError, match="structures differ"):
        numpy_assertions.assert_pytree_allclose(t1, [_Pair(np.ones(2), None)])
    with pytest.raises(AssertionError):
        numpy_assertions.assert_pytree_allclose(t1, [_Pair(np.ones(2) * 2, None), t2[1]])
    # The JAX package's verdicts on numpy-only trees are the same.
    jtesting.assert_pytree_allclose({"x": [np.ones(2), 1.0]}, {"x": [np.ones(2), 1.0]})
    numpy_assertions.assert_pytree_allclose({"x": [np.ones(2), 1.0]}, {"x": [np.ones(2), 1.0]})


def _describe(space):
    return [(p.name, p.type.name, p.scale_type.name if p.scale_type else None,
             tuple(p.feasible_values) if p.type.name in ("CATEGORICAL", "DISCRETE")
             else p.bounds, len(p.children))
            for p in space.parameters]


@pytest.mark.parametrize("name", ["flat_space_with_all_types",
                                  "flat_continuous_space_with_scaling",
                                  "conditional_automl_space"])
def test_spaces_equal(name):
    assert _describe(getattr(test_studies, name)()) == _describe(getattr(jtest_studies, name)())


@pytest.mark.parametrize("name", ["metrics_objective_maximize", "metrics_multiobjective",
                                  "metrics_with_safety"])
def test_metrics_equal(name):
    def describe(metrics):
        return [(m.name, m.goal.name, m.safety_threshold) for m in metrics]

    assert describe(getattr(test_studies, name)()) == describe(getattr(jtest_studies, name)())


def test_random_metrics_runner_equal():
    trials = []
    for pkg_vz, runners, designers in ((vz, test_runners, random_designer),
                                       (jvz, jtest_runners, jrandom)):
        problem = pkg_vz.ProblemStatement(
            search_space=(test_studies if pkg_vz is vz else jtest_studies)
            .flat_space_with_all_types())
        problem.metric_information.append(pkg_vz.MetricInformation(name="m"))
        runner = runners.RandomMetricsRunner(problem, iters=4, batch_size=3, seed=2)
        out = runner.run_designer(designers.RandomDesigner(problem.search_space, seed=5))
        trials.append([(t.id, t.parameters.as_dict(), t.final_measurement.metrics["m"].value)
                       for t in out])
    assert trials[0] == trials[1] and len(trials[0]) == 12


def test_optimizer_test_utils_on_designer_as_optimizer():
    from vizier_tpu_torch.optimizers.lbfgsb_optimizer import DesignerAsOptimizer

    space = vz.SearchSpace()
    space.root.add_float_param("x", 0.0, 1.0)
    space.root.add_categorical_param("c", ["a", "b"])
    opt = DesignerAsOptimizer(
        designer_factory=lambda p: random_designer.RandomDesigner(p.search_space, seed=1),
        num_rounds=3, batch_size=5, device="cpu")
    optimizer_test_utils.assert_passes_on_random_single_metric_function(
        space, opt, np_random_seed=1)
    optimizer_test_utils.assert_passes_on_random_multi_metric_function(
        space, opt, np_random_seed=1)


# -- SimpleKD and the convergence gates -------------------------------------------


@pytest.mark.parametrize("category", ["corner", "center", "mixed"])
def test_simplekd_equal(category):
    port, jax_ = simplekd.SimpleKDExperimenter(category), jsimplekd.SimpleKDExperimenter(category)
    assert _describe(port.problem_statement().search_space) == _describe(
        jax_.problem_statement().search_space)
    assert port.optimal_value == jax_.optimal_value == 0.0
    rng = np.random.default_rng(3)
    params = [port.optimal_trial().parameters.as_dict()] + [
        {"categorical": str(rng.choice(["corner", "center", "mixed"])),
         "discrete": float(rng.choice([1.0, 2.0, 5.0])), "int": int(rng.integers(1, 5)),
         "float_0": float(rng.uniform(-1, 1)), "float_1": float(rng.uniform(-1, 1))}
        for _ in range(40)]
    trials = [vz.Trial(parameters=p) for p in params]
    jtrials = [jvz.Trial(parameters=p) for p in params]
    port.evaluate(trials)
    jax_.evaluate(jtrials)
    values = [t.final_measurement.metrics["value"].value for t in trials]
    assert values == [t.final_measurement.metrics["value"].value for t in jtrials]
    assert values[0] == 0.0
    with pytest.raises(ValueError):
        simplekd.SimpleKDExperimenter("edge")


def _gp_factory(problem, seed=None, **kw):
    from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit

    return VizierGPBandit(problem, rng_seed=seed or 0, max_acquisition_evaluations=1500,
                          ard_restarts=4, ard_optimizer=_FAST_ARD, num_seed_trials=5,
                          device="cpu")


def _ucb_pe_factory(problem, seed=None, **kw):
    from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit

    return VizierGPUCBPEBandit(problem, rng_seed=seed or 0, max_acquisition_evaluations=800,
                               ard_restarts=4, ard_optimizer=_FAST_ARD, num_seed_trials=5,
                               device="cpu")


@pytest.mark.parametrize("factory,max_abs_error", [(_gp_factory, 0.6), (_ucb_pe_factory, 0.8)],
                         ids=["gp_bandit", "gp_ucb_pe"])
def test_simplekd_convergence_gate(factory, max_abs_error):
    tester = simplekd_runner.SimpleKDConvergenceTester(
        num_trials=40, batch_size=5, max_abs_error=max_abs_error, seed=1)
    assert tester.assert_converges(factory) > -max_abs_error


def test_simplekd_tester_fails_a_random_designer():
    tester = simplekd_runner.SimpleKDConvergenceTester(num_trials=5, batch_size=5,
                                                       max_abs_error=0.0, seed=1)
    with pytest.raises(simplekd_runner.ConvergenceTestError):
        tester.assert_converges(
            lambda p, seed=None, **kw: random_designer.RandomDesigner(p.search_space, seed=seed))


def test_gp_bandit_beats_random_on_shifted_sphere():
    exp = wrappers.ShiftingExperimenter(
        NumpyExperimenter(bbob.Sphere, bbob_problem(4)),
        shift=np.array([1.0, -2.0, 0.5, 2.5]),
    )
    tester = comparator_runner.SimpleRegretComparisonTester(
        num_trials=25, num_repeats=2, tolerance=0.0)
    tester.assert_better_simple_regret(
        exp, candidate_factory=_gp_factory,
        baseline_factory=lambda p, **kw: random_designer.RandomDesigner(
            p.search_space, seed=kw.get("seed", 0)))
    with pytest.raises(comparator_runner.FailedComparisonTestError):
        tester.assert_better_simple_regret(
            exp, candidate_factory=lambda p, **kw: random_designer.RandomDesigner(
                p.search_space, seed=kw.get("seed", 0)),
            baseline_factory=_gp_factory)


def test_efficiency_score_equals_the_jax_package():
    from vizier_tpu.benchmarks import NumpyExperimenter as JNumpyExperimenter
    from vizier_tpu.benchmarks import bbob_problem as jbbob_problem
    from vizier_tpu.benchmarks.experimenters.synthetic import bbob as jbbob

    def random_factory(module):
        return lambda p, seed=None, **kw: module.RandomDesigner(p.search_space, seed=seed)

    kwargs = dict(num_trials=12, num_repeats=2, margin=10.0)
    score = comparator_runner.EfficiencyComparisonTester(**kwargs).assert_better_efficiency(
        NumpyExperimenter(bbob.Sphere, bbob_problem(3)), random_factory(random_designer),
        random_factory(random_designer), seed=3)
    jscore = jcomparator.EfficiencyComparisonTester(**kwargs).assert_better_efficiency(
        JNumpyExperimenter(jbbob.Sphere, jbbob_problem(3)), random_factory(jrandom),
        random_factory(jrandom), seed=3)
    assert score == pytest.approx(jscore, rel=1e-12, abs=1e-12)


# -- the service stress round ---------------------------------------------------------


def test_stress_round_through_the_in_process_service(monkeypatch):
    from vizier_tpu_torch.service import clients
    from vizier_tpu_torch.service import vizier_client
    from vizier_tpu_torch.testing import stress

    monkeypatch.setattr(vizier_client, "_local_servicer", None)
    monkeypatch.setattr(vizier_client.environment_variables, "device", "cpu")
    study = clients.Study.from_study_config(
        stress.stress_study_config(), owner="stress", study_id="round")
    wall, completed, per_worker = stress.run_stress_round(study, num_clients=4, trials_each=5)
    ids = [i for worker in per_worker for i in worker]
    assert completed == 20 and len(set(ids)) == 20 and wall > 0
