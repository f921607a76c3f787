"""The port's combinatorial problems and experimenter wrappers against the
JAX package's, on the CPU.

Both sides are the same host numpy code. From one seed, each experimenter
must give the same problem statement (parameter names, types, bounds,
feasible values, scale types, conditional children, metric names and
goals) and, on the same trials, the same metrics and infeasibility, bit
for bit (tolerance: none). The trials come from each package's
``RandomDesigner`` with one seed, and must themselves be equal.
``parse_wcnf`` gives the same arrays on the same text.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters import base as jbase
from vizier_tpu.benchmarks.experimenters import combinatorial as jcomb
from vizier_tpu.benchmarks.experimenters import wrappers as jwrap
from vizier_tpu.benchmarks.experimenters.synthetic import bbob as jbbob
from vizier_tpu.benchmarks.experimenters.synthetic import classic as jclassic
from vizier_tpu.designers import random as jrandom
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.benchmarks.experimenters import base as tbase
from vizier_tpu_torch.benchmarks.experimenters import combinatorial as tcomb
from vizier_tpu_torch.benchmarks.experimenters import wrappers as twrap
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob as tbbob
from vizier_tpu_torch.benchmarks.experimenters.synthetic import classic as tclassic
from vizier_tpu_torch.designers import random as trandom

_SIDES = {
    "jax": dict(vz=jvz, base=jbase, comb=jcomb, wrap=jwrap, bbob=jbbob, classic=jclassic,
                random=jrandom),
    "port": dict(vz=tvz, base=tbase, comb=tcomb, wrap=twrap, bbob=tbbob, classic=tclassic,
                 random=trandom),
}


def _param_signature(config) -> tuple:
    kind = config.type.name
    domain = (tuple(config.bounds) if kind in ("DOUBLE", "INTEGER")
              else tuple(config.feasible_values))
    children = tuple(sorted(
        (tuple(str(v) for v in child.matching_parent_values), _param_signature(child))
        for child in config.children))
    return (config.name, kind, config.external_type.name, domain,
            config.scale_type.name if config.scale_type is not None else None, children)


def problem_signature(problem) -> tuple:
    """Everything of a problem statement the designers and runners read."""
    return (tuple(_param_signature(p) for p in problem.search_space.parameters),
            tuple((m.name, m.goal.name, m.type.name) for m in problem.metric_information))


def _bits(value) -> bytes:
    return np.float64(value).tobytes()


def outcomes(trials) -> list:
    """Per trial: its parameters, its metrics' float64 bits, infeasibility."""
    out = []
    for t in trials:
        metrics = None
        if t.final_measurement is not None:
            metrics = sorted((name, _bits(m.value))
                             for name, m in t.final_measurement.metrics.items())
        out.append((sorted((k, str(v.value)) for k, v in t.parameters.items()), metrics,
                    t.infeasibility_reason))
    return out


def run_both(make, num_trials: int = 12, seed: int = 0, rounds: int = 1, sides=None):
    """Builds the experimenter on each side with ``make(side_modules)``,
    evaluates the same random trials (``rounds`` batches) and returns
    ({side: problem signature}, {side: outcomes}). ``sides`` maps each side
    to its modules (default: this file's)."""
    problems, results = {}, {}
    for side, mods in (sides or _SIDES).items():
        experimenter = make(mods)
        problem = experimenter.problem_statement()
        designer = mods["random"].RandomDesigner(problem.search_space, seed=seed)
        trials = []
        for r in range(rounds):
            batch = [s.to_trial(len(trials) + i + 1)
                     for i, s in enumerate(designer.suggest(num_trials))]
            experimenter.evaluate(batch)
            trials.extend(batch)
        problems[side] = problem_signature(problem)
        results[side] = outcomes(trials)
    return problems, results


def assert_same(make, **kw):
    problems, results = run_both(make, **kw)
    assert problems["port"] == problems["jax"]
    assert results["port"] == results["jax"]
    assert all(row[1] is not None or row[2] for row in results["port"])  # every trial completed
    return results["port"]


_COMBINATORIAL = {
    "ising": lambda m: m["comb"].IsingExperimenter(seed=1),
    "ising_3x3_lamda": lambda m: m["comb"].IsingExperimenter(lamda=0.1, grid_h=3, grid_w=3,
                                                             seed=7),
    "contamination": lambda m: m["comb"].ContaminationExperimenter(seed=2),
    "contamination_small": lambda m: m["comb"].ContaminationExperimenter(
        lamda=0.5, n_stages=8, seed=3, n_simulations=40),
    "centroid": lambda m: m["comb"].CentroidExperimenter(seed=3),
    "centroid_3x4": lambda m: m["comb"].CentroidExperimenter(n_choice=4, grid=(3, 4),
                                                              n_models=2, seed=5),
    "pest_control": lambda m: m["comb"].PestControlExperimenter(seed=4),
    "pest_control_small": lambda m: m["comb"].PestControlExperimenter(
        n_choice=3, n_stages=10, seed=6, n_simulations=50),
    "l1_categorical": lambda m: m["comb"].L1CategoricalExperimenter(
        num_categories=[2, 3, 5, 7], seed=8),
    "l1_categorical_optimum": lambda m: m["comb"].L1CategoricalExperimenter(
        num_categories=[4, 4, 4], optimum=[0, 3, 1]),
    "maxsat_60": lambda m: m["comb"].MAXSATExperimenter(
        m["comb"].random_wcnf(60, 200, np.random.default_rng(9))),
    "maxsat_unweighted": lambda m: m["comb"].MAXSATExperimenter(
        "p wcnf 4 3\n1 1 -2 0\n1 2 3 0\n1 -4 0\n"),
}


@pytest.mark.parametrize("name", sorted(_COMBINATORIAL))
def test_combinatorial_experimenters_are_bit_equal(name):
    assert_same(_COMBINATORIAL[name], num_trials=8, rounds=2)


def test_ising_helpers_are_bit_equal():
    values = {}
    for side, mods in _SIDES.items():
        comb = mods["comb"]
        rng = np.random.default_rng(11)
        inter = comb.random_ising_interaction(3, 4, rng)
        other = comb.random_ising_interaction(3, 4, rng)
        cov, log_z = comb.spin_covariance(inter, (3, 4))
        log_z_other = comb.log_partition(other, (3, 4))
        values[side] = [np.asarray(a).tobytes() for a in (*inter, cov)] + [
            _bits(log_z), _bits(log_z_other),
            _bits(comb.ising_kl_divergence(inter, other, cov, log_z, log_z_other, (3, 4)))]
    assert values["port"] == values["jax"]


def test_l1_categorical_optimal_trial_is_equal():
    got = {side: outcomes([_COMBINATORIAL["l1_categorical"](mods).optimal_trial])
           for side, mods in _SIDES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == [("objective", _bits(0.0))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_wcnf_and_parse_wcnf_are_equal(seed):
    texts, parsed = {}, {}
    for side, mods in _SIDES.items():
        texts[side] = mods["comb"].random_wcnf(30, 80, np.random.default_rng(seed),
                                               max_clause_len=4)
        n, *arrays = mods["comb"].parse_wcnf(texts["jax"])
        parsed[side] = (n, [(a.dtype.str, a.shape, a.tobytes()) for a in arrays])
    assert texts["port"] == texts["jax"]
    assert parsed["port"] == parsed["jax"]


@pytest.mark.parametrize("text", ["p wcnf 2 1\n1 3 0\n", "1 1 0\n", "p wcnf 2 1\n1 x 0\n"])
def test_parse_wcnf_refuses_what_the_jax_package_refuses(text):
    errors = {}
    for side, mods in _SIDES.items():
        with pytest.raises(ValueError) as info:
            mods["comb"].parse_wcnf(text)
        errors[side] = str(info.value)
    assert errors["port"] == errors["jax"]


def test_maxsat_evaluate_batch_is_bit_equal():
    x = np.random.default_rng(4).integers(0, 2, size=(32, 60)).astype(bool)
    got = {side: _COMBINATORIAL["maxsat_60"](mods).evaluate_batch(x).tobytes()
           for side, mods in _SIDES.items()}
    assert got["port"] == got["jax"]


# -- wrappers ------------------------------------------------------------------


def _sphere(m, dim=3):
    return m["base"].NumpyExperimenter(m["bbob"].Sphere, m["base"].bbob_problem(dim))


def _discretized(m, fn="Rastrigin", dim=3):
    inner = m["base"].NumpyExperimenter(getattr(m["bbob"], fn), m["base"].bbob_problem(dim))
    grid = {f"x{i}": [-4.0, -2.5, -1.0, 0.0, 0.5, 2.0, 3.5] for i in range(dim)}
    return m["wrap"].DiscretizingExperimenter(inner, grid)


def _extra_space(m):
    space = m["vz"].SearchSpace()
    space.root.add_float_param("lr", 1e-4, 1e-1, scale_type=m["vz"].ScaleType.LOG)
    space.root.add_int_param("units", 8, 64)
    space.root.add_categorical_param("act", ["relu", "tanh"])
    return space


def _named_sphere(m, names):
    problem = m["vz"].ProblemStatement()
    for name in names:
        problem.search_space.root.add_float_param(name, -2.0, 2.0)
    problem.metric_information.append(
        m["vz"].MetricInformation(name="value", goal=m["vz"].ObjectiveMetricGoal.MINIMIZE))
    return m["base"].NumpyExperimenter(m["bbob"].Sphere, problem)


def _float0_space(m):
    space = m["vz"].SearchSpace()
    space.root.add_float_param("float0", 0.0, 1.0)
    return space


_WRAPPERS = {
    "sign_flip": lambda m: m["wrap"].SignFlipExperimenter(_sphere(m)),
    "sign_flip_branin": lambda m: m["wrap"].SignFlipExperimenter(
        m["classic"].Branin2DExperimenter()),
    "normalizing": lambda m: m["wrap"].NormalizingExperimenter(_sphere(m), num_samples=20,
                                                               seed=3),
    "normalizing_discretized": lambda m: m["wrap"].NormalizingExperimenter(
        _discretized(m), seed=1),
    "infeasible": lambda m: m["wrap"].InfeasibleExperimenter(_sphere(m), infeasible_prob=0.4,
                                                             seed=5),
    "sparse_default": lambda m: m["wrap"].SparseExperimenter.create_default(
        _sphere(m), num_float=2, num_int=2, num_discrete=1, num_categorical=2),
    "sparse_float20": lambda m: m["wrap"].SparseExperimenter.create_default(
        _sphere(m, dim=20), num_float=20),
    "sparse_custom": lambda m: m["wrap"].SparseExperimenter(_sphere(m), _extra_space(m),
                                                            prefix="_X"),
    "sparse_infeasible_inside": lambda m: m["wrap"].SparseExperimenter.create_default(
        m["wrap"].InfeasibleExperimenter(_sphere(m), infeasible_prob=0.5, seed=2),
        num_categorical=3),
    "permuting": lambda m: m["wrap"].PermutingExperimenter(
        _discretized(m), ["x0", "x2"], seed=4),
    "permuting_categorical": lambda m: m["wrap"].PermutingExperimenter(
        m["comb"].L1CategoricalExperimenter(num_categories=[3, 4, 5], seed=1),
        ["c0", "c1", "c2"], seed=9),
    "switch": lambda m: m["wrap"].SwitchExperimenter(
        [m["classic"].Branin2DExperimenter(), _named_sphere(m, ["y0", "y1", "y2"]),
         m["comb"].L1CategoricalExperimenter(num_categories=[3, 4], seed=2)]),
    "switch_infeasible_member": lambda m: m["wrap"].SwitchExperimenter(
        [m["wrap"].InfeasibleExperimenter(_named_sphere(m, ["u", "v"]), infeasible_prob=0.6,
                                          seed=1),
         m["classic"].Branin2DExperimenter()], switch_param_name="which",
        metric_name="value"),
    "shifted_sign_flip": lambda m: m["wrap"].SignFlipExperimenter(
        m["wrap"].ShiftingExperimenter(_sphere(m), shift=np.array([0.5, -1.0, 2.0]))),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_are_bit_equal(name):
    assert_same(_WRAPPERS[name], num_trials=10, rounds=2, seed=1)


def test_sign_flip_negates_and_flips_the_goal():
    for side, mods in _SIDES.items():
        inner = _sphere(mods)
        flipped = mods["wrap"].SignFlipExperimenter(inner)
        assert (flipped.problem_statement().metric_information.item().goal
                != inner.problem_statement().metric_information.item().goal)
    results = assert_same(_WRAPPERS["sign_flip"], num_trials=4)
    plain = assert_same(lambda m: _sphere(m), num_trials=4)
    for (params, flipped, _), (_, raw, _) in zip(results, plain):
        assert np.frombuffer(flipped[0][1])[0] == -np.frombuffer(raw[0][1])[0]


def test_infeasible_wrapper_marks_the_same_trials():
    results = assert_same(_WRAPPERS["infeasible"], num_trials=30)
    infeasible = [row for row in results if row[1] is None]
    assert 0 < len(infeasible) < 30
    assert all(row[2] == "Randomly infeasible (benchmark wrapper)." for row in infeasible)


def test_sparse_default_at_the_phases_width_has_forty_floats():
    problems, _ = run_both(_WRAPPERS["sparse_float20"], num_trials=2)
    params = problems["port"][0]
    assert len(params) == 40 and all(p[1] == "DOUBLE" for p in params)


@pytest.mark.parametrize("make,error", [
    (lambda m: m["wrap"].PermutingExperimenter(_sphere(m), ["x0"]), ValueError),
    (lambda m: m["wrap"].SwitchExperimenter([]), ValueError),
    (lambda m: m["wrap"].SwitchExperimenter(
        [_sphere(m), m["wrap"].SignFlipExperimenter(_sphere(m))]), ValueError),
    (lambda m: m["wrap"].SparseExperimenter(
        m["wrap"].SparseExperimenter.create_default(_sphere(m), num_float=1),
        _float0_space(m)), ValueError),
], ids=["permute_a_double", "switch_of_none", "switch_mixed_goals", "sparse_collision"])
def test_wrappers_refuse_what_the_jax_package_refuses(make, error):
    messages = {}
    for side, mods in _SIDES.items():
        with pytest.raises(error) as info:
            make(mods)
        messages[side] = str(info.value)
    assert messages["port"] == messages["jax"]
