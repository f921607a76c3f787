"""The port's host algorithms and their service routes against the JAX
package's, on the CPU.

Random, the random-sampling helpers, ``RandomPolicy`` and Grid are numpy on
the host in both packages: from one seed, over the same completed trials,
they must give the same parameters, value for value (tolerance: none). The
JSON format of designer state is byte-compatible, and a Grid walk dumped by
one package resumes in the other with the same next points. The port's
factory gives every algorithm name the JAX factory serves a policy of the
same class, except PYGLOVE, which it refuses. regret_suite.py's baselines
for seed 1 equal ``regret_suite_baselines_5seed.json``'s (the JAX package's
runs) exactly, and the rank gate over all five seeds holds.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.algorithms import random_policy as jrandom_policy
from vizier_tpu.algorithms import random_sample as jrandom_sample
from vizier_tpu.designers import grid as jgrid
from vizier_tpu.designers import random as jrandom
from vizier_tpu.pythia import local_policy_supporters as jlps
from vizier_tpu.pythia import policy as jpolicy
from vizier_tpu.service import policy_factory as jfactory
from vizier_tpu.utils import json_utils as jjson
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import random_policy as trandom_policy
from vizier_tpu_torch.algorithms import random_sample as trandom_sample
from vizier_tpu_torch.benchmarks import regret
from vizier_tpu_torch.designers import grid as tgrid
from vizier_tpu_torch.designers import quasi_random as tqr
from vizier_tpu_torch.designers import random as trandom
from vizier_tpu_torch.pythia import local_policy_supporters as tlps
from vizier_tpu_torch.pythia import policy as tpolicy
from vizier_tpu_torch.pyvizier import parameter_config as tpc
from vizier_tpu_torch.pyvizier import study_config as tstudy_config
from vizier_tpu_torch.service import policy_factory as tfactory
from vizier_tpu_torch.utils import json_utils as tjson

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _values(suggestions):
    return [s.parameters.as_dict() for s in suggestions]


def _conditional_space(vz):
    """A conditional space with every parameter type and scale under it."""
    space = vz.SearchSpace()
    root = space.root
    model = root.add_categorical_param("model", ["linear", "dnn", "tree"])
    dnn = model.select_values(["dnn"])
    dnn.add_float_param("lr", 1e-4, 1.0, scale_type=vz.ScaleType.LOG)
    dnn.add_int_param("layers", 1, 6)
    space.select("model").select_values(["linear"]).add_float_param(
        "l2", 1e-6, 1.0, scale_type=vz.ScaleType.REVERSE_LOG)
    tree = space.select("model").select_values(["tree"])
    tree.add_discrete_param("depth", [2, 4, 8, 16])
    root.add_float_param("momentum", 0.0, 0.99)
    root.add_bool_param("nesterov")
    return space


def _flat_space(vz):
    space = vz.SearchSpace()
    root = space.root
    root.add_float_param("x", 0.0, 1.0)
    root.add_float_param("lr", 1e-3, 1.0, scale_type=vz.ScaleType.LOG)
    root.add_int_param("i", 1, 3)
    root.add_categorical_param("c", ["a", "b"])
    root.add_discrete_param("d", [0.5, 1.0, 4.0])
    return space


# -- json_utils --------------------------------------------------------------


def test_json_state_is_byte_compatible():
    state = {
        "xs": np.random.default_rng(0).uniform(size=(3, 4)),
        "cats": np.arange(6, dtype=np.int32).reshape(3, 2),
        "empty": np.zeros((0, 5)),
        "rewards": [1.5, -np.inf, np.float64(2.0)],
        "n": np.int64(7), "flag": np.bool_(True), "f": np.float32(0.1),
    }
    text = tjson.dumps(state)
    assert text == jjson.dumps(state)
    for loads in (tjson.loads, jjson.loads):
        back = loads(text)
        assert back["xs"].tobytes() == state["xs"].tobytes()
        assert back["cats"].dtype == np.int32 and back["empty"].shape == (0, 5)
        assert back["rewards"] == [1.5, -np.inf, 2.0] and back["n"] == 7
    assert json.loads(text, cls=tjson.NumpyDecoder)["cats"].tolist() == [[0, 1], [2, 3], [4, 5]]


# -- Random --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_designer_samples_the_conditional_space_identically(seed):
    jd = jrandom.RandomDesigner(_conditional_space(jvz), seed=seed)
    td = trandom.RandomDesigner(_conditional_space(tvz), seed=seed)
    for count in (1, 5, 12):
        assert _values(td.suggest(count)) == _values(jd.suggest(count))


def test_unit_to_double_has_one_home_shared_by_quasi_random_and_grid():
    assert tqr.unit_to_double is trandom.unit_to_double
    assert tgrid.random_designer.unit_to_double is trandom.unit_to_double
    space_j, space_t = _flat_space(jvz), _flat_space(tvz)
    for cj, ct in zip(space_j.parameters, space_t.parameters):
        if ct.type == tpc.ParameterType.DOUBLE:
            for u in np.linspace(0.0, 1.0, 11):
                assert trandom.unit_to_double(ct, u) == jrandom.unit_to_double(cj, u)


def test_random_sample_helpers_draw_identically():
    space_j, space_t = _flat_space(jvz), _flat_space(tvz)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        assert (trandom_sample.sample_parameters(rt, space_t).as_dict()
                == jrandom_sample.sample_parameters(rj, space_j).as_dict())
        for cj, ct in zip(space_j.parameters, space_t.parameters):
            assert trandom_sample.sample_value(rt, ct) == jrandom_sample.sample_value(rj, cj)
        assert (trandom_sample.sample_bernoulli(rt, 0.3, "a", "b")
                == jrandom_sample.sample_bernoulli(rj, 0.3, "a", "b"))
        assert trandom_sample.sample_integer(rt, 1, 9) == jrandom_sample.sample_integer(rj, 1, 9)
        assert (trandom_sample.shuffle_list(rt, list(range(8)))
                == jrandom_sample.shuffle_list(rj, list(range(8))))
    assert trandom_sample.get_closest_element([1.0, 3.0, 9.0], 5.5) == 3.0


def _random_policy_run(vz, sc, lps, policy_mod, policy_lib):
    config = sc.StudyConfig()
    config.search_space = _conditional_space(vz)
    config.metric_information.append(vz.MetricInformation(name="y"))
    supporter = lps.InRamPolicySupporter(config)
    policy = policy_mod.RandomPolicy(supporter, seed=5)
    trials = supporter.SuggestTrials(policy, 4) + supporter.SuggestTrials(policy, 3)
    stops = policy.early_stop(policy_lib.EarlyStopRequest(
        study_descriptor=supporter.study_descriptor(), trial_ids=[t.id for t in trials]))
    return ([t.parameters.as_dict() for t in trials],
            [(d.id, d.should_stop) for d in stops.decisions])


def test_random_policy_suggests_and_stops_identically():
    from vizier_tpu.pyvizier import study_config as jstudy_config

    got = _random_policy_run(tvz, tstudy_config, tlps, trandom_policy, tpolicy)
    want = _random_policy_run(jvz, jstudy_config, jlps, jrandom_policy, jpolicy)
    assert got == want
    assert sum(stop for _, stop in got[1]) == 1


# -- Grid ------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle_seed", [None, 0, 3])
def test_grid_walks_identically(shuffle_seed):
    jd = jgrid.GridSearchDesigner(_flat_space(jvz), shuffle_seed=shuffle_seed,
                                  double_grid_resolution=4)
    td = tgrid.GridSearchDesigner(_flat_space(tvz), shuffle_seed=shuffle_seed,
                                  double_grid_resolution=4)
    assert td.grid_size == jd.grid_size == 4 * 4 * 3 * 2 * 3
    for count in (1, 7, 50, 300):  # past the end: both stop at the grid's size
        assert _values(td.suggest(count)) == _values(jd.suggest(count))
    assert td.suggest(3) == jd.suggest(3) == []


@pytest.mark.parametrize("shuffle_seed", [None, 0])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_grid_state_crosses_packages(shuffle_seed, direction):
    make = {"jax": lambda seed: jgrid.GridSearchDesigner(_flat_space(jvz), shuffle_seed=seed),
            "port": lambda seed: tgrid.GridSearchDesigner(_flat_space(tvz), shuffle_seed=seed)}
    src, dst = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    writer = make[src](shuffle_seed)
    writer.suggest(13)
    # The reader was built with another seed: the stored walk governs.
    reader = make[dst](None if shuffle_seed is not None else 9)
    metadata = (tvz if dst == "port" else jvz).Metadata()
    metadata["grid"] = writer.dump()["grid"]
    reader.load(metadata)
    assert _values(reader.suggest(9)) == _values(writer.suggest(9))


def test_grid_rejects_a_conditional_space_as_the_reference():
    with pytest.raises(ValueError, match="flat"):
        jgrid.GridSearchDesigner(_conditional_space(jvz))
    with pytest.raises(ValueError, match="flat"):
        tgrid.GridSearchDesigner(_conditional_space(tvz))


# -- the factory ----------------------------------------------------------------

_JAX_ROUTES = ("DEFAULT", "GP_UCB_PE", "ALGORITHM_UNSPECIFIED", "GAUSSIAN_PROCESS_BANDIT",
               "RANDOM_SEARCH", "QUASI_RANDOM_SEARCH", "GRID_SEARCH", "SHUFFLED_GRID_SEARCH",
               "NSGA2", "EAGLE_STRATEGY", "CMA_ES", "BOCS", "HARMONICA")


def _study(vz, study_config_mod, algorithm):
    config = study_config_mod.StudyConfig(algorithm=algorithm)
    for j in range(3):
        config.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    config.metric_information.append(vz.MetricInformation(
        name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return config


@pytest.mark.parametrize("algorithm", _JAX_ROUTES)
def test_every_route_has_the_reference_policy_class(algorithm):
    from vizier_tpu.pyvizier import study_config as jstudy_config

    jconfig = _study(jvz, jstudy_config, algorithm)
    tconfig = _study(tvz, tstudy_config, algorithm)
    jpol = jfactory.DefaultPolicyFactory()(
        jconfig.to_problem(), algorithm, jlps.InRamPolicySupporter(jconfig), "s")
    tpol = tfactory.DefaultPolicyFactory(device="cpu")(
        tconfig.to_problem(), algorithm, tlps.InRamPolicySupporter(tconfig), "s")
    assert type(tpol).__name__ == type(jpol).__name__
    assert algorithm in tfactory.SERVED


def test_only_pyglove_is_refused_and_the_error_lists_what_is_served():
    assert tfactory.NOT_PORTED == ("PYGLOVE",)
    assert set(tfactory.SERVED) == set(_JAX_ROUTES)
    config = _study(tvz, tstudy_config, "PYGLOVE")
    with pytest.raises(tfactory.AlgorithmNotPortedError) as info:
        tfactory.DefaultPolicyFactory(device="cpu")(
            config.to_problem(), "PYGLOVE", tlps.InRamPolicySupporter(config), "s")
    assert all(name in str(info.value) for name in _JAX_ROUTES)


@pytest.mark.parametrize("algorithm", ["GRID_SEARCH", "SHUFFLED_GRID_SEARCH",
                                       "QUASI_RANDOM_SEARCH"])
def test_seeded_routes_serve_the_reference_suggestions(algorithm):
    """Two requests through each package's factory and supporter (the
    second restores the state the first wrote into the study)."""
    from vizier_tpu.pyvizier import study_config as jstudy_config

    out = []
    for vz, sc, lps, factory in ((jvz, jstudy_config, jlps, jfactory.DefaultPolicyFactory()),
                                 (tvz, tstudy_config, tlps,
                                  tfactory.DefaultPolicyFactory(device="cpu"))):
        config = _study(vz, sc, algorithm)
        supporter = lps.InRamPolicySupporter(config)
        policy = factory(config.to_problem(), algorithm, supporter, "s")
        trials = supporter.SuggestTrials(policy, 4)
        for t in trials:
            t.complete(vz.Measurement(metrics={"y": float(t.parameters.get_value("x0"))}))
        trials += supporter.SuggestTrials(policy, 4)
        out.append([t.parameters.as_dict() for t in trials])
    assert out[0] == out[1]


@pytest.mark.parametrize("algorithm", ["RANDOM_SEARCH", "NSGA2", "EAGLE_STRATEGY", "CMA_ES"])
def test_unseeded_routes_serve_feasible_points_and_keep_their_state(algorithm):
    config = _study(tvz, tstudy_config, algorithm)
    supporter = tlps.InRamPolicySupporter(config)
    policy = tfactory.DefaultPolicyFactory(device="cpu")(
        config.to_problem(), algorithm, supporter, "s")
    for _ in range(3):
        trials = supporter.SuggestTrials(policy, 5)
        assert len(trials) == 5
        regret.check_suggestions(trials, config.to_problem(), algorithm)
        for t in trials:
            x = np.array([t.parameters.get_value(f"x{j}") for j in range(3)])
            t.complete(tvz.Measurement(metrics={"y": float(-np.sum((x - 0.3) ** 2))}))
    if algorithm in ("NSGA2", "EAGLE_STRATEGY"):
        state = supporter.GetStudyConfig().metadata.ns("designer_policy_v0")
        assert state.get("designer") is not None


# -- regret_suite.py's baselines --------------------------------------------------


def _reference():
    return json.loads((_ROOT / "regret_suite_baselines_5seed.json").read_text())


@pytest.mark.parametrize("name", sorted(regret.BASELINES))
def test_baseline_seed_one_equals_the_jax_reference(name):
    run, _ = regret.BASELINES[name]
    reference = _reference()
    assert reference["seeds"][0] == 1
    assert run(1, "cpu") == reference["configs"][name]["per_seed"][0]


def test_baseline_gate_holds_at_the_reference_and_fails_a_worse_run():
    reference = _reference()["configs"]
    same = {name: list(cfg["per_seed"]) for name, cfg in reference.items()}
    assert all(row["passed"] and row["max_abs_diff"] == 0.0
               for row in regret.baseline_parity(same).values())
    worse = {"branin_random": [v + 100.0 for v in same["branin_random"]],
             "zdt1_nsga2": [v - 100.0 for v in same["zdt1_nsga2"]]}
    rows = regret.baseline_parity(worse)
    assert not rows["branin_random"]["passed"] and not rows["zdt1_nsga2"]["passed"]
    assert rows["branin_random"]["p"] == pytest.approx(1 / 252)


def test_exact_two_dimensional_hypervolume():
    points = np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [np.nan, 2.0], [-2.0, 3.0]])
    # Above (-1, -1), a staircase of three steps (widths 0.5, 0.5, 1 at
    # heights 1, 1.5, 2); the NaN row and the row left of -1 add nothing.
    assert regret.hypervolume_2d(points, (-1.0, -1.0)) == 0.5 * 1.0 + 0.5 * 1.5 + 1.0 * 2.0
    assert regret.hypervolume_2d(points, (5.0, 5.0)) == 0.0


def test_a_twenty_dimensional_shuffled_grid_is_refused_by_both_packages():
    """ROADMAP C12: 20 floats at resolution 10 are 10^20 grid points. The
    size overflows int64 alike in both packages and the unshuffled walk is
    the same; the shuffled order, a permutation of every point, cannot be
    built in either."""
    def space(vz):
        s = vz.SearchSpace()
        for j in range(20):
            s.root.add_float_param(f"x{j}", 0.0, 1.0)
        return s

    jd, td = jgrid.GridSearchDesigner(space(jvz)), tgrid.GridSearchDesigner(space(tvz))
    assert td.grid_size == jd.grid_size != 10**20
    assert _values(td.suggest(12)) == _values(jd.suggest(12))
    for mod, vz in ((jgrid, jvz), (tgrid, tvz)):
        with pytest.raises(ValueError, match="too big"):
            mod.GridSearchDesigner(space(vz), shuffle_seed=0)
