"""The port's NASBench-101, tabular surrogates, HPO-B, NASBench-201,
Atari-100k and Predictor experimenters against the JAX package's, on the
CPU.

All of them are host numpy (and ``hashlib``) in both packages, so the same
inputs give the same outputs bit for bit (tolerance: none): ModelSpec
pruning and graph hashes on seeded random DAGs, ``synthetic_nasbench101``'s
tables, the experimenters' problem statements and their metrics and
infeasibility on the same trials, the HPO-B fixture read by both handlers
(splits, the discrete and continuous protocols' traces, the tabular
snaps), the NASBench-201 synthetic tables, the Atari-100k space, JSON
tables and gates (the error texts the JAX package's, but for the port naming
no install image), and ``PredictorExperimenter`` over a deterministic stub
predictor. ``PredictorExperimenter`` over the port's GP bandit gives its
``predict`` mean for the same rng.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
from test_torch_combinatorial import assert_same as _assert_same
from test_torch_combinatorial import outcomes, problem_signature

from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters import nasbench101 as jnb
from vizier_tpu.benchmarks.experimenters import surrogates as jsur
from vizier_tpu.designers import random as jrandom
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import core as tcore
from vizier_tpu_torch.benchmarks.experimenters import nasbench101 as tnb
from vizier_tpu_torch.benchmarks.experimenters import surrogates as tsur
from vizier_tpu_torch.designers import gp_bandit as tgb
from vizier_tpu_torch.designers import random as trandom
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs

_SIDES = {
    "jax": dict(vz=jvz, nb=jnb, sur=jsur, random=jrandom),
    "port": dict(vz=tvz, nb=tnb, sur=tsur, random=trandom),
}


def assert_same(make, **kw):
    return _assert_same(make, sides=_SIDES, **kw)


# The port's error messages name no install image; otherwise they are the
# JAX package's text.
_PORT_WORDING = {"this image bundles no benchmark data": "the repository ships no benchmark data",
                 "(absent from this image)": "(not installed)"}


def port_wording(texts):
    """The JAX package's messages as the port words them."""
    out = []
    for text in texts:
        for jax_text, port_text in _PORT_WORDING.items():
            text = text.replace(jax_text, port_text)
        out.append(text)
    return out


def _random_spec(nb, rng):
    n = int(rng.integers(2, nb.NUM_VERTICES + 1))
    matrix = np.triu((rng.uniform(size=(n, n)) < 0.45).astype(int), 1)
    ops = [nb.INPUT_OP] + [nb.ALLOWED_OPS[i] for i in rng.integers(0, 3, n - 2)] + [
        nb.OUTPUT_OP]
    return nb.ModelSpec(matrix=matrix, ops=ops)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_model_spec_pruning_and_hashes_are_equal(seed):
    got = {}
    for side, m in _SIDES.items():
        rng = np.random.default_rng(seed)
        rows = []
        for _ in range(60):
            spec = _random_spec(m["nb"], rng)
            pruned = spec.pruned()
            rows.append((spec.graph_hash(), None if pruned is None else (
                pruned.matrix.tobytes(), pruned.matrix.shape, list(pruned.ops))))
        got[side] = rows
    assert got["port"] == got["jax"]
    assert any(row[1] is None for row in got["port"]) and any(row[1] for row in got["port"])


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_nasbench101_tables_are_equal(seed):
    tables = {}
    for side, m in _SIDES.items():
        api, specs = m["nb"].synthetic_nasbench101(num_cells=48, seed=seed)
        tables[side] = (json.dumps(api._table, sort_keys=True),
                        [s.graph_hash() for s in specs],
                        [api.is_valid(s) for s in specs])
    assert tables["port"] == tables["jax"]
    assert all(tables["port"][2])


def _nasbench(m):
    api, _ = m["nb"].synthetic_nasbench101(num_cells=32, seed=1)
    return m["nb"].NASBench101Experimenter(api)


class _TableCells:
    """Every other trial one of the table's own cells, so some are feasible."""

    def __init__(self, m):
        self._api, self._specs = m["nb"].synthetic_nasbench101(num_cells=32, seed=1)
        self._exp = m["nb"].NASBench101Experimenter(self._api)

    def problem_statement(self):
        return self._exp.problem_statement()

    def evaluate(self, trials):
        for i, t in enumerate(trials):
            if i % 2:
                continue
            spec = self._specs[(t.id * 7) % len(self._specs)]
            for y in range(7):
                for x in range(y):
                    t.parameters[f"{x}_{y}"] = str(bool(spec.matrix[x][y]))
            for k in range(5):
                t.parameters[f"ops_{k}"] = spec.ops[k + 1]
        self._exp.evaluate(trials)


def test_nasbench101_experimenter_is_bit_equal():
    results = assert_same(_TableCells, num_trials=16, rounds=2)
    feasible = [row for row in results if row[1] is not None]
    assert 0 < len(feasible) < len(results)
    assert all(row[2] == "Not in search space." for row in results if row[1] is None)
    assert all(len(row[1]) == len(jnb.METRIC_NAMES) for row in feasible)


def test_nasbench101_problem_has_twenty_six_finite_parameters():
    problems = {side: problem_signature(_nasbench(m).problem_statement())
                for side, m in _SIDES.items()}
    assert problems["port"] == problems["jax"]
    params = problems["port"][0]
    assert len(params) == 26 and sum(p[2] == "BOOLEAN" for p in params) == 21


def test_nasbench101_table_file_round_trips(tmp_path):
    api, _ = jnb.synthetic_nasbench101(num_cells=8, seed=2)
    path = tmp_path / "nasbench.json"
    path.write_text(json.dumps(api._table))
    loaded = {side: m["nb"].TabularNASBench101.from_file(str(path))._table
              for side, m in _SIDES.items()}
    assert loaded["port"] == loaded["jax"] == api._table
    messages = {}
    for side, m in _SIDES.items():
        with pytest.raises(FileNotFoundError) as info:
            m["nb"].TabularNASBench101.from_file(str(tmp_path / "absent.json"))
        messages[side] = str(info.value)
    assert [messages["port"]] == port_wording([messages["jax"]])


# -- tabular snaps -------------------------------------------------------------


def _mixed_table(m, num_rows=40):
    vz = m["vz"]
    problem = vz.ProblemStatement()
    root = problem.search_space.root
    root.add_float_param("lr", 1e-4, 1e-1, scale_type=vz.ScaleType.LOG)
    root.add_float_param("momentum", 0.0, 1.0)
    root.add_int_param("layers", 1, 8)
    root.add_categorical_param("opt", ["adam", "sgd", "rmsprop"])
    problem.metric_information.append(
        vz.MetricInformation(name="acc", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    rng = np.random.default_rng(7)
    # Two of the three optimizers only: a suggestion with the third snaps
    # to no row and completes infeasible.
    rows = [{"lr": float(10 ** rng.uniform(-4, -1)), "momentum": float(rng.uniform()),
             "layers": int(rng.integers(1, 9)), "opt": ["adam", "sgd"][int(rng.integers(2))]}
            for _ in range(num_rows)]
    objectives = rng.normal(size=num_rows)
    return m["sur"].TabularSurrogateExperimenter(problem, rows, objectives)


def test_tabular_snaps_are_bit_equal():
    results = assert_same(_mixed_table, num_trials=20, rounds=2)
    assert any(row[1] is None for row in results) and any(row[1] for row in results)


def test_tabular_snap_returns_a_rows_own_value():
    for side, m in _SIDES.items():
        experimenter = _mixed_table(m)
        trial = m["vz"].Trial(id=1, parameters={"lr": 1e-3, "momentum": 0.5, "layers": 3,
                                                "opt": "sgd"})
        experimenter.evaluate([trial])
        assert trial.final_measurement.metrics["acc"].value in set(
            experimenter._objectives.tolist())


# -- HPO-B ---------------------------------------------------------------------


@pytest.fixture
def hpob_root(tmp_path):
    """The JAX package's HPO-B fixture (tests/benchmarks/test_nasbench101_and_hpob.py),
    with the continuous protocol's summary statistics."""
    xs = [[0.1, 0.2], [0.4, 0.5], [0.9, 0.1], [0.3, 0.8], [0.6, 0.6], [0.2, 0.9]]
    ys = [[1.0], [3.0], [2.0], [5.0], [4.0], [0.5]]
    files = {
        "meta-test-dataset.json": {"5860": {"145833": {"X": xs, "y": ys}}},
        "meta-train-dataset.json": {"5860": {"300": {"X": xs[:3], "y": ys[:3]}}},
        "meta-train-dataset-augmented.json": {"5860": {"300aug": {"X": xs[:4], "y": ys[:4]}}},
        "meta-validation-dataset.json": {"5860": {"400": {"X": xs[1:4], "y": ys[1:4]}}},
        "bo-initializations.json": {"5860": {"145833": {
            s: [0, 1, 2, 3, 4] for s in jsur.HPOBHandler.SEEDS}}},
    }
    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content))
    (tmp_path / "summary-stats.json").write_text(
        json.dumps({"surrogate-5860-145833": {"y_min": 0.0, "y_max": 10.0}}))
    return str(tmp_path)


@pytest.mark.parametrize("mode", ["v1", "v2", "v3", "v3-test", "v3-train-augmented"])
def test_hpob_handlers_read_the_same_splits(hpob_root, mode):
    got = {}
    for side, m in _SIDES.items():
        handler = m["sur"].HPOBHandler(root_dir=hpob_root, mode=mode)
        handler._ensure_loaded()
        got[side] = json.dumps([handler.meta_train_data, handler.meta_validation_data,
                                handler.meta_test_data, handler.bo_initializations],
                               sort_keys=True)
    assert got["port"] == got["jax"]


class _PickLast:
    def observe_and_suggest(self, x_obs, y_obs, x_pen=None):
        if x_pen is not None:
            return len(x_pen) - 1
        return np.clip(np.mean(x_obs, axis=0) + 0.05 * len(x_obs), 0.0, 1.0)


@pytest.mark.parametrize("seed", list(jsur.HPOBHandler.SEEDS[:2]))
def test_hpob_protocols_give_the_same_traces(hpob_root, seed):
    got = {}
    for side, m in _SIDES.items():
        handler = m["sur"].HPOBHandler(root_dir=hpob_root, mode="v3-test",
                                       surrogates_dir=hpob_root)
        discrete = handler.evaluate(_PickLast(), "5860", "145833", seed, n_trials=1)
        continuous = handler.evaluate_continuous(
            _PickLast(), "5860", "145833", seed, n_trials=4,
            predictor=lambda x: 10.0 - 3.0 * np.sum((x - 0.5) ** 2, axis=-1))
        got[side] = np.asarray(discrete + continuous).tobytes()
    assert got["port"] == got["jax"]


def test_hpob_experimenters_snap_the_same(hpob_root):
    def make(m):
        return m["sur"].HPOBHandler(root_dir=hpob_root).make_experimenter("5860", "145833")

    results = assert_same(make, num_trials=12, rounds=2)
    assert all(row[1] is not None for row in results)


def test_hpob_gates_raise_the_same_errors(hpob_root):
    messages = {}
    for side, m in _SIDES.items():
        handler = m["sur"].HPOBHandler(root_dir=hpob_root, surrogates_dir=hpob_root)
        errors = []
        for call in (lambda: m["sur"].HPOBHandler(mode="v4"),
                     lambda: m["sur"].HPOBHandler(root_dir=None).make_experimenter("a", "b"),
                     lambda: handler.evaluate(object(), "5860", "145833", "test0"),
                     lambda: handler.surrogate_predictor("5860", "145833")):
            with pytest.raises((ValueError, FileNotFoundError, ImportError)) as info:
                call()
            errors.append((type(info.value).__name__, str(info.value)))
        messages[side] = errors
    assert [kind for kind, _ in messages["port"]] == [kind for kind, _ in messages["jax"]]
    assert [text for _, text in messages["port"]] == port_wording(
        text for _, text in messages["jax"])


# -- NASBench-201 and Atari-100k ----------------------------------------------


@pytest.mark.parametrize("num_rows", [None, 300])
def test_nasbench201_synthetic_experimenters_are_bit_equal(num_rows):
    def make(m):
        return m["sur"].NASBench201Handler().make_synthetic_experimenter(num_rows=num_rows,
                                                                         seed=3)

    results = assert_same(make, num_trials=12, rounds=2)
    if num_rows is None:
        assert all(row[1] is not None for row in results)  # every cell is tabulated


def test_nasbench201_table_file_is_served_the_same(tmp_path):
    rng = np.random.default_rng(0)
    ops = jsur.NASBench201Handler.OPS
    table = [dict({f"op{i}": ops[int(rng.integers(5))] for i in range(6)},
                  accuracy=float(rng.uniform(50, 95))) for _ in range(64)]
    path = tmp_path / "nb201.json"
    path.write_text(json.dumps(table))
    assert_same(lambda m: m["sur"].NASBench201Handler(data_path=str(path)).make_experimenter(),
                num_trials=10)


def test_atari100k_spaces_are_equal():
    spaces = {side: problem_signature(m["sur"].Atari100kExperimenter().problem_statement())
              for side, m in _SIDES.items()}
    assert spaces["port"] == spaces["jax"]
    assert len(spaces["port"][0]) == 14


def _atari_table(tmp_path):
    rng = np.random.default_rng(0)
    rows = [{"create_optimizer.learning_rate": float(10 ** rng.uniform(-5, -2)),
             "JaxDQNAgent.update_horizon": int(rng.integers(1, 21)),
             "JaxFullRainbowAgent.noisy": ["True", "False"][int(rng.integers(2))],
             "eval_average_return": float(rng.normal())} for _ in range(24)]
    path = tmp_path / "atari.json"
    path.write_text(json.dumps(rows))
    return str(path)


def test_atari100k_json_tables_are_served_the_same(tmp_path):
    path = _atari_table(tmp_path)
    problems = {side: problem_signature(m["sur"].Atari100kHandler(data_path=path)
                                        .problem_statement()) for side, m in _SIDES.items()}
    assert problems["port"] == problems["jax"]
    assert_same(lambda m: m["sur"].Atari100kHandler(data_path=path).make_experimenter(),
                num_trials=10, rounds=2)


def test_atari100k_gates_raise_the_same_errors(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"bogus": 1.0, "score": 0.5}]))
    messages = {}
    for side, m in _SIDES.items():
        trial = m["vz"].Trial(id=1, parameters={"JaxDQNAgent.update_horizon": 3})
        errors = []
        for call in (lambda: m["sur"].Atari100kExperimenter().evaluate([trial]),
                     lambda: m["sur"].Atari100kExperimenter(agent_name="Rainbow9000"),
                     lambda: m["sur"].Atari100kHandler().make_experimenter(),
                     lambda: m["sur"].Atari100kHandler(data_path=str(bad)).make_experimenter()):
            with pytest.raises((ImportError, ValueError, FileNotFoundError)) as info:
                call()
            errors.append((type(info.value).__name__, str(info.value)))
        messages[side] = errors
        assert m["sur"]._gin_native_value("JaxFullRainbowAgent.noisy", "False") is False
    assert [kind for kind, _ in messages["port"]] == [kind for kind, _ in messages["jax"]]
    assert [text for _, text in messages["port"]] == port_wording(
        text for _, text in messages["jax"])


# -- Predictor -----------------------------------------------------------------


class _StubPredictor:
    """A deterministic Predictor: the mean is a fixed function of the
    parameters plus one draw of the rng (so the rng's use is held too)."""

    def __init__(self, core):
        self._core = core

    def predict(self, suggestions, rng):
        shift = rng.uniform()
        mean = np.array([[sum(float(v.value) for v in s.parameters.values()) + shift]
                         for s in suggestions])
        return self._core.Prediction(mean=mean, stddev=np.zeros_like(mean))


def _float_problem(vz, dim=3):
    problem = vz.ProblemStatement()
    for i in range(dim):
        problem.search_space.root.add_float_param(f"x{i}", -1.0, 2.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return problem


def test_predictor_experimenter_over_a_stub_is_bit_equal():
    from vizier_tpu.algorithms import core as jcore

    cores = {"jax": jcore, "port": tcore}

    def make(m):
        core = cores["jax" if m["vz"] is jvz else "port"]
        return m["sur"].PredictorExperimenter(_StubPredictor(core), _float_problem(m["vz"]),
                                              seed=5)

    assert_same(make, num_trials=6, rounds=3)
    for side, m in _SIDES.items():
        problem = _float_problem(m["vz"])
        problem.metric_information.append(m["vz"].MetricInformation(name="other"))
        with pytest.raises(ValueError, match="single-objective"):
            m["sur"].PredictorExperimenter(_StubPredictor(cores[side]), problem)


def test_predictor_experimenter_gives_the_gp_bandits_predict_mean():
    """What the card's benchmarks phase checks: the experimenter's values
    are ``predict``'s means for an rng in the same state."""
    problem = _float_problem(tvz, dim=2)
    designer = tgb.VizierGPBandit(problem, ard_restarts=2, num_seed_trials=3, device="cpu",
                                  ard_optimizer=tlbfgs.AdamOptimizer(maxiter=20, device="cpu"))
    rng = np.random.default_rng(0)
    trials = []
    for i in range(10):
        x = rng.uniform(-1.0, 2.0, size=2)
        t = tvz.Trial(id=i + 1, parameters={"x0": float(x[0]), "x1": float(x[1])})
        t.complete(tvz.Measurement(metrics={"obj": float(-np.sum((x - 0.5) ** 2))}))
        trials.append(t)
    designer.update(tcore.CompletedTrials(trials), tcore.ActiveTrials())
    experimenter = tsur.PredictorExperimenter(designer, problem, seed=3)
    probes = [s.to_trial(100 + i) for i, s in enumerate(
        trandom.RandomDesigner(problem.search_space, seed=1).suggest(5))]
    experimenter.evaluate(probes)
    want = designer.predict([tvz.TrialSuggestion(parameters=t.parameters) for t in probes],
                            np.random.default_rng(3)).mean
    got = [t.final_measurement.metrics["obj"].value for t in probes]
    assert outcomes(probes) and got == [float(v) for v in np.asarray(want).reshape(-1)]
