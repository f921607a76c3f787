"""The port's PyGlove and Ray Tune integrations and the PYGLOVE route against
the JAX package's, on the CPU.

Neither ``pyglove`` nor ``ray`` is installed here (nor on the card's
machine), so:
- the DNASpec converters run on a structural test double of ``pg.geno``
  (as ``tests/pyglove/test_converters.py`` does): the same spec gives the
  same search space, and the same DNA the same parameters, metadata and
  rebuilt DNA values, in both packages;
- ``TunerPolicy`` and the factories' PYGLOVE route run with a stub
  ``pyglove`` module in ``sys.modules`` while both backends are loaded
  (the module and the backends are restored afterwards): one seeded stub
  generator per package, served through each package's
  ``DefaultPolicyFactory`` and ``InRamPolicySupporter``, proposes the same
  DNAs, gives the same suggestions and is fed back the same DNAs and
  rewards;
- the gated entry points (``VizierBackend``, ``TunerPolicy``, the Ray
  runners) raise the JAX package's errors, and the Ray search-space
  converter, the experimenter plumbing and ``VizierSearch``'s ray-free
  contract behave as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import types
from typing import Any, Optional, Sequence

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
from test_torch_combinatorial import problem_signature

import vizier_tpu.pyglove as jpyglove_pkg
import vizier_tpu_torch.pyglove as tpyglove_pkg
from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters import experimenter_factory as jfactory_exp
from vizier_tpu.benchmarks.experimenters.synthetic import classic as jclassic
from vizier_tpu.pyglove import backend as jbackend
from vizier_tpu.pyglove import converters as jconv
from vizier_tpu.pythia import local_policy_supporters as jlps
from vizier_tpu.raytune import run_tune as jrun
from vizier_tpu.raytune import vizier_search as jsearch
from vizier_tpu.service import policy_factory as jfactory
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory as tfactory_exp
from vizier_tpu_torch.benchmarks.experimenters.synthetic import classic as tclassic
from vizier_tpu_torch.pyglove import backend as tbackend
from vizier_tpu_torch.pyglove import converters as tconv
from vizier_tpu_torch.pythia import local_policy_supporters as tlps
from vizier_tpu_torch.raytune import run_tune as trun
from vizier_tpu_torch.raytune import vizier_search as tsearch
from vizier_tpu_torch.service import clients as tclients
from vizier_tpu_torch.service import policy_factory as tfactory

_SIDES = {
    "jax": dict(vz=jvz, conv=jconv, backend=jbackend, lps=jlps, factory=jfactory,
                run=jrun, search=jsearch, classic=jclassic, exp_factory=jfactory_exp),
    "port": dict(vz=tvz, conv=tconv, backend=tbackend, lps=tlps, factory=tfactory,
                 run=trun, search=tsearch, classic=tclassic, exp_factory=tfactory_exp),
}


# -- a structural test double of pg.geno ---------------------------------------


@dataclasses.dataclass
class Space:
    elements: Sequence[Any] = ()


@dataclasses.dataclass
class Choices:
    name: str
    candidates: Sequence[Space]
    literal_values: Optional[Sequence[Any]] = None
    num_choices: int = 1
    location: str = ""


@dataclasses.dataclass
class Float:
    name: str
    min_value: float
    max_value: float
    scale: Optional[str] = None
    location: str = ""


@dataclasses.dataclass
class Custom:
    name: str = ""
    location: str = "custom_point"


class DNA:
    """``pg.DNA``'s surface that the converters and ``TunerPolicy`` use."""

    def __init__(self, value=None, children=()):
        self._dict = value if isinstance(value, dict) else None
        self.value = None if isinstance(value, dict) else value
        self.children = list(children)
        self.spec = None

    def use_spec(self, spec):
        self.spec = spec
        return self

    def to_dict(self):
        return dict(self._dict)


def _spec() -> Space:
    """model ∈ {mlp, cnn, 'pool'}: mlp → (units, act, 2 sub-ops), cnn →
    (filters, a custom point); then lr and a non-primitive choice."""
    mlp = Space(elements=[
        Float("units", 16.0, 256.0, scale="log"),
        Choices("act", [Space(), Space()], literal_values=["relu", "tanh"]),
        Choices("ops", [Space(), Space(), Space()], literal_values=["a", "b", "c"],
                num_choices=2),
    ])
    cnn = Space(elements=[Float("filters", 8.0, 64.0, scale="rlog"), Custom()])
    return Space(elements=[
        Choices("model", [mlp, cnn, Space()], literal_values=["mlp", "cnn", "pool"]),
        Float("lr", 1e-4, 1e-1, scale="log"),
        Choices("", [Space(), Space()], literal_values=[{"k": 1}, {"k": 2}],
                location="layer"),
    ])


def _random_dna(space, rng, dna_type=DNA):
    """A random DNA over the test double, as a generator would propose."""
    def point(p):
        if isinstance(p, Choices):
            def pick():
                c = int(rng.integers(len(p.candidates)))
                return dna_type(c, [point(e) for e in p.candidates[c].elements])
            if p.num_choices == 1:
                return pick()
            return dna_type(None, [pick() for _ in range(p.num_choices)])
        if isinstance(p, Float):
            return dna_type(float(rng.uniform(p.min_value, p.max_value)))
        return dna_type(int(rng.integers(100)))
    return dna_type(None, [point(e) for e in space.elements])


def _values(dna) -> tuple:
    return (dna.value, tuple(_values(c) for c in dna.children))


def test_dna_spec_converts_to_the_same_search_space():
    spaces = {}
    for side, m in _SIDES.items():
        problem = m["vz"].ProblemStatement(search_space=m["conv"].to_search_space(_spec()))
        spaces[side] = problem_signature(problem)
        assert problem.search_space.is_conditional
    assert spaces["port"] == spaces["jax"]


@pytest.mark.parametrize("seed", range(6))
def test_dnas_convert_to_the_same_parameters_and_back(seed):
    got = {}
    for side, m in _SIDES.items():
        converter = m["conv"].DNASpecConverter(_spec())
        dna = _random_dna(_spec(), np.random.default_rng(seed))
        params = converter.dna_to_parameters(dna)
        suggestion = converter.to_trial_suggestion(dna)
        trial = suggestion.to_trial(1)
        got[side] = (sorted(params.items()), suggestion.metadata.ns("pyglove")["dna_spec_values"],
                     converter.parameters_to_dna_values(params), converter.to_dna_values(trial))
        assert got[side][2] == got[side][3]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("bad", ["arity", "literal", "missing"])
def test_converters_refuse_what_the_jax_package_refuses(bad):
    messages = {}
    for side, m in _SIDES.items():
        converter = m["conv"].DNASpecConverter(_spec())
        with pytest.raises(ValueError) as info:
            if bad == "arity":
                converter.dna_to_parameters(DNA(None, [DNA(0)]))
            elif bad == "literal":
                converter.parameters_to_dna_values({"model": "rnn", "lr": 0.1, "layer": "0/"})
            else:
                converter.parameters_to_dna_values({"model": "pool"})
        messages[side] = str(info.value)
    assert messages["port"] == messages["jax"]


def test_dict_dna_trial_converter_is_equal():
    decisions = {"layer": 3, "act": "relu", "widths": [64, 128], "drop": 0.25}
    got = {}
    for side, m in _SIDES.items():
        suggestion = m["backend"].DNATrialConverter.to_suggestion(decisions)
        trial = suggestion.to_trial(1)
        got[side] = (sorted((k, v.value) for k, v in trial.parameters.items()),
                     m["backend"].DNATrialConverter.to_decisions(trial))
        bare = m["vz"].Trial(id=2, parameters={"a": 1.0})
        assert m["backend"].DNATrialConverter.to_decisions(bare) == {"a": 1.0}
    assert got["port"] == got["jax"]
    assert got["port"][1] == decisions


# -- TunerPolicy and the PYGLOVE route, on a stub pyglove --------------------------


class _StubGenerator:
    """A seeded ``pg.DNAGenerator``: proposes random DNAs over the spec and
    records what it is fed back."""

    def __init__(self, seed: int, dna_type):
        self._rng = np.random.default_rng(seed)
        self._dna = dna_type
        self.fed = []

    def setup(self, dna_spec):
        self.spec = dna_spec

    def propose(self):
        if isinstance(self.spec, Space):
            return _random_dna(self.spec, self._rng, self._dna)
        return self._dna({"units": int(self._rng.integers(8, 64)), "act": "relu"})

    def feedback(self, dna, reward):
        self.fed.append((_values(dna) if dna._dict is None else dna.to_dict(), reward,
                         dna.spec is self.spec))


def _load_backends(monkeypatch, pyglove_module):
    """Both backends loaded anew with ``sys.modules["pyglove"]`` set to
    ``pyglove_module`` (None: the import fails); the modules and the
    packages' attributes are restored when the test ends. (Under pytest,
    ``tests/pyglove/`` can itself import as a ``pyglove`` namespace package,
    so the absent case is forced too.)"""
    monkeypatch.setitem(sys.modules, "pyglove", pyglove_module)
    backends = {}
    for side, package in (("jax", jpyglove_pkg), ("port", tpyglove_pkg)):
        name = f"{package.__name__}.backend"
        monkeypatch.setattr(package, "backend", sys.modules[name])
        monkeypatch.delitem(sys.modules, name)
        backends[side] = importlib.import_module(name)
        assert backends[side].PYGLOVE_AVAILABLE == (pyglove_module is not None)
    return backends


@pytest.fixture
def stub_pyglove(monkeypatch):
    stub = types.ModuleType("pyglove")
    stub.DNA = DNA
    return _load_backends(monkeypatch, stub)


def _pyglove_study(vz, study_config, space):
    config = study_config.StudyConfig(algorithm="PYGLOVE")
    config.search_space = space
    config.metric_information.append(
        vz.MetricInformation(name="reward", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return config


@pytest.mark.parametrize("tree", [True, False], ids=["dna_spec_tree", "dict_dna"])
def test_the_pyglove_route_serves_a_stub_generator_in_both_factories(stub_pyglove, tree):
    from vizier_tpu.pyvizier import study_config as jstudy_config
    from vizier_tpu_torch.pyvizier import study_config as tstudy_config

    configs = {"jax": jstudy_config, "port": tstudy_config}
    served, fed = {}, {}
    for side, m in _SIDES.items():
        backend = stub_pyglove[side]
        spec = _spec() if tree else object()
        space = m["conv"].to_search_space(_spec()) if tree else m["vz"].SearchSpace()
        config = _pyglove_study(m["vz"], configs[side], space)
        generator = _StubGenerator(seed=3, dna_type=DNA)
        backend.register_generator("owners/o/studies/pg", spec, generator)
        factory = (m["factory"].DefaultPolicyFactory() if side == "jax"
                   else m["factory"].DefaultPolicyFactory(device="cpu"))
        supporter = m["lps"].InRamPolicySupporter(config)
        policy = factory(config.to_problem(), "PYGLOVE", supporter, "owners/o/studies/pg")
        assert type(policy).__name__ == "TunerPolicy" and policy.should_be_cached
        rounds = []
        for r in range(3):
            trials = supporter.SuggestTrials(policy, 2)
            rounds.append([sorted((k, v.value) for k, v in t.parameters.items())
                           for t in trials])
            for i, t in enumerate(trials):
                if r == 1 and i == 0:
                    t.complete(infeasibility_reason="failed")
                else:
                    t.complete(m["vz"].Measurement(metrics={"reward": float(r + 0.5 * i)}))
        served[side], fed[side] = rounds, generator.fed
        with pytest.raises(ValueError) as info:
            factory(config.to_problem(), "PYGLOVE", supporter, "owners/o/studies/none")
        assert "No PyGlove generator registered" in str(info.value)
    assert served["port"] == served["jax"]
    assert fed["port"] == fed["jax"]
    assert len(fed["port"]) == 3 and all(spec_used for _, _, spec_used in fed["port"])


def test_tuner_policy_and_backend_without_pyglove_raise_the_jax_packages_errors(monkeypatch):
    backends = _load_backends(monkeypatch, None)
    messages = {}
    for side, backend in backends.items():
        errors = []
        for make in (lambda: backend.TunerPolicy(None, _spec(), _StubGenerator(0, DNA)),
                     lambda: backend.VizierBackend("s", _spec(), None)):
            with pytest.raises(ImportError) as info:
                make()
            errors.append(str(info.value))
        messages[side] = errors
    assert messages["port"] == messages["jax"]


def test_an_unregistered_pyglove_study_is_refused_by_both_factories():
    from vizier_tpu.pyvizier import study_config as jstudy_config
    from vizier_tpu_torch.pyvizier import study_config as tstudy_config

    messages = {}
    for side, study_config in (("jax", jstudy_config), ("port", tstudy_config)):
        m = _SIDES[side]
        config = _pyglove_study(m["vz"], study_config, m["vz"].SearchSpace())
        factory = (m["factory"].DefaultPolicyFactory() if side == "jax"
                   else m["factory"].DefaultPolicyFactory(device="cpu"))
        with pytest.raises(ValueError) as info:
            factory(config.to_problem(), "PYGLOVE", m["lps"].InRamPolicySupporter(config),
                    "owners/o/studies/unregistered")
        messages[side] = str(info.value)
    assert messages["port"] == messages["jax"]


# -- Ray Tune ---------------------------------------------------------------------


def _ray_domain(kind: str, **attrs):
    """An object whose class is named as a ray ``Domain``'s (the converter
    duck-types domains by class name)."""
    return type(kind, (), attrs)()


def _ray_float(lower, upper, log=False):
    sampler = type("LogUniform" if log else "Uniform", (), {})()
    return _ray_domain("Float", lower=lower, upper=upper, sampler=sampler)


def _param_space():
    return {
        "lr": {"type": "loguniform", "min": 1e-4, "max": 1e-1},
        "units": {"type": "randint", "min": 32, "max": 512},
        "act": {"type": "choice", "values": ["relu", "tanh"]},
        "width": {"type": "choice", "values": [1, 2, 4]},
        "drop": {"type": "uniform", "min": 0.0, "max": 0.5},
        "wd": _ray_float(1e-6, 1e-2, log=True),
        "mom": _ray_float(0.0, 0.99),
        "layers": _ray_domain("Integer", lower=1, upper=9),
        "opt": _ray_domain("Categorical", categories=["adam", "sgd"]),
        "bs": _ray_domain("Categorical", categories=[16, 32, 64]),
    }


def test_ray_search_spaces_convert_the_same():
    spaces = {}
    for side, m in _SIDES.items():
        space = m["search"].SearchSpaceConverter.to_vizier(_param_space())
        spaces[side] = problem_signature(m["vz"].ProblemStatement(search_space=space))
    assert spaces["port"] == spaces["jax"]
    messages = {}
    for side, m in _SIDES.items():
        errors = []
        for bad in ({"x": {"type": "normal"}}, {"x": object()}):
            with pytest.raises(ValueError) as info:
                m["search"].SearchSpaceConverter.to_vizier(bad)
            errors.append(str(info.value))
        messages[side] = errors
    assert messages["port"] == messages["jax"]


@pytest.mark.parametrize("make", ["branin", "hartmann6", "factory_sphere"])
def test_experimenter_plumbing_is_equal(make):
    got = {}
    for side, m in _SIDES.items():
        experimenter = {
            "branin": lambda: m["classic"].Branin2DExperimenter(),
            "hartmann6": lambda: m["classic"].HartmannExperimenter.from_6d(),
            "factory_sphere": lambda: m["exp_factory"].SingleObjectiveExperimenterFactory(
                name="Sphere", dim=3)(),
        }[make]()
        space = m["run"].experimenter_param_space(experimenter)
        objective = m["run"].experimenter_objective(experimenter)
        rng = np.random.default_rng(1)
        values = []
        for _ in range(5):
            config = {name: (float(rng.uniform(d["min"], d["max"])) if d["type"] == "uniform"
                             else d["values"][0]) for name, d in space.items()}
            values.append(sorted((k, np.float64(v).tobytes())
                                 for k, v in objective(config).items()))
        got[side] = (space, values)
    assert got["port"] == got["jax"]


def test_ray_gated_entry_points_raise_the_jax_packages_errors():
    messages = {}
    for side, m in _SIDES.items():
        assert not m["run"]._RAY_AVAILABLE and not m["search"]._RAY_AVAILABLE
        errors = []
        for call in (lambda: m["run"].run_tune_bbob("Sphere", 2),
                     lambda: m["run"].run_tune_distributed([], lambda: None),
                     lambda: m["run"].run_tune_from_factory(m["classic"].Branin2DExperimenter)):
            with pytest.raises(ImportError) as info:
                call()
            errors.append(str(info.value))
        messages[side] = errors
    assert messages["port"] == messages["jax"]


def test_vizier_search_runs_its_ray_free_contract_on_the_ports_service(tmp_path, monkeypatch):
    """Suggest, intermediate results, completion, an errored trial, save and
    restore, late binding: as the JAX package's test of it, through the
    port's in-process service on the CPU."""
    monkeypatch.setattr(tclients.environment_variables, "device", "cpu")
    searcher = tsearch.VizierSearch({"x": {"type": "uniform", "min": 0.0, "max": 1.0},
                                     "c": {"type": "choice", "values": ["a", "b"]}},
                                    metric="score", mode="max", algorithm="RANDOM_SEARCH",
                                    study_id="torch-raytune-loop")
    for i in range(4):
        config = searcher.suggest(f"ray_{i}")
        assert 0.0 <= float(config["x"]) <= 1.0 and config["c"] in ("a", "b")
        searcher.on_trial_result(f"ray_{i}", {"score": 0.1, "training_iteration": 1})
        if i == 3:
            searcher.on_trial_complete(f"ray_{i}", error=True)
        else:
            searcher.on_trial_complete(f"ray_{i}", {"score": float(config["x"])})
    searcher.suggest("pending")
    path = str(tmp_path / "searcher.json")
    searcher.save(path)
    restored = tsearch.VizierSearch(metric="score")
    restored.restore(path)
    assert restored._ray_to_vizier == searcher._ray_to_vizier == {"pending": 5}
    restored.on_trial_complete("pending", {"score": 0.5})
    trials = [t.materialize() for t in searcher._study.trials()]
    assert len(trials) == 5 and all(t.is_completed for t in trials)
    assert sum(t.infeasible for t in trials) == 1
    late = tsearch.VizierSearch(study_id="torch-raytune-late")
    assert late.suggest("r0") is None
    assert late.set_search_properties("score", "min", {"y": {"type": "randint", "min": 1,
                                                              "max": 4}})
    assert 1 <= int(late.suggest("r1")["y"]) <= 4
    assert not late.set_search_properties("other", "max", {})
