"""The regret A/B tools on the port, held to the JAX tools on the CPU.

``vizier_tpu_torch/tools/noise_robustness.py`` and ``budget_policy_ab.py``
against the JAX package's ``tools/noise_robustness.py`` and
``tools/budget_policy_ab.py``, loaded as ``tests/test_torch_tools.py`` loads
the JAX tools (``tools/`` on ``sys.path``, JAX on the CPU). Both packages' tools
run at a small size on the same arguments: the reports have the same key
tree and the same configuration; the noise models give the same values on
the same inputs and the budget A/B's functions, policies and optima are the
JAX tool's. The JAX tools write into the repository's root, so their
``_REPO_ROOT`` points at a temporary directory and the evidence files must be
unchanged byte for byte; the port's tools write nothing without ``--out``.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.benchmarks.experimenters import experimenter_factory as jfactory
from vizier_tpu.benchmarks.experimenters import wrappers as jwrappers
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
from vizier_tpu_torch.benchmarks.experimenters import wrappers
from vizier_tpu_torch.tools import budget_policy_ab, noise_robustness

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "tools"))
import budget_policy_ab as jbudget_policy_ab  # noqa: E402  (tools/ is not a package)
import noise_robustness as jnoise_robustness  # noqa: E402

_EVIDENCE = ("noise_robustness_r5.json", "budget_ab_r5.json")
# Past the 5 seed trials, one GP suggest per run.
_NOISE_ARGS = ["--trials", "10", "--batch", "5", "--evals", "50", "--dim", "4", "--seeds", "1"]
_BUDGET_ARGS = ["--trials", "10", "--batch", "5", "--evals", "50", "--seeds", "1"]


def _digests():
    return {name: hashlib.sha256((_ROOT / name).read_bytes()).hexdigest() for name in _EVIDENCE}


def _jax_report(module, argv, name, tmp_path, monkeypatch) -> dict:
    """The JAX tool's report, its ``_REPO_ROOT`` a temporary directory."""
    root = tmp_path / "jax_root"
    root.mkdir()
    monkeypatch.setattr(module, "_REPO_ROOT", str(root))
    monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        module.main()
    assert [p.name for p in root.iterdir()] == [name]
    return json.loads((root / name).read_text())


def _port_report(module, argv, tmp_path, monkeypatch) -> dict:
    """The port tool's report from its printed line, run without ``--out`` in
    an empty directory that must stay empty."""
    cwd = tmp_path / "port_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main([*argv, "--device", "cpu"])
    assert list(cwd.iterdir()) == [], "the tool wrote a file without --out"
    return json.loads(out.getvalue().splitlines()[-1])


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [len(tree)]
    return type(tree).__name__


def _literal(module, name: str):
    """The literal a JAX tool's ``main`` assigns to ``name``, or loops
    ``name`` over."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
        if isinstance(node, ast.For) and getattr(node.target, "id", None) == name:
            return ast.literal_eval(node.iter)
    raise KeyError(name)


def test_noise_robustness_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    before = _digests()
    jax_ = _jax_report(jnoise_robustness, _NOISE_ARGS, "noise_robustness_r5.json", tmp_path,
                       monkeypatch)
    port = _port_report(noise_robustness, _NOISE_ARGS, tmp_path, monkeypatch)
    assert _digests() == before
    assert _keys(port) == _keys(jax_)
    assert port["config"] == jax_["config"] and port["metric"] == jax_["metric"]
    assert list(port["results"]) == list(jax_["results"]) == list(wrappers.NOISE_TYPES)
    for row in port["results"].values():
        assert np.isfinite(row["per_seed_true_regret"]).all() and row["median"] >= 0.0


def test_budget_policy_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    before = _digests()
    jax_ = _jax_report(jbudget_policy_ab, _BUDGET_ARGS, "budget_ab_r5.json", tmp_path,
                       monkeypatch)
    port = _port_report(budget_policy_ab, _BUDGET_ARGS, tmp_path, monkeypatch)
    assert _digests() == before
    assert _keys(port) == _keys(jax_)
    for key in ("seeds", "trials", "batch", "evals"):
        assert port[key] == jax_[key]
    assert list(port["per_run"]) == list(jax_["per_run"])
    assert list(port["median_final_regret"]) == list(jax_["median_final_regret"])
    for runs in port["per_run"].values():
        assert len(runs) == 1 and np.isfinite(runs).all() and min(runs) >= -1e-6


def test_the_budget_ab_runs_the_jax_tools_functions_policies_and_optima():
    assert budget_policy_ab.OPTIMA == _literal(jbudget_policy_ab, "optima")
    assert budget_policy_ab.CONFIGS == _literal(jbudget_policy_ab, "configs")
    assert budget_policy_ab.POLICIES == _literal(jbudget_policy_ab, "policy")
    for fn_name, dim in budget_policy_ab.CONFIGS:
        for seed in (1, 2):
            exp = experimenter_factory.shifted_bbob_instance(fn_name, seed, dim=dim)
            jexp = jfactory.shifted_bbob_instance(fn_name, seed, dim=dim)
            rng = np.random.default_rng(seed)
            points = rng.uniform(size=(4, dim))
            values = []
            for package, e in ((vz, exp), (jvz, jexp)):
                space = e.problem_statement().search_space
                trials = [package.Trial(parameters={
                    p.name: float(p.bounds[0] + x[i] * (p.bounds[1] - p.bounds[0]))
                    for i, p in enumerate(space.parameters)}) for x in points]
                e.evaluate(trials)
                values.append([t.final_measurement.metrics["bbob_eval"].value for t in trials])
            np.testing.assert_array_equal(values[0], values[1])
            assert min(values[0]) >= budget_policy_ab.OPTIMA[fn_name] - 1e-6


@pytest.mark.parametrize("noise_type", wrappers.NOISE_TYPES)
def test_the_noise_models_give_the_jax_packages_values_on_the_same_inputs(noise_type):
    values = np.concatenate([[0.0, 1e-9, 1e-3], np.random.default_rng(5).uniform(0, 50, 40)])
    port_fn = wrappers.make_noise_fn(noise_type, 4, np.random.default_rng(11))
    jax_fn = jwrappers.make_noise_fn(noise_type, 4, np.random.default_rng(11))
    np.testing.assert_array_equal([port_fn(v) for v in values], [jax_fn(v) for v in values])
    # The tool's experimenter: the noisy and clean metrics of the same trials.
    results = []
    for package, factory, wrap in ((vz, experimenter_factory, wrappers),
                                   (jvz, jfactory, jwrappers)):
        exp = wrap.NoisyExperimenter.from_type(
            factory.shifted_bbob_instance("Sphere", 2, dim=4), noise_type, seed=2)
        trials = [package.Trial(parameters={f"x{i}": float(x[i]) for i in range(4)})
                  for x in np.random.default_rng(3).uniform(-5, 5, size=(6, 4))]
        exp.evaluate(trials)
        results.append([(t.final_measurement.metrics["bbob_eval"].value,
                         t.final_measurement.metrics["bbob_eval_before_noise"].value)
                        for t in trials])
    assert results[0] == results[1]


def test_the_regret_tools_ask_for_the_card_by_default():
    for module in (noise_robustness, budget_policy_ab):
        args = module.parser().parse_args([])
        assert args.device == "cuda" and args.out is None
        with pytest.raises(RuntimeError, match="no GPU"):
            module.run(module.parser().parse_args(["--trials", "1", "--seeds", "1"]))
