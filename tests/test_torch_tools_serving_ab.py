"""The serving A/B tools on the port, held to the JAX tools on the CPU.

``vizier_tpu_torch/tools/batching_ab.py``, ``speculative_ab.py`` and
``overload_ab.py`` against the JAX package's ``tools/`` scripts of the same
names, loaded as ``tests/test_torch_tools.py`` loads the JAX tools
(``tools/`` on ``sys.path``, JAX on the CPU on the conftest's 8 virtual
devices). Both packages' tools run at a small size on the same arguments
(the JAX tools with ``--out`` in a temporary directory, the port's without,
in an empty directory that must stay empty):

- batching_ab's classic arm: the same key tree and configuration; its mesh
  arm on 8 devices (the port's ``local_devices`` patched,
  ``tests/torch_mesh_devices.py``): the same key tree, and
  ``mesh_off_bit_identical`` in both packages;
- speculative_ab: the same key tree, workload and engine configuration; the
  runtime transport gives the service transport's suggestion trajectory;
- overload_ab, with the hot-tenant scenario's GP economics trimmed alike in
  both packages: the same key tree, configuration and scenario fingerprint.
  At these sizes the latency verdicts depend on the host, so the JAX tool may
  exit 1 after writing its report, and neither package's verdicts are
  compared; the untrimmed scenario's configuration and fingerprint are.

The tools' percentiles equal the JAX tools' on the same arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu.loadgen import models as jmodels
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.tools import batching_ab, overload_ab, speculative_ab

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "tools"))
import batching_ab as jbatching_ab  # noqa: E402  (tools/ is not a package)
import overload_ab as joverload_ab  # noqa: E402
import speculative_ab as jspeculative_ab  # noqa: E402

_BATCHING = ["--studies", "2", "--rounds", "1", "--warmup-rounds", "0", "--start-trials", "9",
             "--dim", "2", "--max-evals", "50", "--ard-maxiter", "3", "--ard-restarts", "2"]
_MESH = ["--devices", "8", "--buckets", "2", "--studies-per-bucket", "1", "--rounds", "1",
         "--warmup-rounds", "0", "--dim", "2", "--max-evals", "50", "--ard-maxiter", "3",
         "--ard-restarts", "2"]
_SPECULATIVE = ["--trials", "7", "--seeds", "1", "--warmup", "2", "--dim", "2",
                "--acquisition-evals", "50"]
# The hot-tenant scenario at 4 studies, its GP computes trimmed (the
# designer's default sweep and ARD budget take seconds each on the CPU).
_OVERLOAD = ["--studies", "4"]
_TRIM = dict(acquisition_evals=50, ard_restarts=2, ard_maxiter=3)


def _jax_report(module, argv, tmp_path, monkeypatch) -> dict:
    out = tmp_path / "jax_report.json"
    monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv, "--out", str(out)])
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            module.main()
        except SystemExit as exit_:
            assert exit_.code == 1 and module is joverload_ab, exit_.code
    return json.loads(out.read_text())


def _port_report(module, argv, tmp_path, monkeypatch) -> dict:
    """The port tool's report from its printed line, run without ``--out`` in
    an empty directory that must stay empty."""
    cwd = tmp_path / "port_cwd"
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            module.main([*argv, "--device", "cpu"])
        except SystemExit as exit_:
            assert exit_.code == 1 and module is overload_ab, exit_.code
    assert list(cwd.iterdir()) == [], "the tool wrote a file without --out"
    return json.loads(out.getvalue().splitlines()[-1])


def _keys(tree, leaves=()):
    """The nested key structure of a report, without its values; the keys in
    ``leaves`` hold data-dependent keys and are kept as leaves."""
    if isinstance(tree, dict):
        return {k: None if k in leaves else _keys(v, leaves) for k, v in tree.items()}
    return None


def test_batching_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    jax_ = _jax_report(jbatching_ab, _BATCHING, tmp_path, monkeypatch)
    port = _port_report(batching_ab, _BATCHING, tmp_path, monkeypatch)
    assert _keys(port) == _keys(jax_)
    assert port["config"] == jax_["config"]
    for arm in ("batching_on", "batching_off"):
        assert port[arm]["suggestions"] == jax_[arm]["suggestions"] == 2
    assert port["batching_on"]["batch_stats"]["batch_flushes"] >= 1
    assert port["batching_off"]["batch_stats"]["batch_flushes"] == 0


def test_batching_ab_mesh_arm_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    jax_ = _jax_report(jbatching_ab, _MESH, tmp_path, monkeypatch)
    torch_mesh_devices.patch_devices(monkeypatch, 8)
    port = _port_report(batching_ab, _MESH, tmp_path, monkeypatch)
    leaves = ("placement_flushes", "bucket_placements")
    assert _keys(port, leaves) == _keys(jax_, leaves)
    # The port has no XLA flags; the rest of the configuration is the JAX tool's.
    assert port["config"]["xla_flags"] == ""
    assert ({k: v for k, v in port["config"].items() if k != "xla_flags"}
            == {k: v for k, v in jax_["config"].items() if k != "xla_flags"})
    assert port["verdict"]["mesh_off_bit_identical"] is True
    assert jax_["verdict"]["mesh_off_bit_identical"] is True
    assert port["mesh"]["mesh"] is True and port["single_device"]["mesh"] is False
    assert port["mesh"]["placement_flushes"] and not port["single_device"]["placement_flushes"]


def test_speculative_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    jax_ = _jax_report(jspeculative_ab, _SPECULATIVE, tmp_path, monkeypatch)
    port = _port_report(speculative_ab, _SPECULATIVE, tmp_path, monkeypatch)
    assert _keys(port) == _keys(jax_)
    assert port["workload"] == jax_["workload"]
    assert port["speculative_config"] == jax_["speculative_config"]
    assert port["bit_identical_trajectories"] == "1/1"
    assert port["per_seed"]["speculative"][0]["measured"] == 5


def test_speculative_ab_runtime_transport_serves_the_service_transports_trajectory():
    common = dict(speculative=True, seed=1, dim=2, trials=7, warmup=2, think_time=0.0,
                  acquisition_evals=50, device="cpu")
    service = speculative_ab._run_arm(transport="service", **common)
    runtime = speculative_ab._run_arm(transport="runtime", **common)
    assert runtime["trajectory"] == service["trajectory"]
    assert runtime["best_curve"] == service["best_curve"]
    assert runtime["hits"] == service["hits"] == 5


def test_overload_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    for package in (jmodels, models):
        original = package.hot_tenant_config
        monkeypatch.setattr(package, "hot_tenant_config",
                            lambda _o=original, **kw: _o(**{**_TRIM, **kw}))
    jax_ = _jax_report(joverload_ab, _OVERLOAD, tmp_path, monkeypatch)
    port = _port_report(overload_ab, _OVERLOAD, tmp_path, monkeypatch)
    leaves = ("by_tenant", "admission", "serving_stats", "mismatched")
    assert _keys(port, leaves) == _keys(jax_, leaves)
    assert port["scenario"] == jax_["scenario"]
    assert port["slo_budget_ms"] == jax_["slo_budget_ms"] == 1000.0
    assert [a["name"] for a in port["assertions"]] == [a["name"] for a in jax_["assertions"]]
    on = port["arms"]["admission_on"]
    assert on["lost_studies"] == [] and on["errored_studies"] == []
    assert on["light_suggests"] > 0 and on["hot_suggests"] > 0
    assert port["bit_identity"]["identical"] is True


def test_the_hot_tenant_scenario_is_the_jax_packages():
    for overrides in ({}, {"num_studies": 16, "p99_budget_ms": 20000.0, "seed": 3}):
        config, jconfig = (package.hot_tenant_config(**overrides) for package in (models, jmodels))
        assert config.as_dict() == jconfig.as_dict()
        assert (models.build_scenario(config).fingerprint()
                == jmodels.build_scenario(jconfig).fingerprint())


def test_the_percentiles_equal_the_jax_tools_on_the_same_arrays():
    rng = np.random.default_rng(7)
    cases = [[], [0.5], sorted(rng.uniform(size=9)), sorted(rng.exponential(size=40)),
             [1.0, 1.0, 2.0, 7.0]]
    for values in cases:
        values = [float(v) for v in values]
        for q in (50, 95, 99):
            assert batching_ab._percentile(values, q) == jbatching_ab._percentile(values, q)
            assert speculative_ab._percentile(values, q) == jspeculative_ab._percentile(values, q)
        assert speculative_ab._pcts_ms(values) == jspeculative_ab._pcts_ms(values)
        assert overload_ab._p99_ms(values) == joverload_ab._p99_ms(values)
    a, b = rng.normal(size=5).tolist(), rng.normal(size=5).tolist()
    assert speculative_ab._ranksum_p(a, b) == jspeculative_ab._ranksum_p(a, b)


def test_the_serving_tools_ask_for_the_card_by_default():
    for module in (batching_ab, speculative_ab, overload_ab):
        args = module.parser().parse_args([])
        assert args.device == "cuda" and args.out is None
    assert speculative_ab.parser().parse_args([]).transport == "service"
    assert overload_ab.parser().parse_args([]).transport == "service"
    for module in (batching_ab, speculative_ab, overload_ab):
        with pytest.raises(RuntimeError, match="no GPU"):
            module.run(module.parser().parse_args([]))


@pytest.mark.parametrize("warmup_rounds", [0, 1])
def test_a_client_thread_that_fails_raises_its_error_instead_of_hanging(warmup_rounds):
    class _Failing:
        def complete_suggestion(self, suggestion):
            del suggestion

    def suggest(study):
        raise ValueError(f"no suggestion for {type(study).__name__}")

    with pytest.raises(ValueError, match="no suggestion for _Failing"):
        batching_ab._drive([_Failing(), _Failing()], suggest, warmup_rounds, 1)


def test_the_crossover_study_cut_keeps_every_study_at_the_scenarios_trials():
    """The hot-tenant scenario stretches its first GP study across the sparse
    threshold (63 trials, as the JAX package's); ``--no-crossover-study``
    keeps it at the scenario's 3 and changes nothing else."""
    full = models.build_scenario(overload_ab.scenario_config(overload_ab.parser().parse_args([])))
    cut = models.build_scenario(overload_ab.scenario_config(
        overload_ab.parser().parse_args(["--no-crossover-study"])))
    assert full.fingerprint() == jmodels.build_scenario(jmodels.hot_tenant_config()).fingerprint()
    assert max(s.budget for s in full.studies) == 63
    assert [s.budget for s in cut.studies] == [3] * len(full.studies)
    assert ([dataclasses.replace(s, budget=3) for s in full.studies] == cut.studies)
