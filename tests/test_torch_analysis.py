"""The port's analysis suite, held to the JAX package's on the same fixtures.

- The JAX passes and the port's passes read the same seeded fixtures under
  ``tests/analysis/fixtures/`` (as files; the port's copy of a fixture names
  the port's compute registry and the port's names of the JAX package's
  declared switches) and report the same findings by rule and site.
- The port's suite over its own tree (``vizier_tpu_torch/`` and
  ``chip_smoke.py``) finds nothing outside its baseline, and its baseline
  has no stale entry; the command line exits 0.
- Every ``VIZIER_TORCH_*`` name the port reads is declared, an undeclared
  one raises, and the switch doc is the registry's own rendering.
- ``graph_discipline`` flags a seeded ``.item()`` under a capture root, a
  branch on a tensor and a capture in a loop, and nothing in a clean body.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.analysis import common as jcommon
from vizier_tpu.analysis import compute_ir as jcompute_ir
from vizier_tpu.analysis import env_registry as jenv_registry
from vizier_tpu.analysis import lock_order as jlock_order
from vizier_tpu.analysis import registry as jregistry
from vizier_tpu_torch.analysis import baseline as baseline_lib
from vizier_tpu_torch.analysis import common
from vizier_tpu_torch.analysis import compute_ir
from vizier_tpu_torch.analysis import env_registry
from vizier_tpu_torch.analysis import graph_discipline
from vizier_tpu_torch.analysis import lock_order
from vizier_tpu_torch.analysis import registry
from vizier_tpu_torch.analysis import suite
from vizier_tpu_torch.utils import env as env_lib

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_FIXTURES = _ROOT / "tests" / "analysis" / "fixtures"
_FIXTURE_FILES = sorted(p.name for p in _FIXTURES.glob("*.py"))


def _port_name(name: str) -> str:
    """The port's name of a JAX-package switch the JAX registry declares."""
    return "VIZIER_TORCH_" + name[len("VIZIER_"):]


def _port_fixture(text: str) -> str:
    """A fixture as the port's code would say it: the port's compute
    registry, and each declared JAX switch under the port's name."""
    text = text.replace("vizier_tpu.compute", "vizier_tpu_torch.compute")
    switches = sorted(jregistry.env_switch_names(), key=len, reverse=True)

    def swap(match):
        name = match.group(0)
        return _port_name(name) if name in switches else name

    return re.sub(r"\bVIZIER_[A-Z0-9_]*[A-Z0-9]\b", swap, text)


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """(JAX project, port project) over the same fixture files."""
    port_dir = tmp_path_factory.mktemp("port_fixtures")
    for name in _FIXTURE_FILES:
        (port_dir / name).write_text(_port_fixture((_FIXTURES / name).read_text()))
    jax_project = jcommon.Project([str(_FIXTURES)], rel_to=str(_FIXTURES))
    port_project = common.Project([str(port_dir)], rel_to=str(port_dir))
    return jax_project, port_project


def _sites(findings):
    return sorted((f.rule, os.path.basename(f.path), f.line) for f in findings)


def test_every_fixture_has_a_port_copy(projects):
    jax_project, port_project = projects
    assert sorted(jax_project.trees) == sorted(port_project.trees) == _FIXTURE_FILES
    assert not jax_project.parse_errors and not port_project.parse_errors


def test_lock_order_on_the_fixtures_equals_the_jax_pass(projects):
    jax_project, port_project = projects
    critical = ["AccountA.lock_a", "Waiter.cond"]
    theirs = jlock_order.run(jax_project, critical_locks=critical)
    ours = lock_order.run(port_project, critical_locks=critical)
    assert _sites(ours.findings) == _sites(theirs.findings)
    assert {f.key for f in ours.findings} == {f.key for f in theirs.findings}
    assert ours.edge_pairs() == theirs.edge_pairs()
    assert ours.site_ids() == theirs.site_ids()
    rules = {f.rule for f in ours.findings}
    assert rules == {"lock-cycle", "hazard-under-critical-lock"}


def test_env_registry_on_the_fixtures_equals_the_jax_pass(projects):
    jax_project, port_project = projects
    theirs = jenv_registry.run(jax_project, str(_ROOT))
    ours = env_registry.run(port_project, str(_ROOT))
    assert _sites(ours.findings) == _sites(theirs.findings)
    assert {f.rule for f in ours.findings} == {
        "undeclared-env-read", "environ-read-of-constant", "dynamic-env-read",
        "undeclared-literal",
    }
    # The declared reads became the port's names and stay clean.
    assert "VIZIER_TORCH_BATCHING" in ours.references
    assert "VIZIER_TORCH_OBSERVABILITY" in ours.references


def test_compute_ir_on_the_fixtures_equals_the_jax_pass(projects):
    jax_project, port_project = projects
    theirs = jcompute_ir.run(jax_project, str(_ROOT))
    ours = compute_ir.run(port_project, str(_ROOT))
    assert _sites(ours.findings) == _sites(theirs.findings)
    assert [(r.program_class, r.kind) for r in ours.registered] == [
        (r.program_class, r.kind) for r in theirs.registered]
    assert {f.rule for f in ours.findings} >= {
        "program-missing-hook", "program-missing-prewarm-coverage",
        "program-missing-device-phase", "program-missing-shard-axis",
    }


@pytest.mark.parametrize("name", _FIXTURE_FILES)
def test_each_fixture_file_gets_the_jax_packages_findings(projects, name):
    jax_project, port_project = projects

    def findings(project, passes):
        out = []
        out += passes[0].run(project, critical_locks=["AccountA.lock_a", "Waiter.cond"]).findings
        out += passes[1].run(project, str(_ROOT)).findings
        out += passes[2].run(project, str(_ROOT)).findings
        return [f for f in out if os.path.basename(f.path) == name]

    theirs = findings(jax_project, (jlock_order, jenv_registry, jcompute_ir))
    ours = findings(port_project, (lock_order, env_registry, compute_ir))
    assert _sites(ours) == _sites(theirs)
    if name == "clean_module.py":
        assert ours == []


# -- the port's own tree ------------------------------------------------------


@pytest.fixture(scope="module")
def port_suite():
    return suite.run_suite(str(_ROOT))


def test_the_port_suite_finds_nothing_outside_its_baseline(port_suite):
    assert port_suite.parse_errors == []
    assert [f.format() for f in port_suite.new_findings] == []
    assert port_suite.stale_baseline == []
    assert port_suite.ok
    assert set(port_suite.passes) == set(suite.ALL_PASSES)


def test_the_suite_scans_the_port_and_the_smoke_script(port_suite):
    config = suite.load_config(str(_ROOT))
    assert config.paths == ["vizier_tpu_torch", "chip_smoke.py"]
    assert config.baseline == "vizier_tpu_torch/analysis/baseline.toml"
    assert "graph_discipline" in config.passes and "jax_discipline" not in config.passes
    assert sorted(r.kind for r in port_suite.compute_ir_result.registered) == [
        "gp_bandit", "gp_bandit_sparse", "gp_ucb_pe", "gp_ucb_pe_sparse"]
    assert port_suite.graph_result.roots, "the ARD step capture is a root"
    confirmed, _unmapped = port_suite.debug_locks_stats
    assert confirmed >= 1


def test_the_shard_axis_rule_is_off_by_one_baseline_entry(port_suite):
    """The mesh slice turned the rule back on: no baseline entry accepts it,
    every registered program declares ``shardable_batch_axis = "study"``,
    and the pass finds and accepts nothing."""
    from vizier_tpu_torch.compute import registry as compute_registry

    entries = baseline_lib.load_baseline(str(_ROOT / suite.DEFAULT_BASELINE)).entries
    assert [e for e in entries if e.key == baseline_lib.RULE_WILDCARD] == []
    assert not [e for e in entries if e.rule == "program-missing-shard-axis"]
    assert list(port_suite.passes["compute_ir"].accepted) == []
    assert list(port_suite.passes["compute_ir"].findings) == []
    assert sorted((p.kind, p.shardable_batch_axis) for p in compute_registry.programs()) == [
        (kind, "study") for kind in (
            "gp_bandit", "gp_bandit_sparse", "gp_ucb_pe", "gp_ucb_pe_sparse")]


def test_the_command_line_exits_zero_on_the_port_tree():
    out = subprocess.run(
        [sys.executable, "-m", "vizier_tpu_torch.analysis", "--strict-baseline"],
        cwd=_ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ANALYSIS OK" in out.stdout


def test_the_command_line_exits_non_zero_on_a_new_finding(tmp_path):
    (tmp_path / "bad.py").write_text(
        (_FIXTURES / "bad_lock_cycle.py").read_text())
    out = subprocess.run(
        [sys.executable, "-m", "vizier_tpu_torch.analysis", "--pass", "lock_order",
         "--repo-root", str(tmp_path), "--paths", "bad.py"],
        cwd=_ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 1
    assert "lock-cycle" in out.stdout and "ANALYSIS FAILED" in out.stdout


# -- the switch registry ------------------------------------------------------


def test_every_vizier_torch_read_in_the_port_is_declared(port_suite):
    env = port_suite.env_result
    assert [f.format() for f in env.findings] == []
    seen = {n for n in env.references if n.startswith(registry.PREFIX)}
    declared = set(registry.env_switch_names())
    assert seen <= declared
    assert declared <= seen  # no stale declaration either
    # The 74 switches before prewarm, its two, the mesh's three (the
    # device count, the shard size and the designers' opt-out) and the
    # multi-host seam's three (coordinator, process count, process id).
    assert len(declared) == 82


def test_an_undeclared_switch_raises_and_a_constant_is_not_a_switch(monkeypatch):
    monkeypatch.setenv("VIZIER_TORCH_NOT_A_SWITCH", "1")
    for read in (env_lib.env_on, env_lib.env_str):
        with pytest.raises(KeyError, match="Undeclared"):
            read("VIZIER_TORCH_NOT_A_SWITCH")
    with pytest.raises(KeyError, match="Undeclared"):
        env_lib.env_int("VIZIER_TORCH_NOT_A_SWITCH", 1)
    with pytest.raises(KeyError, match="constant"):
        env_lib.env_str("VIZIER_METHODS")


@pytest.mark.parametrize("switch", registry.SWITCHES, ids=lambda s: s.name)
def test_each_switch_reads_its_declared_default(switch, monkeypatch):
    if switch.kind == "constant":
        assert not switch.name.startswith(registry.PREFIX)
        return
    assert switch.name.startswith(registry.PREFIX)
    monkeypatch.delenv(switch.name, raising=False)
    if switch.kind == "flag":
        assert env_lib.env_on(switch.name) == (switch.default not in ("0", "false", ""))
        monkeypatch.setenv(switch.name, "0")
        assert not env_lib.env_on(switch.name)
    elif switch.kind == "int":
        assert env_lib.env_int(switch.name, int(switch.default or 0)) == int(switch.default or 0)
    elif switch.kind == "float":
        assert env_lib.env_float(switch.name, float(switch.default or 0)) == float(
            switch.default or 0)
    else:
        assert env_lib.env_str(switch.name, switch.default) == switch.default


def test_the_port_switch_defaults_equal_the_jax_packages():
    for switch in registry.SWITCHES:
        if switch.kind == "constant":
            assert jregistry.BY_NAME[switch.name].kind == "constant"
            continue
        theirs = jregistry.BY_NAME.get("VIZIER_" + switch.name[len(registry.PREFIX):])
        if theirs is not None:
            assert (switch.kind, switch.default) == (theirs.kind, theirs.default), switch.name


@pytest.mark.parametrize("value", [None, "0", "1", "false", "False", "", "yes"])
def test_env_set_reads_an_opt_out_flag_as_the_jax_package_does(value, monkeypatch):
    flags = [(s.name, "VIZIER_" + s.name[len(registry.PREFIX):]) for s in registry.SWITCHES
             if s.kind == "flag"]
    flags = [(ours, theirs) for ours, theirs in flags if theirs in jregistry.BY_NAME]
    assert ("VIZIER_TORCH_DISABLE_MESH", "VIZIER_DISABLE_MESH") in flags
    for ours, theirs in flags:
        for name in (ours, theirs):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        assert registry.env_set(ours) == jregistry.env_set(theirs), (ours, value)
        assert registry.env_set(ours) == (value not in (None, "0", "false", "False", ""))
    with pytest.raises(KeyError, match="Undeclared"):
        registry.env_set("VIZIER_TORCH_NOT_A_SWITCH")


def test_the_switch_doc_is_the_registrys_rendering():
    doc = (_ROOT / registry.DOC).read_text()
    assert doc == registry.render_doc()
    for switch in registry.SWITCHES:
        assert f"`{switch.name}`" in doc


# -- graph_discipline ----------------------------------------------------------


_SEEDED = '''
import torch
from vizier_tpu_torch.optimizers import graphs


def _step(x, n):
    y = torch.exp(x)
    s = y.sum().item()
    if y.max() > 0:
        y = y * 2
    if x is None or x.shape[0] > 1:
        y = y + 1
    return y * s


def _clean(x):
    return (torch.exp(x) * 2,)


def capture_step(x, device):
    return graphs.capture(lambda: _step(x, 3), device)


def capture_clean(x, device):
    return graphs.capture(lambda: _clean(x), device)


def capture_per_item(xs, device):
    out = []
    for x in xs:
        out.append(graphs.capture(lambda: _clean(x), device))
    return out


def graph_block(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        total = float(x.sum())
    return total
'''


def test_graph_discipline_flags_a_seeded_item_under_a_capture_root(tmp_path):
    (tmp_path / "seeded.py").write_text(textwrap.dedent(_SEEDED))
    result = graph_discipline.run(common.Project([str(tmp_path)], rel_to=str(tmp_path)))
    found = sorted((f.rule, f.key.split("::", 1)[1]) for f in result.findings)
    assert found == [
        ("capture-in-loop", "capture_per_item:capture"),
        ("host-sync-in-capture", "_step:.item()"),
        ("host-sync-in-capture", "graph_block.<<graph@37>>:float()"),
        ("tensor-branch", "_step:y"),
    ]
    roots = {r.fn.name for r in result.roots}
    assert {"_step", "_clean", "<graph@37>"} <= roots
    assert not any("_clean" in f.key for f in result.findings)


def test_graph_discipline_reaches_the_ard_step_the_port_captures(port_suite):
    roots = {r.fn.qualname for r in port_suite.graph_result.roots}
    assert any(q.endswith("AdamOptimizer._step") for q in roots), roots
    assert port_suite.passes["graph_discipline"].findings == []
