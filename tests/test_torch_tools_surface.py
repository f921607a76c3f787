"""The walk over the repository's scripts: each has a port counterpart or is
queued.

Every ``tools/*.py`` and the top-level ``bench.py``, ``regret_suite.py`` and
``parity_suite.py`` are parsed with ``ast`` (nothing of JAX is imported).
A script either maps to its counterpart in the port (``_MAPPED``), which must
have every public top-level function of the script, ``main`` included, or is
listed in ``_QUEUED`` with the ROADMAP item that ports it and the reason. A
queued script must still have no counterpart module in the port, so the list
only shrinks: porting a script moves it to ``_MAPPED``. Where the port does a
script's job another way, ``_REDESIGNED`` names the replacement, which must
exist. The port's own ``chip_smoke.py`` and ``serving_arrivals.py`` and the
JAX package's ``__graft_entry__.py`` are not scripts to port. One case per
script.
"""

from __future__ import annotations

import ast
import importlib
import pathlib
import re
from typing import Dict, Tuple

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PORT = _ROOT / "vizier_tpu_torch"

# Script -> the port's counterpart module.
_MAPPED: Dict[str, str] = {
    "tools/obs_report.py": "vizier_tpu_torch.tools.obs_report",
    "tools/profile_e2e.py": "vizier_tpu_torch.tools.profile_e2e",
    "tools/warm_start_ab.py": "vizier_tpu_torch.tools.warm_start_ab",
    "tools/surrogate_ab.py": "vizier_tpu_torch.tools.surrogate_ab",
    "tools/batching_ab.py": "vizier_tpu_torch.tools.batching_ab",
    "tools/speculative_ab.py": "vizier_tpu_torch.tools.speculative_ab",
    "tools/overload_ab.py": "vizier_tpu_torch.tools.overload_ab",
    "tools/noise_robustness.py": "vizier_tpu_torch.tools.noise_robustness",
    "tools/budget_policy_ab.py": "vizier_tpu_torch.tools.budget_policy_ab",
    "tools/soak.py": "vizier_tpu_torch.loadgen.soak",
    "tools/check_analysis.py": "vizier_tpu_torch.analysis.__main__",
    "regret_suite.py": "vizier_tpu_torch.benchmarks.regret",
    "tools/regen_protos.py": "vizier_tpu_torch.service.protos",
}

# (script, public function) -> (the port's replacement, a path in the repo
# that must exist; the reason).
_REDESIGNED: Dict[Tuple[str, str], Tuple[str, str]] = {
    ("tools/regen_protos.py", name): (
        "vizier_tpu_torch/service/protos/build.sh",
        "the port's message modules are regenerated by protoc from its own .proto "
        "sources (package vizier_tpu_torch, ROADMAP C9), not by descriptor surgery")
    for name in ("regen_new_file", "regen", "main")
}

# Script -> (ROADMAP item, reason), in the order ROADMAP's queue D ports them.
_QUEUED: Dict[str, Tuple[str, str]] = {
    "bench.py": ("A1", "the port's benchmark cell, a benchmark PR of its own"),
    "tools/compute_tier_ab.py": ("D6", "the shared compute tier against per-replica Pythia"),
    "tools/chaos_ab.py": ("D7", "the fleet under injected faults"),
    "tools/service_throughput.py": (
        "D8", "gRPC throughput: CPU only until the card's machine has protobuf"),
    "parity_suite.py": ("D9", "needs the reference implementation's copy"),
    "tools/export_nasbench101.py": (
        "D10", "waits for the NASBench-101 table to be in the repository"),
}

_SKIPPED = ("chip_smoke.py", "serving_arrivals.py", "__graft_entry__.py")


def _scripts():
    scripts = sorted(p.relative_to(_ROOT).as_posix() for p in (_ROOT / "tools").glob("*.py"))
    return scripts + ["bench.py", "regret_suite.py", "parity_suite.py"]


def _public_functions(script: str):
    tree = ast.parse((_ROOT / script).read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not node.name.startswith("_")]


@pytest.mark.parametrize("script", _scripts())
def test_every_script_has_a_counterpart_or_is_queued(script):
    assert (script in _MAPPED) != (script in _QUEUED), (
        f"{script}: map it to its port counterpart or queue it with its ROADMAP item")
    names = _public_functions(script)
    if script in _QUEUED:
        stem = pathlib.Path(script).stem
        ported = sorted(p.relative_to(_ROOT).as_posix() for p in _PORT.rglob(f"{stem}.py"))
        assert not ported, f"{script} is queued but has a counterpart {ported}: map it"
        return
    assert "main" in names or (script, "main") in _REDESIGNED
    module = importlib.import_module(_MAPPED[script])
    missing = []
    for name in names:
        if (script, name) in _REDESIGNED:
            replacement, _ = _REDESIGNED[(script, name)]
            assert (_ROOT / replacement).exists(), replacement
            assert not hasattr(module, name), f"{name} is ported: drop it from _REDESIGNED"
        elif not callable(getattr(module, name, None)):
            missing.append(name)
    assert not missing, f"{_MAPPED[script]} lacks {missing} of {script}"


def test_regen_protos_is_redesigned_as_the_ports_protoc_script():
    """regen_protos' job, the message modules, is build.sh's: it names every
    .proto beside it, and each has its module."""
    protos = _PORT / "service" / "protos"
    script = (protos / "build.sh").read_text()
    for proto in sorted(protos.glob("*.proto")):
        assert f"vizier_tpu_torch/service/protos/{proto.name}" in script
        assert (protos / f"{proto.stem}_pb2.py").exists()


def test_the_lists_name_only_scripts_of_the_repository():
    scripts = set(_scripts())
    for listed in list(_MAPPED) + list(_QUEUED) + [s for s, _ in _REDESIGNED]:
        assert listed in scripts, f"{listed} is not a script of the repository"
    assert not scripts & set(_SKIPPED)


def test_the_queue_is_roadmaps_queue_in_its_order():
    """ROADMAP.md's queue D lists the queued tools in ``_QUEUED``'s order, and
    every item ``_QUEUED`` names is in ROADMAP.md."""
    roadmap = (_ROOT / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("### D. Tools still to port"):]
    section = section[:section.index("\n## ")] if "\n## " in section else section
    listed = re.findall(r"^\d+\. \*\*(D\d+)[^`]*`([^`]+)`", section, flags=re.M)
    queued = [(item, script) for script, (item, _) in _QUEUED.items() if item.startswith("D")]
    assert listed == queued
    for item, _ in _QUEUED.values():
        assert re.search(rf"\*\*{item}\b", roadmap), item
