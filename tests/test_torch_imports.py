"""The port stands alone: it imports neither JAX nor the JAX package."""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"import jax|from jax|vizier_tpu(?!_torch)")


def _port_sources():
    files = sorted((_ROOT / "vizier_tpu_torch").rglob("*.py"))
    files += sorted((_ROOT / "vizier_tpu_torch" / "csrc").glob("*"))
    return files + [_ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_module():
    """Every port module (and chip_smoke) imported in a fresh interpreter adds
    neither ``jax`` nor any module of the JAX package to ``sys.modules``."""
    code = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import vizier_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vizier_tpu_torch.__path__, "vizier_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
added = set(sys.modules) - before
print(json.dumps(sorted(m for m in added if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vizier_tpu"))))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=300,
        check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(_ROOT)))
def test_sources_do_not_name_the_jax_package(path):
    for number, line in enumerate(path.read_text().splitlines(), 1):
        assert not _FORBIDDEN.search(line), f"{path.name}:{number}: {line}"


def _entry_points():
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.designers import evolution, gp_bandit, gp_ucb_pe
    from vizier_tpu_torch.designers import scalarizing_designer, scheduled_designer
    from vizier_tpu_torch.models import gp
    from vizier_tpu_torch.optimizers import eagle, lbfgs, vectorized

    problem = vz.ProblemStatement()
    problem.search_space.root.add_float_param("x", 0.0, 1.0)
    problem.metric_information.append(vz.MetricInformation(name="y"))
    strategy = eagle.VectorizedEagleStrategy(1, ())
    return {
        "VizierGPUCBPEBandit": lambda **kw: gp_ucb_pe.VizierGPUCBPEBandit(problem, **kw),
        "VizierGPBandit": lambda **kw: gp_bandit.VizierGPBandit(problem, **kw),
        "VizierGaussianProcess": lambda **kw: gp.VizierGaussianProcess(1, 0, **kw),
        "LbfgsOptimizer": lambda **kw: lbfgs.LbfgsOptimizer(**kw),
        "AdamOptimizer": lambda **kw: lbfgs.AdamOptimizer(**kw),
        "VectorizedOptimizer": lambda **kw: vectorized.VectorizedOptimizer(strategy, **kw),
        "NSGA2Designer": lambda **kw: evolution.NSGA2Designer(problem, **kw),
        "ScalarizingDesigner": lambda **kw: scalarizing_designer.ScalarizingDesigner(
            problem, designer_factory=lambda p: None, **kw),
        "scheduled_gp_ucb_pe": lambda **kw: _Resolved(
            scheduled_designer.scheduled_gp_ucb_pe(problem, **kw)),
        "scheduled_gp_bandit": lambda **kw: _Resolved(
            scheduled_designer.scheduled_gp_bandit(problem, **kw)),
    }


class _Resolved:
    """A scheduled designer's device: the one its factory builds on."""

    def __init__(self, scheduled):
        self.device = scheduled.designer_factory(
            scheduled.problem, **{k: s(0.0) for k, s in scheduled.scheduled_params.items()}
        ).device


@pytest.mark.parametrize(
    "name",
    ["VizierGPUCBPEBandit", "VizierGPBandit", "VizierGaussianProcess", "LbfgsOptimizer",
     "AdamOptimizer", "VectorizedOptimizer", "NSGA2Designer", "ScalarizingDesigner",
     "scheduled_gp_ucb_pe", "scheduled_gp_bandit"],
)
def test_entry_point_without_device_raises_when_no_gpu(monkeypatch, name):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def _fresh(code: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=300,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_the_cards_imports_need_neither_grpc_nor_protobuf():
    """The GPU machine has neither ``grpc`` nor ``protobuf``: with both
    blocked, ``chip_smoke`` and the packages it drives (the policy factory,
    the serving runtime with its coalescer and breakers, its opt-in planes —
    admission, speculative pre-compute, the SLO engine, the flight recorder,
    fleet dumps — the batch executor, the reliability layer) still import,
    and none of them loads either module."""
    code = """
import importlib, json, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
for name in ("vizier_tpu_torch", "vizier_tpu_torch.service", "vizier_tpu_torch.service.policy_factory",
             "vizier_tpu_torch.serving", "vizier_tpu_torch.serving.runtime",
             "vizier_tpu_torch.serving.coalescer", "vizier_tpu_torch.serving.admission",
             "vizier_tpu_torch.serving.speculative", "vizier_tpu_torch.serving.policy",
             "vizier_tpu_torch.observability.slo", "vizier_tpu_torch.observability.flight_recorder",
             "vizier_tpu_torch.observability.fleet", "vizier_tpu_torch.parallel.batch_executor",
             "vizier_tpu_torch.surrogates.config", "vizier_tpu_torch.reliability", "chip_smoke"):
    importlib.import_module(name)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] == "grpc" or m.startswith("google.protobuf")))
print(json.dumps(loaded))
"""
    assert json.loads(_fresh(code)) == []


def test_the_ports_messages_come_from_its_own_package():
    """The port's message classes live in ``vizier_tpu_torch.service.protos``
    under ``package vizier_tpu_torch``, and importing the port alone loads no
    flat top-level ``*_pb2`` module (the JAX package's are flat)."""
    code = """
import json, sys
from vizier_tpu_torch.service import clients, vizier_server
from vizier_tpu_torch.service.protos import study_pb2, pythia_service_pb2
print(json.dumps([study_pb2.Trial.__module__, study_pb2.Trial.DESCRIPTOR.full_name,
                  study_pb2.DESCRIPTOR.name, pythia_service_pb2.DESCRIPTOR.package,
                  sorted(m for m in sys.modules if m.endswith("_pb2") and "." not in m)]))
"""
    module, full_name, file_name, package, flat = json.loads(_fresh(code))
    assert module == "vizier_tpu_torch.service.protos.study_pb2"
    assert full_name == "vizier_tpu_torch.Trial"
    assert file_name == "vizier_tpu_torch/service/protos/study.proto"
    assert package == "vizier_tpu_torch" and flat == []
