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


_FLEET_MODULES = [
    "vizier_tpu_torch.distributed", "vizier_tpu_torch.distributed.config",
    "vizier_tpu_torch.distributed.routing", "vizier_tpu_torch.distributed.wal",
    "vizier_tpu_torch.distributed.sharded_datastore", "vizier_tpu_torch.distributed.replication",
    "vizier_tpu_torch.distributed.replication_service", "vizier_tpu_torch.distributed.router_stub",
    "vizier_tpu_torch.distributed.replica_manager", "vizier_tpu_torch.distributed.compute_tier",
    "vizier_tpu_torch.distributed.pythia_server_main", "vizier_tpu_torch.distributed.replica_main",
    "vizier_tpu_torch.distributed.subprocess_fleet", "vizier_tpu_torch.testing",
    "vizier_tpu_torch.testing.netchaos", "vizier_tpu_torch.service.protos.replication_service_pb2",
]


@pytest.fixture(scope="module")
def fleet_imports():
    """Per fleet module, in one fresh interpreter: the JAX-side modules its
    import added, and the modules the package's exports resolve to."""
    code = f"""
import importlib, json, sys
out = {{}}
for name in {_FLEET_MODULES!r}:
    before = set(sys.modules)
    importlib.import_module(name)
    added = set(sys.modules) - before
    out[name] = sorted(m for m in added if m.split(".")[0] in ("jax", "jaxlib", "flax", "vizier_tpu"))
import vizier_tpu_torch.distributed as d
out["__all__"] = {{n: getattr(d, n).__module__ for n in d.__all__}}
print(json.dumps(out))
"""
    return json.loads(_fresh(code))


@pytest.mark.parametrize("module", _FLEET_MODULES)
def test_the_fleet_modules_load_no_jax(fleet_imports, module):
    assert fleet_imports[module] == []


def test_the_fleet_exports_equal_the_jax_packages_and_resolve_in_the_port(fleet_imports):
    import vizier_tpu.distributed as jax_distributed

    exports = fleet_imports["__all__"]
    assert sorted(exports) == sorted(jax_distributed.__all__)
    assert all(module.startswith("vizier_tpu_torch.distributed.") for module in exports.values())


def test_fleet_routing_needs_neither_grpc_nor_protobuf():
    """The card's fleet phase routes studies with the port's ``StudyRouter``:
    with grpc and protobuf blocked, the fleet package and its router import,
    and neither module is loaded."""
    code = """
import importlib, json, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
for name in ("vizier_tpu_torch.distributed", "vizier_tpu_torch.distributed.routing",
             "vizier_tpu_torch.distributed.config", "vizier_tpu_torch.testing.netchaos", "chip_smoke"):
    importlib.import_module(name)
import vizier_tpu_torch.distributed as d
router = d.StudyRouter(["a", "b"])
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] == "grpc" or m.startswith("google.protobuf")))
print(json.dumps([loaded, router.replica_for("owners/o/studies/s") in ("a", "b")]))
"""
    assert json.loads(_fresh(code)) == [[], True]


def test_the_replication_messages_come_from_the_ports_own_package():
    code = """
import json, sys
from vizier_tpu_torch.distributed import replication_service, subprocess_fleet
from vizier_tpu_torch.service.protos import replication_service_pb2 as pb
print(json.dumps([pb.HeartbeatRequest.__module__, pb.HeartbeatRequest.DESCRIPTOR.full_name,
                  pb.DESCRIPTOR.name, replication_service._pb is pb, subprocess_fleet._pb is pb,
                  sorted(m for m in sys.modules if m.endswith("_pb2") and "." not in m)]))
"""
    module, full_name, file_name, same_a, same_b, flat = json.loads(_fresh(code))
    assert module == "vizier_tpu_torch.service.protos.replication_service_pb2"
    assert full_name == "vizier_tpu_torch.HeartbeatRequest"
    assert file_name == "vizier_tpu_torch/service/protos/replication_service.proto"
    assert same_a and same_b and flat == []


_SLICE_MODULES = [
    "vizier_tpu_torch.loadgen", "vizier_tpu_torch.loadgen.models",
    "vizier_tpu_torch.loadgen.driver", "vizier_tpu_torch.loadgen.report",
    "vizier_tpu_torch.loadgen.soak", "vizier_tpu_torch.testing.failing",
    "vizier_tpu_torch.testing.chaos", "vizier_tpu_torch.testing.chaos_flushes",
    "vizier_tpu_torch.testing.test_studies",
    "vizier_tpu_torch.testing.test_runners", "vizier_tpu_torch.testing.optimizer_test_utils",
    "vizier_tpu_torch.testing.numpy_assertions", "vizier_tpu_torch.testing.simplekd_runner",
    "vizier_tpu_torch.testing.comparator_runner", "vizier_tpu_torch.testing.stress",
    "vizier_tpu_torch.benchmarks.experimenters.synthetic.simplekd",
]


@pytest.fixture(scope="module")
def slice_imports():
    """Per loadgen / testing module, in one fresh interpreter: the JAX-side
    modules its import added; and the two packages' exports."""
    code = f"""
import importlib, json, sys
out = {{}}
for name in {_SLICE_MODULES!r}:
    before = set(sys.modules)
    importlib.import_module(name)
    added = set(sys.modules) - before
    out[name] = sorted(m for m in added if m.split(".")[0] in ("jax", "jaxlib", "flax", "vizier_tpu"))
import vizier_tpu_torch.loadgen as lg
import vizier_tpu_torch.testing as t
out["loadgen"] = {{n: getattr(lg, n).__module__ for n in lg.__all__}}
out["testing"] = {{n: getattr(t, n).__module__ for n in t.__all__}}
print(json.dumps(out))
"""
    return json.loads(_fresh(code))


@pytest.mark.parametrize("module", _SLICE_MODULES)
def test_the_loadgen_and_testing_modules_load_no_jax(slice_imports, module):
    assert slice_imports[module] == []


def test_the_loadgen_and_testing_exports_equal_the_jax_packages(slice_imports):
    import inspect

    import vizier_tpu.loadgen as jax_loadgen
    import vizier_tpu.testing as jax_testing

    assert sorted(slice_imports["loadgen"]) == sorted(jax_loadgen.__all__)
    assert all(m.startswith("vizier_tpu_torch.loadgen.") for m in slice_imports["loadgen"].values())
    assert sorted(slice_imports["testing"]) == sorted(
        n for n, v in vars(jax_testing).items() if not n.startswith("_") and not inspect.ismodule(v))
    assert all(m.startswith("vizier_tpu_torch.testing.") for m in slice_imports["testing"].values())


def test_the_loadgen_engine_runs_without_grpc_or_protobuf():
    """The card's loadgen phase: with grpc and protobuf blocked, the models,
    the report and the loadgen driver import, the smoke scenario runs through the
    runtime transport on the CPU, and neither module is loaded."""
    code = """
import json, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
import torch
torch.set_num_threads(1)
from vizier_tpu_torch.loadgen import driver, models, report
from vizier_tpu_torch.testing import chaos, simplekd_runner, comparator_runner
import vizier_tpu_torch.loadgen as lg
scenario = lg.build_scenario(lg.smoke_config())
engine = driver.run(scenario, device="cpu", transport="runtime")
rep = report.build_report(scenario, engine)
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] == "grpc" or m.startswith("google.protobuf")))
print(json.dumps([loaded, engine.lost_studies(), len(engine.outcomes)]))
"""
    assert json.loads(_fresh(code)) == [[], [], 8]


_BENCHMARK_SLICE_MODULES = [
    "vizier_tpu_torch.benchmarks", "vizier_tpu_torch.benchmarks.experimenters",
    "vizier_tpu_torch.benchmarks.experimenters.wrappers",
    "vizier_tpu_torch.benchmarks.experimenters.combinatorial",
    "vizier_tpu_torch.benchmarks.experimenters.nasbench101",
    "vizier_tpu_torch.benchmarks.experimenters.surrogates",
    "vizier_tpu_torch.benchmarks.analyzers",
    "vizier_tpu_torch.benchmarks.analyzers.convergence_curve",
    "vizier_tpu_torch.benchmarks.analyzers.exploration_score",
    "vizier_tpu_torch.benchmarks.analyzers.state_analyzer",
    "vizier_tpu_torch.benchmarks.analyzers.plot_utils",
    "vizier_tpu_torch.pyglove.converters", "vizier_tpu_torch.pyglove.backend",
    "vizier_tpu_torch.service.policy_factory", "vizier_tpu_torch.raytune.vizier_search",
    "vizier_tpu_torch.raytune.run_tune",
]
# The benchmark slice's optional dependencies, each gated as in the JAX package.
_OPTIONAL = ("pyglove", "ray", "dopamine", "gin", "matplotlib", "pandas", "xgboost", "grpc",
             "google.protobuf")


@pytest.fixture(scope="module")
def benchmark_slice_imports():
    """In one fresh interpreter with every optional dependency blocked: per
    module, the JAX-side modules its import added; the optional modules
    loaded; the three packages' exports; and the errors of the gated entry
    points."""
    code = f"""
import importlib, json, sys
for name in {_OPTIONAL!r}:
    sys.modules[name] = None
out = {{}}
for name in {_BENCHMARK_SLICE_MODULES!r}:
    before = set(sys.modules)
    importlib.import_module(name)
    added = set(sys.modules) - before
    out[name] = sorted(m for m in added if m.split(".")[0] in ("jax", "jaxlib", "flax", "vizier_tpu"))
out["optional_loaded"] = sorted(m for m, v in sys.modules.items() if v is not None and any(
    m == o or m.startswith(o + ".") for o in {_OPTIONAL!r}))
for pkg in ("benchmarks", "benchmarks.experimenters", "benchmarks.analyzers"):
    mod = importlib.import_module("vizier_tpu_torch." + pkg)
    out[pkg] = sorted(n for n, v in vars(mod).items() if not n.startswith("_")
                      and getattr(v, "__module__", "").startswith("vizier_tpu_torch."))
from vizier_tpu_torch.benchmarks.experimenters import surrogates
from vizier_tpu_torch.pyglove import backend
from vizier_tpu_torch.raytune import run_tune
from vizier_tpu_torch import pyvizier as vz
errors = []
for call in (lambda: backend.TunerPolicy(None, None, None), lambda: backend.VizierBackend("s"),
             lambda: run_tune.run_tune_bbob("Sphere", 2),
             lambda: surrogates.Atari100kExperimenter().evaluate([vz.Trial(id=1)])):
    try:
        call()
        errors.append(None)
    except ImportError as e:
        errors.append(str(e))
out["errors"] = errors
print(json.dumps(out))
"""
    return json.loads(_fresh(code))


@pytest.mark.parametrize("module", _BENCHMARK_SLICE_MODULES)
def test_the_benchmark_slice_modules_load_no_jax_and_need_no_optional_package(
        benchmark_slice_imports, module):
    assert benchmark_slice_imports[module] == []
    assert benchmark_slice_imports["optional_loaded"] == []


@pytest.mark.parametrize("package", ["benchmarks", "benchmarks.experimenters",
                                     "benchmarks.analyzers"])
def test_the_benchmark_packages_export_what_the_jax_packages_export(benchmark_slice_imports,
                                                                    package):
    import importlib

    jax_module = importlib.import_module("vizier_tpu." + package)
    jax_exports = {n for n, v in vars(jax_module).items() if not n.startswith("_")
                   and getattr(v, "__module__", "").startswith("vizier_tpu.")}
    assert jax_exports <= set(benchmark_slice_imports[package])


def test_the_gated_entry_points_raise_the_jax_packages_errors(benchmark_slice_imports,
                                                             monkeypatch):
    """Without pyglove, ray or dopamine, constructing what needs them raises
    the JAX package's ImportError (its text, but for the port naming no
    install image: ``test_torch_surrogates.port_wording``). The JAX backend
    is loaded anew with ``pyglove`` blocked and restored afterwards."""
    import importlib
    import sys

    import vizier_tpu.pyglove as jpkg
    from vizier_tpu import pyvizier as jvz
    from vizier_tpu.benchmarks.experimenters import surrogates as jsur
    from vizier_tpu.raytune import run_tune as jrun

    name = "vizier_tpu.pyglove.backend"
    monkeypatch.setitem(sys.modules, "pyglove", None)
    monkeypatch.setattr(jpkg, "backend", importlib.import_module(name))
    monkeypatch.delitem(sys.modules, name)
    jbackend = importlib.import_module(name)
    expected = []
    for call in (lambda: jbackend.TunerPolicy(None, None, None),
                 lambda: jbackend.VizierBackend("s"),
                 lambda: jrun.run_tune_bbob("Sphere", 2),
                 lambda: jsur.Atari100kExperimenter().evaluate([jvz.Trial(id=1)])):
        with pytest.raises(ImportError) as info:
            call()
        expected.append(str(info.value))
    from test_torch_surrogates import port_wording

    assert benchmark_slice_imports["errors"] == port_wording(expected)


_SLICE16_MODULES = [
    "vizier_tpu_torch.analysis", "vizier_tpu_torch.analysis.registry",
    "vizier_tpu_torch.analysis.common", "vizier_tpu_torch.analysis.baseline",
    "vizier_tpu_torch.analysis.lock_order", "vizier_tpu_torch.analysis.debug_locks",
    "vizier_tpu_torch.analysis.env_registry", "vizier_tpu_torch.analysis.compute_ir",
    "vizier_tpu_torch.analysis.graph_discipline", "vizier_tpu_torch.analysis.suite",
    "vizier_tpu_torch.analysis.__main__", "vizier_tpu_torch.observability.device_timing",
    "vizier_tpu_torch.numerics", "vizier_tpu_torch.demos", "vizier_tpu_torch.demos.run_benchmark",
    "vizier_tpu_torch.demos.run_vizier_server", "vizier_tpu_torch.demos.run_vizier_client",
    "vizier_tpu_torch.utils.env",
]


@pytest.fixture(scope="module")
def slice16_imports():
    """Per module of the analysis suite, device timing, the facade and the
    demos, in one fresh interpreter with ``grpc``, ``protobuf`` and
    matplotlib blocked (the card's machine has none of them): whether it
    imported, and the JAX-side or blocked modules its import loaded."""
    code = f"""
import importlib, json, sys
for blocked in ("grpc", "google.protobuf", "matplotlib"):
    sys.modules[blocked] = None
out = {{}}
for name in {_SLICE16_MODULES!r}:
    before = set(sys.modules)
    importlib.import_module(name)
    added = set(m for m in sys.modules if sys.modules[m] is not None) - before
    out[name] = sorted(m for m in added if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "vizier_tpu", "grpc", "matplotlib") or m.startswith(
        "google.protobuf"))
import vizier_tpu_torch.analysis.registry as r
out["torch_free"] = "torch" not in sys.modules or None
print(json.dumps(out))
"""
    return json.loads(_fresh(code))


@pytest.mark.parametrize("module", _SLICE16_MODULES)
def test_the_slice16_modules_load_no_jax_grpc_protobuf_or_matplotlib(slice16_imports, module):
    assert slice16_imports[module] == []


def test_the_analysis_suite_loads_without_torch():
    """The suite is stdlib only, as the JAX package's: its registry, passes
    and command line import without torch."""
    code = """
import importlib, json, sys
sys.modules["torch"] = None
for name in ("vizier_tpu_torch.analysis", "vizier_tpu_torch.analysis.suite",
             "vizier_tpu_torch.analysis.__main__"):
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("vizier_tpu_torch."))))
"""
    loaded = json.loads(_fresh(code))
    assert all(m.startswith("vizier_tpu_torch.analysis") for m in loaded), loaded


def test_the_numerics_facade_has_the_jax_facades_names():
    import vizier_tpu.jax as jfacade

    import vizier_tpu_torch.numerics as facade

    def public(module):
        return sorted(n for n in vars(module) if not n.startswith("_"))

    assert public(facade) == public(jfacade)
    for name in public(jfacade):
        ours, theirs = getattr(facade, name), getattr(jfacade, name)
        if isinstance(theirs, int):  # DEFAULT_RANDOM_RESTARTS
            assert ours == theirs
        else:
            assert ours.__name__ == theirs.__name__


_MESH_MODULES = ["vizier_tpu_torch.parallel", "vizier_tpu_torch.parallel.mesh",
                 "vizier_tpu_torch.parallel.batch_executor"]


@pytest.fixture(scope="module")
def mesh_imports():
    """Per module of the mesh slice, in one fresh interpreter with ``grpc``
    and ``protobuf`` blocked (the card's machine has neither): the JAX-side
    or blocked modules its import loaded."""
    code = f"""
import importlib, json, sys
for blocked in ("grpc", "google.protobuf"):
    sys.modules[blocked] = None
out = {{}}
for name in {_MESH_MODULES!r}:
    before = set(sys.modules)
    importlib.import_module(name)
    added = set(m for m in sys.modules if sys.modules[m] is not None) - before
    out[name] = sorted(m for m in added if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "vizier_tpu", "grpc") or m.startswith("google.protobuf"))
print(json.dumps(out))
"""
    return json.loads(_fresh(code))


@pytest.mark.parametrize("module", _MESH_MODULES)
def test_the_mesh_modules_load_no_jax_grpc_or_protobuf(mesh_imports, module):
    assert mesh_imports[module] == []


def test_the_parallel_package_exports_the_jax_packages_names_but_the_multi_host_seam():
    import vizier_tpu.parallel as jparallel

    import vizier_tpu_torch.parallel as tparallel

    def public(module):
        return {n for n in vars(module) if not n.startswith("_") and n.isidentifier()}

    missing = public(jparallel) - public(tparallel)
    # The multi-host coordinator seam (and the jax modules the JAX package
    # imports by name) are the next slice's or not the port's.
    assert missing <= {"initialize_multihost", "jax", "jnp", "NamedSharding", "P", "Array",
                       "functools", "acquisitions", "gp_lib", "kernels", "lbfgs_lib",
                       "vectorized_lib", "batch_executor", "mesh"}, missing
    for name in ("create_mesh", "replicated", "batch_sharded", "train_gp_sharded",
                 "maximize_score_fn_sharded", "maximize_acquisition_sharded",
                 "suggest_step_sharded", "BatchExecutor", "BatchSlotError", "BucketKey",
                 "DevicePlacement", "MeshConfig", "build_placements", "multihost_mesh",
                 "DEVICE_AXIS", "Mesh"):
        assert hasattr(tparallel, name), name
