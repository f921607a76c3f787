"""The port does all that the JAX package does: every public name has a
counterpart.

Every ``.py`` file under ``vizier_tpu/`` is parsed with ``ast`` (nothing of
JAX is imported). Each public top-level function and class, and each public
method and property of those classes, must exist in the port's module of the
same path (``hasattr`` on the imported port module or class, so inherited
methods and aliases count). Three modules were renamed (``_RENAMED``). What
the port deliberately does another way is in ``_DELIBERATE``: each entry
names the port's replacement, which must exist, and the reason. One case per
JAX module, so a failure names the module.
"""

from __future__ import annotations

import ast
import functools
import importlib
import pathlib
from typing import Dict, List, Tuple

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_JAX_ROOT = _ROOT / "vizier_tpu"

# JAX module path -> the port's module path, where the port renamed it.
_RENAMED = {
    "analysis/jax_discipline.py": "analysis/graph_discipline.py",
    "jax/__init__.py": "numerics/__init__.py",
    "observability/jax_timing.py": "observability/device_timing.py",
}

# (JAX module path, "name" or "Class.member") -> (the port's replacements as
# "module:attribute", each of which must exist; the reason).
_DELIBERATE: Dict[Tuple[str, str], Tuple[Tuple[str, ...], str]] = {
    ("optimizers/vectorized.py", "VectorizedStrategy.suggest"): (
        ("optimizers.vectorized:VectorizedStrategy.sweep_draws",
         "optimizers.vectorized:VectorizedStrategy.apply_suggest"),
        "C4: a sweep's random draws are made up front, then applied step by step"),
    ("optimizers/vectorized.py", "VectorizedStrategy.update"): (
        ("optimizers.vectorized:VectorizedStrategy.apply_update",),
        "C4: the update consumes the draws made up front"),
    ("optimizers/vectorized.py", "RandomVectorizedStrategy.suggest"): (
        ("optimizers.vectorized:RandomVectorizedStrategy.sweep_draws",
         "optimizers.vectorized:RandomVectorizedStrategy.apply_suggest"),
        "C4: draws up front"),
    ("optimizers/vectorized.py", "RandomVectorizedStrategy.update"): (
        ("optimizers.vectorized:RandomVectorizedStrategy.apply_update",),
        "C4: draws up front"),
    ("optimizers/eagle.py", "VectorizedEagleStrategy.suggest"): (
        ("optimizers.eagle:VectorizedEagleStrategy.sweep_draws",
         "optimizers.eagle:VectorizedEagleStrategy.apply_suggest"),
        "C4: draws up front"),
    ("optimizers/eagle.py", "VectorizedEagleStrategy.update"): (
        ("optimizers.eagle:VectorizedEagleStrategy.apply_update",),
        "C4: draws up front"),
    ("designers/gp_bandit.py", "train_batched"): (
        ("designers.gp_bandit:GPBanditProgram.device_program",
         "designers.gp_bandit:_train_gp_studies"),
        "the batched train runs inside the registered programs' device body"),
    ("designers/gp_bandit.py", "suggest_batched"): (
        ("designers.gp_bandit:GPBanditProgram.device_program",
         "designers.gp_bandit:_sweep_studies"),
        "the batched suggest is the registered program's device body"),
    ("designers/gp_ucb_pe.py", "suggest_batched"): (
        ("designers.gp_ucb_pe:UCBPEProgram.device_program",
         "designers.gp_ucb_pe:_suggest_batch_studies"),
        "the batched UCB-PE suggest is the registered program's device body"),
    ("analysis/jax_discipline.py", "JitRoot"): (
        ("analysis.graph_discipline:CaptureRoot",),
        "no jit to audit: the pass audits CUDA-graph capture roots instead"),
    ("analysis/jax_discipline.py", "JaxDisciplineResult"): (
        ("analysis.graph_discipline:GraphDisciplineResult",),
        "no jit to audit: the graph-capture discipline pass's result"),
    ("analysis/jax_discipline.py", "JaxDisciplineAnalyzer"): (
        ("analysis.graph_discipline:GraphDisciplineAnalyzer",),
        "no jit to audit: the graph-capture discipline analyzer"),
    ("analysis/jax_discipline.py", "JaxDisciplineAnalyzer.run"): (
        ("analysis.graph_discipline:GraphDisciplineAnalyzer.run",),
        "no jit to audit: the graph-capture discipline analyzer"),
    ("parallel/mesh.py", "DevicePlacement.batch_sharding"): (
        ("parallel.mesh:DevicePlacement.torch_devices", "parallel.mesh:DevicePlacement.shard"),
        "C21, C27: a placement lists torch devices and splits a batch into one chunk each"),
}

# The public names the port lacked before the duck-typed program seam and
# its satellites were ported: none of them may ever be allowlisted.
_GAPS_PORTED = {
    ("compute/registry.py", "DuckTypedProgram"),
    ("designers/gp_bandit.py", "VizierGPBandit.batch_bucket_key"),
    ("designers/gp_bandit.py", "VizierGPBandit.batch_prepare"),
    ("designers/gp_bandit.py", "VizierGPBandit.batch_execute"),
    ("designers/gp_bandit.py", "VizierGPBandit.batch_finalize"),
    ("designers/gp_ucb_pe.py", "VizierGPUCBPEBandit.batch_execute"),
    ("designers/gp_ucb_pe.py", "VizierGPUCBPEBandit.batch_finalize"),
    ("service/vizier_service.py", "VizierServicer.serving_stats"),
    ("serving/runtime.py", "ServingRuntime.suggest_latency_histogram"),
    ("types.py", "PaddedArray.as_padded"),
    ("types.py", "PaddedArray.dtype"),
    ("types.py", "PaddedArray.ndim"),
    ("types.py", "PaddedArray.true_shape"),
    ("types.py", "PaddedArray.num_valid"),
    ("types.py", "PaddedArray.joint_valid_mask"),
    ("types.py", "PaddedArray.replace_fill_value"),
    ("types.py", "PaddedArray.unpad"),
    ("types.py", "PaddedArray.pad_to"),
    ("models/gp.py", "EnsemblePredictive.ensemble_size"),
    ("surrogates/sparse_gp.py", "SparseEnsemblePredictive.ensemble_size"),
    ("models/params.py", "ParameterCollection.spec"),
    ("analysis/registry.py", "env_set"),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _public_names(path: pathlib.Path) -> List[str]:
    """Public top-level functions and classes, and ``Class.member`` for each
    class's public methods and properties, in source order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names.append(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            names.append(node.name)
            names += [f"{node.name}.{sub.name}" for sub in node.body
                      if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and _public(sub.name)]
    return names


@functools.lru_cache(maxsize=None)
def _jax_modules() -> Dict[str, Tuple[str, ...]]:
    """{JAX module path: its public names} for every module that has any."""
    out = {}
    for path in sorted(_JAX_ROOT.rglob("*.py")):
        names = _public_names(path)
        if names:
            out[path.relative_to(_JAX_ROOT).as_posix()] = tuple(names)
    return out


def _port_module_name(rel: str) -> str:
    rel = _RENAMED.get(rel, rel)[: -len(".py")].replace("/", ".")
    if rel.endswith("__init__"):
        rel = rel[: -len("__init__")].rstrip(".")
    return "vizier_tpu_torch" + (f".{rel}" if rel else "")


def _lookup(module, dotted: str):
    """The attribute ``dotted`` ("name" or "Class.member") of ``module``, or
    None. A property is looked up on the class, as ``hasattr`` does."""
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return None
        obj = getattr(obj, part)
    return obj


def _missing(rel: str) -> List[str]:
    module = importlib.import_module(_port_module_name(rel))
    return [name for name in _jax_modules()[rel] if _lookup(module, name) is None]


def test_the_walk_covers_the_jax_package():
    modules = _jax_modules()
    assert len(modules) > 150
    assert "compute/registry.py" in modules and "types.py" in modules
    assert "DuckTypedProgram" in modules["compute/registry.py"]
    assert "PaddedArray.unpad" in modules["types.py"]
    for rel in _RENAMED:
        assert (_JAX_ROOT / rel).exists() and not (_ROOT / "vizier_tpu_torch" / rel).exists()


@pytest.mark.parametrize("rel", sorted(_jax_modules()))
def test_every_public_name_has_a_counterpart_in_the_port(rel):
    unexplained = [name for name in _missing(rel) if (rel, name) not in _DELIBERATE]
    assert not unexplained, (
        f"{_port_module_name(rel)} lacks {unexplained} of the JAX package's {rel}; port them "
        f"or, for a deliberate redesign, list each in _DELIBERATE with its replacement")


@pytest.mark.parametrize("entry", sorted(_DELIBERATE), ids=lambda e: f"{e[0]}:{e[1]}")
def test_each_deliberate_redesign_names_a_replacement_that_exists(entry):
    rel, name = entry
    replacements, reason = _DELIBERATE[entry]
    assert replacements and reason
    assert name in _jax_modules()[rel], f"{rel} has no public {name}: drop the entry"
    assert name in _missing(rel), f"the port has {name} now: drop the entry"
    for replacement in replacements:
        module_name, attribute = replacement.split(":")
        module = importlib.import_module(f"vizier_tpu_torch.{module_name}")
        assert _lookup(module, attribute) is not None, replacement


def test_no_ported_gap_is_allowlisted():
    assert not _GAPS_PORTED & set(_DELIBERATE)
    for rel, name in sorted(_GAPS_PORTED):
        assert name in _jax_modules()[rel], (rel, name)
        assert name not in _missing(rel), (rel, name)
