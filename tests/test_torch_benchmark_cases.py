"""The JAX package's own tests of the benchmark slice, run on the port.

Each file below is read, every import of the JAX package rewritten to the
port's module of the same path, and its test classes (and module fixtures)
collected here under a per-file prefix. The cases are the JAX package's,
unchanged, but for the replacements listed beside a file: the port's
entry points run on CUDA unless given ``device="cpu"``. The classes cover
the combinatorial problems, every wrapper, NASBench-101/201, HPO-B, the
Atari-100k tables and gates, ``PredictorExperimenter``, the curve
converters, the state and record analyzers, the exploration scores, the
PyGlove DNA converters and the Ray Tune plumbing; the cross-package
comparisons are in ``test_torch_combinatorial.py``,
``test_torch_surrogates.py``, ``test_torch_analyzers.py`` and
``test_torch_pyglove.py``.
"""

from __future__ import annotations

import pathlib
import re
import sys
import types

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu_torch.service import clients

_ROOT = pathlib.Path(__file__).resolve().parent

# file -> (prefix, classes to take (None: all), [(text, replacement)]).
_FILES = {
    "benchmarks/test_combinatorial_and_wrappers.py": ("Combinatorial", None, []),
    "benchmarks/test_nasbench101_and_hpob.py": ("NASBench", None, [
        ("ard_optimizer=AdamOptimizer(maxiter=20)",
         "ard_optimizer=AdamOptimizer(maxiter=20, device='cpu'), device='cpu'")]),
    "benchmarks/test_analyzer_additions.py": ("Curves", None, []),
    "benchmarks/test_analyzer_depth.py": ("Records", None, []),
    "benchmarks/test_inventory_gaps.py": ("Inventory", None, [
        ("batch_size=5,\n        )", "batch_size=5,\n            device='cpu',\n        )")]),
    "pyglove/test_converters.py": ("PyGlove", None, []),
    "test_aux.py": ("Aux", ("TestAnalyzers", "TestIntegrations"), []),
}


def _port_module(relpath: str, replacements):
    """The JAX test file at ``relpath`` with the port's imports, executed as
    a module of its own."""
    source = re.sub(r"\bvizier_tpu\b", "vizier_tpu_torch", (_ROOT / relpath).read_text())
    for text, replacement in replacements:
        assert source.count(text) == 1, (relpath, text)
        source = source.replace(text, replacement)
    name = "torch_port_of_" + re.sub(r"\W", "_", relpath[:-3])
    module = types.ModuleType(name)
    module.__file__ = str(_ROOT / relpath)
    sys.modules[name] = module  # dataclasses look their module up
    exec(compile(source, f"{relpath} (on the port)", "exec"), module.__dict__)
    return module


for _path, (_prefix, _classes, _replacements) in _FILES.items():
    _module = _port_module(_path, _replacements)
    for _name, _value in vars(_module).items():
        if isinstance(_value, type) and _name.startswith("Test") and (
                _classes is None or _name in _classes):
            globals()[f"Test{_prefix}{_name[4:]}"] = type(
                f"Test{_prefix}{_name[4:]}", (_value,), {"__module__": __name__})
        elif hasattr(_value, "_fixture_function") or type(_value).__name__ == (
                "FixtureFunctionDefinition"):
            globals()[_name] = _value


@pytest.fixture(autouse=True)
def _in_process_clients_on_the_cpu(monkeypatch):
    """The Ray searcher's in-process service builds its policies on the
    CPU (the clients' default device is CUDA)."""
    monkeypatch.setattr(clients.environment_variables, "device", "cpu")
