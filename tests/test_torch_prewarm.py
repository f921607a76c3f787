"""Prewarm and the compile cache of the port, held to the JAX package's walker.

- ``BatchExecutor.prewarm`` walks the same (bucket, count, batch size) grid
  as the JAX package's walker for the same problem and ``max_trials``, and
  every step runs; on the CPU no CUDA graph is captured.
- ``PythiaServicer.prewarm`` walks each registered program's
  ``prewarm_factory`` once per designer, and the policy factory starts one
  background prewarm per search-space shape when ``batching_prewarm`` is on.
- ``batching_prewarm`` and ``compilation_cache_dir`` no longer raise, the
  switches reach ``ServingConfig.from_env``, and the cache directory is where
  ``ops/native.py`` builds. A bucket's first flush after prewarm capturing no
  graph is a card test (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import pathlib

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_bandit as jgp_bandit
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu.parallel import batch_executor as jbatch_executor
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.compute import registry as compute_registry
from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe
from vizier_tpu_torch.ops import native
from vizier_tpu_torch.optimizers import graphs
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.serving import config as serving_config
from vizier_tpu_torch.serving import runtime as runtime_lib


def _problem(pkg, dims=2):
    p = pkg.ProblemStatement()
    for d in range(dims):
        p.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    p.metric_information.append(
        pkg.MetricInformation(name="obj", goal=pkg.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _fast(lbfgs_module, **extra):
    return dict(ard_optimizer=lbfgs_module.AdamOptimizer(maxiter=5, **extra), ard_restarts=2,
                max_acquisition_evaluations=100, warm_start_min_trials=0)


def _port_factory(p):
    return gp_bandit.VizierGPBandit(p, rng_seed=0, device="cpu", **_fast(lbfgs, device="cpu"))


@pytest.mark.parametrize("max_trials,counts", [(8, (1,)), (16, (1, 2))])
def test_the_walk_equals_the_jax_walkers_grid(max_trials, counts):
    jex = jbatch_executor.BatchExecutor(max_batch_size=2, max_wait_ms=10)
    ex = batch_executor.BatchExecutor(max_batch_size=2, max_wait_ms=10)
    try:
        theirs = jex.prewarm(
            _problem(jvz), lambda p: jgp_bandit.VizierGPBandit(p, rng_seed=0, **_fast(jlbfgs)),
            max_trials=max_trials, counts=counts)
        ours = ex.prewarm(_problem(vz), _port_factory, max_trials=max_trials, counts=counts)
    finally:
        jex.close()
        ex.close()
    grid = lambda rows: [(r["pad_trials"], r["count"], r["batch_size"]) for r in rows]  # noqa: E731
    assert grid(ours) == grid(theirs)
    assert [r["status"] for r in ours] == [r["status"] for r in theirs] == ["ok"] * len(ours)
    assert all(r["seconds"] >= 0 and r["captures"] == 0 for r in ours)  # no graph on the CPU


class _Broken(gp_bandit.VizierGPBandit):
    """A designer whose compute fails: every step of its walk errors."""

    def compute_program(self, count):
        return None

    def suggest(self, count=None):
        raise RuntimeError("suggest exploded")


def test_a_failed_step_is_reported_not_raised():
    def broken(p):
        return _Broken(p, rng_seed=0, device="cpu", **_fast(lbfgs, device="cpu"))

    ex = batch_executor.BatchExecutor(max_batch_size=2, max_wait_ms=10)
    try:
        rows = ex.prewarm(_problem(vz), broken, max_trials=8)
    finally:
        ex.close()
    assert [(r["pad_trials"], r["batch_size"]) for r in rows] == [(8, 1), (8, 2)]
    assert all(r["status"].startswith("error:") for r in rows)


def test_every_registered_program_is_prewarmable_as_in_the_jax_package():
    from vizier_tpu.compute import registry as jregistry

    problem = _problem(vz)
    jprograms = {p.kind: p for p in jregistry.programs()}
    assert sorted(jprograms) == sorted(compute_registry.kinds())
    for program in compute_registry.programs():
        designer = program.prewarm_factory(problem, device="cpu")
        jprogram = jprograms[program.kind]
        assert type(designer).__name__ == type(jprogram.prewarm_factory(_problem(jvz))).__name__
        assert program.device_phase == jprogram.device_phase
        assert program.algorithms == jprogram.algorithms
    assert {p.kind for p in compute_registry.programs_for_algorithm("DEFAULT")} == {
        "gp_ucb_pe", "gp_ucb_pe_sparse"}


def _pythia(config):
    from vizier_tpu_torch.service import pythia_service

    pythia = pythia_service.PythiaServicer(None, serving_config=config, device="cpu")
    base = pythia._policy_factory._gp_designer_kwargs
    pythia._policy_factory._gp_designer_kwargs = lambda: dict(
        base(), **_fast(lbfgs, device="cpu"))
    return pythia


def test_the_servicer_walks_each_designer_once():
    pythia = _pythia(serving_config.ServingConfig(batch_max_size=2,
                                                  batching_prewarm_max_trials=8))
    try:
        config = vz.StudyConfig.from_problem(_problem(vz))
        rows = pythia.prewarm(config, algorithm="GAUSSIAN_PROCESS_BANDIT")
        default_rows = pythia.prewarm(config)
    finally:
        pythia.shutdown()
    # Exact and sparse programs share one designer: one walk, not two.
    assert [(r["pad_trials"], r["batch_size"]) for r in rows] == [(8, 1), (8, 2)]
    assert [(r["pad_trials"], r["batch_size"]) for r in default_rows] == [(8, 1), (8, 2)]
    assert all(r["status"] == "ok" for r in rows + default_rows)


def test_prewarm_is_a_noop_with_batching_off():
    pythia = _pythia(serving_config.ServingConfig(batching=False))
    try:
        assert pythia.prewarm(vz.StudyConfig.from_problem(_problem(vz))) == []
    finally:
        pythia.shutdown()


def test_the_factory_starts_one_background_prewarm_per_shape():
    runtime = runtime_lib.ServingRuntime(serving_config.ServingConfig(
        batching_prewarm=True, batch_max_size=2, batching_prewarm_max_trials=8))
    try:
        assert runtime.maybe_prewarm_batching_async(_problem(vz), _port_factory)
        assert not runtime.maybe_prewarm_batching_async(_problem(vz), _port_factory)
        assert runtime.maybe_prewarm_batching_async(_problem(vz, dims=3), _port_factory)
    finally:
        runtime.shutdown()  # joins the prewarm threads
    assert runtime._prewarm_threads == []
    off = runtime_lib.ServingRuntime(serving_config.ServingConfig(batch_max_size=2))
    try:
        assert not off.maybe_prewarm_batching_async(_problem(vz), _port_factory)
    finally:
        off.shutdown()


def test_the_policy_factory_hook_prewarms_a_new_study_shape(monkeypatch):
    from vizier_tpu_torch.service import policy_factory as policy_factory_lib

    runtime = runtime_lib.ServingRuntime(serving_config.ServingConfig(batching_prewarm=True))
    calls = []
    monkeypatch.setattr(runtime, "maybe_prewarm_batching_async",
                        lambda problem, factory: calls.append((problem, factory)) or True)
    try:
        factory = policy_factory_lib.DefaultPolicyFactory(serving_runtime=runtime, device="cpu")
        problem = _problem(vz)
        for algorithm in ("DEFAULT", "GAUSSIAN_PROCESS_BANDIT"):
            factory(problem, algorithm, object(), f"owners/o/studies/{algorithm}")
    finally:
        runtime.shutdown()
    assert [c[0] for c in calls] == [problem, problem]
    built = [c[1](problem) for c in calls]
    assert [type(d) for d in built] == [gp_ucb_pe.VizierGPUCBPEBandit, gp_bandit.VizierGPBandit]


def test_prewarm_and_the_compile_cache_no_longer_raise(tmp_path, monkeypatch):
    config = serving_config.ServingConfig(batching_prewarm=True,
                                          compilation_cache_dir=str(tmp_path / "cache"))
    assert config.batching_prewarm and config.compilation_cache_dir
    monkeypatch.setenv("VIZIER_TORCH_BATCHING_PREWARM", "1")
    monkeypatch.setenv("VIZIER_TORCH_COMPILE_CACHE_DIR", str(tmp_path / "env_cache"))
    from_env = serving_config.ServingConfig.from_env()
    assert from_env.batching_prewarm
    assert from_env.compilation_cache_dir == str(tmp_path / "env_cache")
    monkeypatch.delenv("VIZIER_TORCH_BATCHING_PREWARM")
    monkeypatch.delenv("VIZIER_TORCH_COMPILE_CACHE_DIR")
    default = serving_config.ServingConfig.from_env()
    assert not default.batching_prewarm and default.compilation_cache_dir is None


def test_the_compile_cache_directory_is_where_the_kernels_build(tmp_path):
    assert native.build_dir() == native.BUILD_DIR
    runtime = runtime_lib.ServingRuntime(serving_config.ServingConfig(
        batching=False, compilation_cache_dir=str(tmp_path / "kernels")))
    try:
        assert native.build_dir() == pathlib.Path(tmp_path / "kernels").resolve()
    finally:
        runtime.shutdown()
        native.set_build_dir(None)
    assert native.build_dir() == native.BUILD_DIR


def test_a_built_library_is_reused_from_the_cache_directory(tmp_path, monkeypatch):
    """``build`` reuses a library of the same source and flags in the
    directory it is given, without calling nvcc (there is none here)."""
    source = tmp_path / "k.cu"
    source.write_text("// kernel\n")
    loaded = []
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: loaded.append(path) or type(
        "Lib", (), {})())
    monkeypatch.setattr(native, "_nvcc", lambda: pytest.fail("rebuilt a cached library"))
    import hashlib

    digest = hashlib.sha256(source.read_bytes() + "\0".join(native.NVCC_FLAGS).encode())
    target = tmp_path / "cache" / f"libk_{digest.hexdigest()[:16]}.so"
    target.parent.mkdir()
    target.write_bytes(b"")
    lib = native.build(source, tmp_path / "cache")
    assert loaded == [str(target)] and lib.build_log == ""


def test_graph_stats_are_untouched_by_a_cpu_prewarm():
    before = dict(graphs.STATS)
    ex = batch_executor.BatchExecutor(max_batch_size=2, max_wait_ms=10)
    try:
        ex.prewarm(_problem(vz), _port_factory, max_trials=8)
    finally:
        ex.close()
    assert graphs.STATS["captures"] == before["captures"]
