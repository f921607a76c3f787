"""The port's mesh execution plane: placements, scheduling, slot parity,
fail isolation and the serving wiring.

Counterparts of the JAX package's ``tests/parallel/test_mesh_executor.py``
and of ``tests/designers/test_jit_stability.py``'s mesh case, on the port's
8 CPU entries (``torch_mesh_devices``). Where the JAX package holds slots
bitwise, the port holds them to ``test_torch_programs.py``'s standard: on
the CPU a slot equals its study alone float for float whatever the padded
batch (on the card C6's tolerance applies, ``chip_smoke.py``'s mesh phase).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu.parallel import mesh as jmesh
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.compute import ir
from vizier_tpu_torch.compute import registry
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
from vizier_tpu_torch.observability import tracing
from vizier_tpu_torch.optimizers import graphs
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.parallel.mesh import DevicePlacement, MeshConfig
from vizier_tpu_torch.serving import runtime as runtime_lib
from vizier_tpu_torch.serving.stats import ServingStats
from vizier_tpu_torch.testing import chaos, failing

_FAST = dict(
    ard_optimizer=lbfgs.AdamOptimizer(maxiter=15, device="cpu"),
    ard_restarts=3,
    max_acquisition_evaluations=200,
    warm_start_min_trials=0,
    device="cpu",
)


@pytest.fixture
def eight(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch)


def _problem():
    p = vz.ProblemStatement()
    for d in range(2):
        p.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    p.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return p


def _designer(seed, n=5, **overrides):
    d = VizierGPUCBPEBandit(_problem(), rng_seed=seed, **dict(_FAST, **overrides))
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(n):
        t = vz.Trial(parameters={"x0": float(rng.uniform()), "x1": float(rng.uniform())}, id=i + 1)
        t.complete(vz.Measurement(metrics={"obj": float(rng.uniform())}))
        trials.append(t)
    d.update(core_lib.CompletedTrials(trials))
    return d


def _params(suggestions):
    return [s.parameters.as_dict() for s in suggestions]


# -- stub programs ------------------------------------------------------------------


class _StubProgram(ir.DesignerProgram):
    """A shardable stub: records the thread, padding and placement of each
    device program."""

    kind = "stub"
    device_phase = "stub.flush"
    shardable_batch_axis = "study"

    def __init__(self):
        self.calls = []

    def bucket_key(self, designer, count):
        return ir.BucketKey("stub", 8, 1, 0, 1, count, statics=(designer.group,))

    def prepare(self, designer, count):
        return dict(designer=designer, value=designer.value)

    def device_program(self, items, pad_to=None, placement=None):
        self.calls.append((threading.current_thread().name, pad_to, placement))
        return [dict(value=item["value"]) for item in items]

    def finalize(self, designer, item, output):
        return [vz.TrialSuggestion(parameters={"x": float(output["value"])})]


class _Stub:
    threads = None  # the sequential suggests' thread names, when recorded

    def __init__(self, program, value, group="g"):
        self.program, self.value, self.group = program, value, group

    def compute_program(self, count):
        return self.program, self.program.bucket_key(self, count)

    def suggest(self, count=1):
        if _Stub.threads is not None:
            _Stub.threads.append(threading.current_thread().name)
        return [vz.TrialSuggestion(parameters={"x": float(self.value)})] * (count or 1)


def _run_concurrent(executor, designers, count=1):
    results, errors = [None] * len(designers), [None] * len(designers)

    def run(i):
        try:
            results[i] = executor.suggest(designers[i], count)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(designers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results, errors


# -- configuration and placements ---------------------------------------------


def test_mesh_off_builds_no_placement():
    ex = BatchExecutor(mesh=MeshConfig(), device="cpu")
    assert not ex.mesh_enabled and ex.placements() == [] and ex.bucket_placements() == {}
    ex.close()
    assert not jmesh.MeshConfig.from_env().enabled and not MeshConfig.from_env().enabled


def test_the_executor_carves_eight_devices_as_the_jax_package(eight):
    for shards, placements in ((1, 8), (2, 4), (8, 1)):
        ex = BatchExecutor(mesh=MeshConfig(enabled=True, shard_devices=shards), device="cpu")
        assert len(ex.placements()) == placements
        assert [p.label() for p in ex.placements()] == [f"mesh{i}" for i in range(placements)]
        assert ex.placement_flush_counts() == {f"mesh{i}": 0 for i in range(placements)}
        ex.close()


# -- scheduling ---------------------------------------------------------------------


def test_distinct_buckets_spread_and_stick(eight):
    program = _StubProgram()
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=5.0,
                       mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
    try:
        groups = [[_Stub(program, 10 * g + c, group=f"g{g}") for c in range(2)] for g in range(4)]
        for _ in range(2):  # two rounds: the assignments must not move
            results, errors = _run_concurrent(ex, [d for group in groups for d in group])
            assert errors == [None] * 8 and all(results)
        placements = ex.bucket_placements()["stub/t8/f1x0/m1/q1"]
        assert len(placements) == 4 and len(set(placements)) == 4
        assert sum(ex.placement_flush_counts().values()) >= 4
        for _thread, pad_to, placement in program.calls:
            assert placement is not None and pad_to in placement.pad_grid(8)
    finally:
        ex.close()


def test_eight_placements_run_every_launch_on_their_workers(eight):
    """Flushes and lone slots both run on ``vizier-mesh-worker-<i>``; the
    scheduler launches nothing."""
    program = _StubProgram()
    _Stub.threads = []
    ex = BatchExecutor(max_batch_size=4, max_wait_ms=5.0,
                       mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
    try:
        results, errors = _run_concurrent(ex, [_Stub(program, i) for i in range(4)])
        assert errors == [None] * 4
        assert ex.suggest(_Stub(program, 9, group="lone"), 1)[0].parameters["x"].value == 9.0
        names = [name for name, _, _ in program.calls] + _Stub.threads
        assert names and all(n.startswith("vizier-mesh-worker-") for n in names), names
        assert len(ex._workers) == 8
        assert all(w.name == f"vizier-mesh-worker-{i}" for i, w in enumerate(ex._workers))
    finally:
        _Stub.threads = None
        ex.close()


def test_one_placement_keeps_the_scheduler_thread():
    """One placement (the card's one H100, or the CPU): no worker, the
    scheduler runs the flushes and lone slots as without the mesh, and the
    flush pads at shard granularity with the placement passed."""
    program = _StubProgram()
    _Stub.threads = []
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=2000.0, mesh=MeshConfig(enabled=True),
                       device="cpu")
    try:
        (placement,) = ex.placements()
        results, errors = _run_concurrent(ex, [_Stub(program, i) for i in range(3)])
        assert errors == [None] * 3
        ex.suggest(_Stub(program, 9, group="lone"), 1)
        assert ex._workers == []
        names = [name for name, _, _ in program.calls] + _Stub.threads
        assert set(names) == {"vizier-torch-batch-executor"}
        assert [(pad, p) for _, pad, p in program.calls] == [(4, placement)]
        assert ex.placement_flush_counts() == {"mesh0": 2}
    finally:
        _Stub.threads = None
        ex.close()


def test_close_drains_the_mesh_queues(eight):
    program = _StubProgram()
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=10_000,
                       mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
    results = [None] * 3

    def run(i):
        results[i] = ex.suggest(_Stub(program, i), 1)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(400):
        if ex.queue_depth()["live"] == 3:
            break
        time.sleep(0.005)
    ex.close()  # the drained flush runs on its worker
    for t in threads:
        t.join(timeout=60)
    assert all(results)
    assert all(not w.is_alive() for w in ex._workers)


# -- slot parity --------------------------------------------------------------------


def test_a_one_device_mesh_serves_what_the_single_device_executor_serves():
    """Three studies: padded to 4 on the placement, to 8 without the mesh;
    every slot the same, float for float."""
    seeds = (21, 22, 23)
    single = BatchExecutor(max_batch_size=8, max_wait_ms=300.0)
    mesh1 = BatchExecutor(max_batch_size=8, max_wait_ms=300.0,
                          mesh=MeshConfig(enabled=True, num_devices=1), device="cpu")
    try:
        ref, errors = _run_concurrent(single, [_designer(s) for s in seeds])
        assert errors == [None] * 3
        out, errors = _run_concurrent(mesh1, [_designer(s) for s in seeds])
        assert errors == [None] * 3
        assert len(mesh1.placements()) == 1
        for r, o in zip(ref, out):
            assert _params(r) == _params(o)
    finally:
        single.close()
        mesh1.close()


def test_a_flush_split_over_eight_devices_equals_each_study_alone(eight):
    seeds = tuple(range(31, 39))
    sequential = [_designer(s).suggest(1) for s in seeds]
    stats = ServingStats()
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=10_000, stats=stats,
                       mesh=MeshConfig(enabled=True, shard_devices=8), device="cpu")
    try:
        results, errors = _run_concurrent(ex, [_designer(s) for s in seeds])
        assert errors == [None] * 8
        (placement,) = ex.placements()
        assert placement.num_devices == 8
        for seq, out in zip(sequential, results):
            assert _params(seq) == _params(out)
        assert stats.snapshot()["batched_suggests"] == 8
    finally:
        ex.close()


def test_mesh_off_from_the_environment_is_the_executor_as_it_was():
    seeds = (41, 42)
    plain = BatchExecutor(max_batch_size=8, max_wait_ms=300.0)
    from_env = BatchExecutor(max_batch_size=8, max_wait_ms=300.0, mesh=MeshConfig.from_env())
    try:
        assert not from_env.mesh_enabled
        ref, _ = _run_concurrent(plain, [_designer(s) for s in seeds])
        out, _ = _run_concurrent(from_env, [_designer(s) for s in seeds])
        for r, o in zip(ref, out):
            assert _params(r) == _params(o)
    finally:
        plain.close()
        from_env.close()


# -- fail isolation -----------------------------------------------------------------


def test_a_device_failure_on_one_placement_stays_there(eight):
    """Bucket A's device program is poisoned: its slots fall back alone (the
    chaos designer's own suggest strikes too, its mate's succeeds). Bucket B,
    on another placement, stays batched and equal to its studies alone."""
    monkey = chaos.ChaosMonkey(seed=0, failure_prob=1.0)
    chaotic = chaos.ChaosDesigner(_designer(51), monkey)
    chaotic.batch_prepare = lambda count=None: chaotic._inner_program(count).prepare(
        chaotic._inner, count or 1)  # reach the device program
    mate = _designer(52)
    other = [_designer(s, max_acquisition_evaluations=208) for s in (53, 54)]
    other_sequential = [_designer(s, max_acquisition_evaluations=208).suggest(1) for s in (53, 54)]
    stats = ServingStats()
    ex = BatchExecutor(max_batch_size=2, max_wait_ms=10_000, stats=stats,
                       mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
    try:
        results, errors = [None] * 4, [None] * 4

        def run(i, designer):
            try:
                results[i] = ex.suggest(designer, 1)
            except BaseException as e:  # noqa: BLE001
                errors[i] = e

        first = threading.Thread(target=run, args=(0, chaotic))
        first.start()
        for _ in range(400):
            if ex.pending_counts():
                break
            time.sleep(0.005)
        rest = [threading.Thread(target=run, args=(i, d))
                for i, d in ((1, mate), (2, other[0]), (3, other[1]))]
        for t in rest:
            t.start()
        for t in [first] + rest:
            t.join(timeout=300)
        assert isinstance(errors[0], failing.FailedSuggestError)
        assert errors[1:] == [None, None, None] and results[1]
        for seq, out in zip(other_sequential, results[2:]):
            assert _params(seq) == _params(out)
        snap = stats.snapshot()
        assert snap["batch_fallbacks"] == 2 and snap["mesh_flushes"] >= 2
        placements = {p for ps in ex.bucket_placements().values() for p in ps}
        assert len(placements) == 2
    finally:
        ex.close()


# -- tracing and metrics ------------------------------------------------------------


def test_flush_spans_and_series_carry_the_placement_label(eight):
    program = _StubProgram()
    tracer = tracing.Tracer(max_spans=256)
    previous = tracing.set_tracer(tracer)
    stats = ServingStats()
    # A full bucket of 2 flushes at once; the long window keeps a loaded
    # host from splitting a pair into two lone flushes.
    ex = BatchExecutor(max_batch_size=2, max_wait_ms=10_000, stats=stats,
                       metrics=stats.registry,
                       mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
    try:
        for g in range(3):
            _run_concurrent(ex, [_Stub(program, c, group=f"g{g}") for c in range(2)])
    finally:
        ex.close()
        tracing.set_tracer(previous)
    spans = [s for s in tracer.finished_spans() if s.name == "batch_executor.flush"]
    assert sorted({s.attributes["device"] for s in spans}) == ["mesh0", "mesh1", "mesh2"]
    text = stats.registry.prometheus_text()
    for label in ("mesh0", "mesh1", "mesh2"):
        assert f'device="{label}"' in text
    assert stats.snapshot()["mesh_flushes"] == 3


# -- one graph layout per (bucket, placement, grid step) ------------------------------


def test_one_graph_key_per_bucket_placement_and_grid_step(monkeypatch):
    """The layout a graphed ARD step is keyed by (the data's layout, the
    restart batch and the device): stable at a fixed grid step, one more
    when the occupancy crosses a step, none for new values. On the CPU every
    placement's device is the same, so a second placement shares the key;
    on the card the device in the key keeps placements apart."""
    keys = []
    real_train = gp_bandit._train_gp_studies

    def recording(model, optimizer, data, generators, *args):
        leaves = []
        keys.append((graphs.layout(data, leaves), len(generators), data.continuous.device))
        return real_train(model, optimizer, data, generators, *args)

    monkeypatch.setattr(gp_bandit, "_train_gp_studies", recording)
    kw = dict(ard_optimizer=lbfgs.AdamOptimizer(maxiter=3, device="cpu"), ard_restarts=2,
              max_acquisition_evaluations=100, device="cpu")

    def flush(seeds, placement):
        designers = []
        for s in seeds:
            d = gp_bandit.VizierGPBandit(_problem(), rng_seed=s, **kw)
            rng = np.random.default_rng(s)
            trials = []
            for i in range(4):
                t = vz.Trial(parameters={"x0": float(rng.uniform()), "x1": float(rng.uniform())},
                             id=i + 1)
                t.complete(vz.Measurement(metrics={"obj": float(rng.uniform())}))
                trials.append(t)
            d.update(core_lib.CompletedTrials(trials))
            designers.append(d)
        resolved = [registry.resolve(d, 3) for d in designers]
        program = resolved[0][0]
        assert program.shardable_batch_axis == "study"
        items = [program.prepare(d, 3) for d in designers]
        outs = program.device_program(items, pad_to=placement.pad_to(len(items), 8),
                                      placement=placement)
        for d, i, o in zip(designers, items, outs):
            program.finalize(d, i, o)

    cpu = torch.device("cpu")
    p0, p1 = DevicePlacement(0, [cpu]), DevicePlacement(1, [cpu])
    flush((70, 71), p0)  # occupancy 2 -> padded 2
    flush((72, 73), p0)  # the same grid step: the same key
    assert len(set(keys)) == 1
    flush((74, 75, 76), p0)  # occupancy 3 -> step 4: one new key
    flush((77, 78, 79, 80), p0)  # occupancy 4 -> the same step
    assert len(set(keys)) == 2
    flush((81, 82), p1)
    assert len(set(keys)) == 2 and all(k[-1] == cpu for k in keys)
    # A placement of two devices runs one key per chunk: both at its grid
    # step over 2 devices (one study each).
    flush((83, 84), DevicePlacement(2, [cpu, cpu]))
    assert keys[-1][1] == keys[-2][1] == 1


def test_prewarm_walks_the_placements_grid_on_their_workers(eight):
    """The walker runs batch sizes {1} ∪ pad_grid through each bucket's
    sticky placement, on the thread that will run its flushes."""
    threads = []
    real = BatchExecutor._prewarm_step

    def recording(self, *args):
        threads.append(threading.current_thread().name)
        return real(self, *args)

    ex = BatchExecutor(max_batch_size=4, mesh=MeshConfig(enabled=True, shard_devices=2),
                       device="cpu")
    try:
        ex._prewarm_step = lambda *a: recording(ex, *a)
        report = ex.prewarm(
            _problem(),
            lambda problem, **kw: VizierGPUCBPEBandit(problem, **_FAST),
            max_trials=8, batch_sizes=None,
        )
    finally:
        ex.close()
    sizes = sorted({row["batch_size"] for row in report})
    assert sizes == [1, 2, 4] == sorted({1, *ex.placements()[0].pad_grid(4)})
    assert all(row["status"] == "ok" for row in report), report
    assert threads and all(t.startswith("vizier-mesh-worker-") for t in threads)
    assert len(set(ex.bucket_placements())) >= 1


# -- the serving wiring -------------------------------------------------------------


def test_the_runtime_threads_the_mesh_config(eight):
    rt = runtime_lib.ServingRuntime(mesh=MeshConfig(enabled=True, num_devices=2), device="cpu")
    try:
        assert rt.batch_executor is not None and rt.batch_executor.mesh_enabled
        assert len(rt.batch_executor.placements()) == 2
    finally:
        rt.shutdown()
    rt = runtime_lib.ServingRuntime(device="cpu")
    try:
        assert rt.batch_executor is not None and not rt.batch_executor.mesh_enabled
    finally:
        rt.shutdown()


def test_the_runtime_reads_the_mesh_switches_when_batching(eight, monkeypatch):
    monkeypatch.setenv("VIZIER_TORCH_MESH", "1")
    monkeypatch.setenv("VIZIER_TORCH_MESH_DEVICES", "4")
    monkeypatch.setenv("VIZIER_TORCH_MESH_SHARD_DEVICES", "2")
    rt = runtime_lib.ServingRuntime(device="cpu")
    try:
        assert [p.num_devices for p in rt.batch_executor.placements()] == [2, 2]
        assert rt.mesh == MeshConfig(enabled=True, num_devices=4, shard_devices=2)
    finally:
        rt.shutdown()


def test_the_pythia_servicer_threads_the_mesh_config(eight):
    from vizier_tpu_torch.service import pythia_service

    servicer = pythia_service.PythiaServicer(
        mesh_config=MeshConfig(enabled=True, num_devices=2), device="cpu")
    try:
        executor = servicer.serving_runtime.batch_executor
        assert executor is not None and executor.mesh_enabled
        assert len(executor.placements()) == 2
    finally:
        servicer.shutdown()
