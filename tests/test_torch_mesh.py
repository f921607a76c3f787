"""The port's mesh plane against the JAX package's: ``MeshConfig``, the
placements' shard-granularity padding, the process-local carving and
``create_mesh``, on the JAX package's 8 virtual CPU devices and the port's
8 CPU entries (``torch_mesh_devices``)."""

from __future__ import annotations

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu import parallel as jparallel
from vizier_tpu.parallel import mesh as jmesh
from vizier_tpu_torch import parallel as tparallel
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers import gp_ucb_pe
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs
from vizier_tpu_torch.parallel import mesh as tmesh
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.serving.stats import ServingStats


class _FakeDevice:
    def __init__(self, device_id, process_index):
        self.id = device_id
        self.process_index = process_index


def test_mesh_config_defaults_equal_the_jax_packages():
    assert dataclasses.asdict(tmesh.MeshConfig()) == dataclasses.asdict(jmesh.MeshConfig())


def test_mesh_config_from_env_reads_the_ports_switches(monkeypatch):
    assert tmesh.MeshConfig.from_env() == tmesh.MeshConfig()
    values = {"MESH": "1", "MESH_DEVICES": "4", "MESH_SHARD_DEVICES": "2",
              "MESH_COORDINATOR": "127.0.0.1:1234", "MESH_PROCESSES": "2",
              "MESH_PROCESS_ID": "1"}
    for name, value in values.items():
        monkeypatch.setenv(f"VIZIER_{name}", value)
        monkeypatch.setenv(f"VIZIER_TORCH_{name}", value)
    port, reference = tmesh.MeshConfig.from_env(), jmesh.MeshConfig.from_env()
    assert (port.enabled, port.num_devices, port.shard_devices) == (True, 4, 2)
    assert (port.coordinator_address, port.num_processes, port.process_id) == (
        "127.0.0.1:1234", 2, 1)
    assert dataclasses.asdict(port) == dataclasses.asdict(reference)
    monkeypatch.setenv("VIZIER_TORCH_MESH_SHARD_DEVICES", "0")
    assert tmesh.MeshConfig.from_env().shard_devices == 1


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_pad_to_and_pad_grid_equal_the_jax_packages(shards):
    port = tmesh.DevicePlacement(0, [torch.device("cpu")] * shards)
    reference = jmesh.DevicePlacement(0, jax.devices()[:shards])
    for max_batch in range(1, 13):
        assert port.pad_grid(max_batch) == reference.pad_grid(max_batch)
        for occupancy in range(1, max_batch + 1):
            padded = port.pad_to(occupancy, max_batch)
            assert padded == reference.pad_to(occupancy, max_batch)
            assert padded >= occupancy and padded % shards == 0
            assert padded in port.pad_grid(max_batch)


def test_placement_labels_equal_the_jax_packages():
    port = tmesh.DevicePlacement(3, [torch.device("cpu")])
    reference = jmesh.DevicePlacement(3, jax.devices()[:1])
    assert port.label() == reference.label() == "mesh3"
    assert port.describe() == "mesh3[devices cpu]" and port.num_devices == 1
    with pytest.raises(ValueError):
        tmesh.DevicePlacement(0, [])


@pytest.mark.parametrize("hosts,per_host,shards", [
    (2, 4, 2), (2, 4, 3), (2, 3, 2), (1, 8, 2), (3, 3, 4), (2, 5, 1)])
def test_carving_prefers_process_local_groups_as_the_jax_package(hosts, per_host, shards):
    devices = [_FakeDevice(i, i // per_host) for i in range(hosts * per_host)]
    port = [[d.id for d in g] for g in tmesh._carve_device_groups(devices, shards)]
    reference = [[d.id for d in g] for g in jmesh._carve_device_groups(devices, shards)]
    assert port == reference
    # A device with no process index counts as process 0, in both packages.
    plain = [torch.device("cpu")] * per_host
    assert len(tmesh._carve_device_groups(plain, shards)) == per_host // shards


def test_build_placements_over_eight_devices_as_the_jax_package(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch)
    for kwargs in (dict(shard_devices=1), dict(shard_devices=2), dict(shard_devices=8),
                   dict(num_devices=4, shard_devices=2), dict(num_devices=1),
                   dict(shard_devices=3), dict(num_devices=100)):
        port = tmesh.build_placements(tmesh.MeshConfig(enabled=True, **kwargs), "cpu")
        reference = jmesh.build_placements(jmesh.MeshConfig(enabled=True, **kwargs))
        assert [p.num_devices for p in port] == [p.num_devices for p in reference], kwargs
        assert [p.label() for p in port] == [p.label() for p in reference]


@pytest.mark.parametrize("spec", [
    dict(num_processes=2, process_id=None),  # torch: rank parameter missing
    dict(num_processes=None, process_id=0),  # torch: world size missing
    dict(num_processes=2, process_id=2),  # not a rank of 2 processes
    dict(num_processes=1, process_id=0, address="no-port-here"),  # torch: port missing
])
def test_a_failed_explicit_init_raises(spec):
    """An explicit coordinator whose init fails raises, from
    ``initialize_multihost`` and from a coordinator in the mesh config, as
    the JAX package's explicit branch does; nothing is left initialized."""
    import torch.distributed as dist

    spec = dict(spec)
    address = spec.pop("address", "127.0.0.1:1")
    with pytest.raises(ValueError):
        tparallel.initialize_multihost(coordinator_address=address, device="cpu", **spec)
    config = tmesh.MeshConfig(
        enabled=True, coordinator_address=address, num_processes=spec["num_processes"] or 0,
        process_id=-1 if spec["process_id"] is None else spec["process_id"])
    with pytest.raises(ValueError):
        tmesh.build_placements(config, "cpu")
    with pytest.raises(ValueError):
        BatchExecutor(mesh=config, device="cpu")
    assert not dist.is_initialized()


def test_a_join_gathers_the_counts_once_and_a_group_gone_is_forgotten(monkeypatch):
    """A one-process gloo group joined in this process: the global list is
    built from the join's counts (a later join, list or placement gathers
    nothing), a device type the join did not count is refused, and once the
    group is destroyed the list is the host's again."""
    import socket

    import torch.distributed as dist

    entries = {"cpu": [torch.device("cpu")] * 2, "cuda": [torch.device("cuda", 0)]}
    monkeypatch.setattr(tmesh, "local_devices", lambda device="cuda": list(entries[device]))
    monkeypatch.setattr(tparallel, "local_devices", tmesh.local_devices)
    monkeypatch.setattr(tmesh, "_JOINED", None)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    mesh = tparallel.initialize_multihost(
        coordinator_address=address, num_processes=1, process_id=0, device="cpu")
    try:
        calls, real_gather = [], dist.all_gather_object
        monkeypatch.setattr(dist, "all_gather_object",
                            lambda *a, **k: calls.append(a) or real_gather(*a, **k))
        assert mesh.devices == (tmesh.ProcessDevice(0, 0, 0, torch.device("cpu")),
                                tmesh.ProcessDevice(0, 1, 1, torch.device("cpu")))
        again = tparallel.initialize_multihost(
            coordinator_address=address, num_processes=1, process_id=0, device="cpu")
        assert again == mesh
        placements = tmesh.build_placements(
            tmesh.MeshConfig(enabled=True, shard_devices=2), "cpu")
        assert [p.torch_devices for p in placements] == [(torch.device("cpu"),) * 2]
        assert calls == []
        with pytest.raises(ValueError, match="joined with cpu devices, not cuda"):
            tmesh.global_devices("cuda")
    finally:
        dist.destroy_process_group()
    assert tmesh.global_devices("cpu") == entries["cpu"]


def _two_process_devices(monkeypatch, n_local: int = 2):
    """This process as process 0 of two, each with ``n_local`` CPU entries."""
    entries = [tmesh.ProcessDevice(p, i, p * n_local + i, torch.device("cpu") if p == 0 else None)
               for p in range(2) for i in range(n_local)]
    monkeypatch.setattr(tmesh, "global_devices", lambda device="cuda": list(entries))
    return entries


@pytest.mark.parametrize("shards", [3, 4])
def test_an_executor_refuses_a_placement_that_spans_processes(monkeypatch, shards):
    """Carving 2 + 2 devices into groups of 3 or 4 puts another process's
    device in a placement: the executor refuses it when it is built (one
    process cannot make another enter its flush), the placements themselves
    are still the JAX package's carve."""
    entries = _two_process_devices(monkeypatch)
    config = tmesh.MeshConfig(enabled=True, shard_devices=shards)
    placements = tmesh.build_placements(config, "cpu")
    reference = jmesh._carve_device_groups(entries, shards)
    assert [[d.id for d in p.devices] for p in placements] == [[d.id for d in g] for g in reference]
    assert any(p.spans_processes for p in placements)
    with pytest.raises(ValueError, match="spans processes"):
        BatchExecutor(mesh=config, device="cpu")


def test_an_executor_assigns_buckets_only_to_its_own_processs_placements(monkeypatch):
    """The carve holds both processes' placements; the executor keeps only
    its own, so every bucket goes there and it starts no placement worker."""
    _two_process_devices(monkeypatch)
    config = tmesh.MeshConfig(enabled=True, shard_devices=2)
    assert [p.label() for p in tmesh.build_placements(config, "cpu")] == ["mesh0", "mesh1"]
    ex = BatchExecutor(mesh=config, device="cpu")
    try:
        placements = ex.placements()
        assert [(p.label(), p.is_local, p.spans_processes) for p in placements] == [
            ("mesh0", True, False)]
        assert placements[0].torch_devices == (torch.device("cpu"),) * 2
        assert [ex._placement_for(("bucket", i)).label() for i in range(4)] == ["mesh0"] * 4
        assert ex.placement_flush_counts() == {"mesh0": 0}
        assert not ex._uses_workers()
    finally:
        ex.close()


def _studies(designer_cls, seeds):
    kw = dict(ard_optimizer=tlbfgs.AdamOptimizer(maxiter=5, device="cpu"), ard_restarts=2,
              max_acquisition_evaluations=100, device="cpu")
    problem = vz.ProblemStatement()
    for d in range(2):
        problem.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    designers = []
    for seed in seeds:
        d = designer_cls(problem, rng_seed=seed, **kw)
        rng = np.random.default_rng(seed)
        trials = []
        for i in range(5):
            t = vz.Trial(parameters={"x0": float(rng.uniform()), "x1": float(rng.uniform())},
                         id=i + 1)
            t.complete(vz.Measurement(metrics={"obj": float(rng.uniform())}))
            trials.append(t)
        d.update(core_lib.CompletedTrials(trials))
        designers.append(d)
    return designers


@pytest.mark.parametrize("designer_cls", [gp_bandit.VizierGPBandit,
                                          gp_ucb_pe.VizierGPUCBPEBandit])
def test_a_flush_on_the_local_placement_of_two_processes_runs_batched(monkeypatch,
                                                                       designer_cls):
    """Process 0 of two, 2 CPU entries each: the executor's own placement
    holds ``ProcessDevice`` entries, and a flush of two studies there runs
    batched, split over its two devices, each slot equal to its study
    alone, with no fallback."""
    _two_process_devices(monkeypatch)
    seeds = (41, 42)
    alone = [[s.parameters.as_dict() for s in d.suggest(1)]
             for d in _studies(designer_cls, seeds)]
    stats = ServingStats()
    ex = BatchExecutor(max_batch_size=2, max_wait_ms=60_000, stats=stats, device="cpu",
                       mesh=tmesh.MeshConfig(enabled=True, shard_devices=2))
    slots = []
    real_execute = ex._execute

    def execute(key, queued, reason, placement):
        real_execute(key, queued, reason, placement)
        slots.extend(queued)

    ex._execute = execute
    designers = _studies(designer_cls, seeds)
    results = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, ex.suggest(designers[i], 1))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        ex.close()
    assert [slot.action for slot in slots] == ["batched", "batched"]
    snap = stats.snapshot()
    assert snap["batch_fallbacks"] == 0 and snap["batched_suggests"] == 2
    assert ex.placement_flush_counts() == {"mesh0": 1}
    assert [[s.parameters.as_dict() for s in r] for r in results] == alone


def test_local_devices_lists_the_real_devices_and_never_falls_back():
    assert tmesh.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tmesh.local_devices("cuda")
        with pytest.raises(RuntimeError, match="no GPU"):
            BatchExecutor(mesh=tmesh.MeshConfig(enabled=True))
    # Without the tests' switch the CPU is one device: one placement.
    placements = tmesh.build_placements(tmesh.MeshConfig(enabled=True, num_devices=8), "cpu")
    assert [p.num_devices for p in placements] == [1]


def test_create_mesh_as_the_jax_package(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch)
    mesh = tparallel.create_mesh(device="cpu")
    reference = jparallel.create_mesh()
    assert mesh.axis_names == reference.axis_names == ("devices",)
    assert mesh.size == reference.devices.size == 8
    assert tparallel.create_mesh(4, device="cpu").size == jparallel.create_mesh(4).devices.size
    with pytest.raises(ValueError) as port_error:
        tparallel.create_mesh(1000, device="cpu")
    with pytest.raises(ValueError) as jax_error:
        jparallel.create_mesh(1000)
    assert str(port_error.value) == str(jax_error.value)


def test_shard_splits_the_study_axis_into_equal_chunks():
    placement = tmesh.DevicePlacement(0, [torch.device("cpu")] * 4)
    tree = dict(a=torch.arange(8.0), b=np.arange(16).reshape(8, 2), static=None)
    chunks = placement.shard(tree)
    assert len(chunks) == 4
    for k, chunk in enumerate(chunks):
        assert chunk["a"].tolist() == [2.0 * k, 2.0 * k + 1]
        assert isinstance(chunk["b"], np.ndarray) and chunk["b"].shape == (2, 2)
        assert chunk["static"] is None
    with pytest.raises(ValueError):
        placement.shard(dict(a=torch.arange(6.0)))
    # The placers of a mesh: equal chunks, and one copy per device.
    mesh = tparallel.Mesh((torch.device("cpu"),) * 2)
    assert [c.tolist() for c in tparallel.batch_sharded(mesh)(torch.arange(4))] == [[0, 1], [2, 3]]
    assert len(tparallel.replicated(mesh)(tree)) == 2


def test_replicate_moves_nothing_that_is_already_there():
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.optimizers import lbfgs

    model = gp_lib.VizierGaussianProcess(num_continuous=2, num_categorical=0, device="cpu")
    opt = lbfgs.LbfgsOptimizer(device="cpu")
    tree = (model, opt, {"x": torch.ones(2)})
    assert tparallel.replicate(tree, torch.device("cpu")) is tree
    assert tparallel.replicate(tree, None) is tree


def test_pool_generators_are_one_per_pool_and_reproducible(monkeypatch):
    torch_mesh_devices.patch_devices(monkeypatch, 4)
    mesh = tparallel.create_mesh(device="cpu")
    a = tparallel.pool_generators(7, 6, mesh)
    b = tparallel.pool_generators(7, 6, mesh)
    assert len(a) == 6
    assert [g.initial_seed() for g in a] == [g.initial_seed() for g in b]
    assert len({g.initial_seed() for g in a}) == 6
    source = torch.Generator().manual_seed(3)
    assert len(tparallel.pool_generators(source, 4, mesh)) == 4
