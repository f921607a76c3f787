"""The port's mesh plane against the JAX package's: ``MeshConfig``, the
placements' shard-granularity padding, the process-local carving and
``create_mesh``, on the JAX package's 8 virtual CPU devices and the port's
8 CPU entries (``torch_mesh_devices``)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices

from vizier_tpu import parallel as jparallel
from vizier_tpu.parallel import mesh as jmesh
from vizier_tpu_torch import parallel as tparallel
from vizier_tpu_torch.parallel import mesh as tmesh
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor


class _FakeDevice:
    def __init__(self, device_id, process_index):
        self.id = device_id
        self.process_index = process_index


def test_mesh_config_defaults_equal_the_jax_packages():
    assert dataclasses.asdict(tmesh.MeshConfig()) == dataclasses.asdict(jmesh.MeshConfig())


def test_mesh_config_from_env_reads_the_ports_switches(monkeypatch):
    assert tmesh.MeshConfig.from_env() == tmesh.MeshConfig()
    values = {"MESH": "1", "MESH_DEVICES": "4", "MESH_SHARD_DEVICES": "2"}
    for name, value in values.items():
        monkeypatch.setenv(f"VIZIER_{name}", value)
        monkeypatch.setenv(f"VIZIER_TORCH_{name}", value)
    port, reference = tmesh.MeshConfig.from_env(), jmesh.MeshConfig.from_env()
    assert (port.enabled, port.num_devices, port.shard_devices) == (True, 4, 2)
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


def test_a_coordinator_is_the_one_refusal_left():
    config = tmesh.MeshConfig(enabled=True, coordinator_address="localhost:1234",
                              num_processes=2, process_id=0)
    with pytest.raises(NotImplementedError, match="next slice"):
        tmesh.build_placements(config, "cpu")
    with pytest.raises(NotImplementedError, match="multi-host"):
        BatchExecutor(mesh=config, device="cpu")


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
