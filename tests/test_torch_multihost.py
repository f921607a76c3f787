"""The port's multi-host seam on the CPU, in real processes over ``gloo``.

Two processes of the port (``tests/torch_multihost_worker.py``), each with 2
patched CPU devices, join one group through ``parallel.initialize_multihost``
and print the lines the JAX package's two-process test
(``tests/parallel/test_multihost_explicit.py``) asserts. A JAX pair, spawned
as that test spawns its own (2 virtual devices per process), prints its global
list's process indices and carve groups, which the port's must equal. Then
the step the JAX package's CPU backend cannot run (that test's xfail): the
sharded train, the pool-sharded sweep and the whole step over the global mesh
of both processes, equal in both processes and float for float to the
port's one-process run over 4 patched devices; and a batched flush on each
process's own placement.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
import torch_mesh_devices
import torch_multihost_worker

from vizier_tpu import parallel as jparallel
from vizier_tpu.models import gp as jgp
from vizier_tpu.optimizers import lbfgs as jlbfgs
from vizier_tpu_torch import parallel as tparallel
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.optimizers import lbfgs as tlbfgs

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
# Each pair's own limit, inside the suite's: a pair that hangs fails here.
_TIMEOUT_S = 120

_JAX_WORKER = textwrap.dedent(
    """
    import json
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    coordinator, process_id = sys.argv[1], int(sys.argv[2])

    from vizier_tpu import parallel
    from vizier_tpu.parallel import mesh as mesh_lib

    mesh = parallel.initialize_multihost(
        coordinator_address=coordinator, num_processes=2, process_id=process_id)
    devices = list(jax.devices())
    n_global, n_local = len(mesh.devices.flat), len(jax.local_devices())
    print(f"RESULT process_id={process_id} global={n_global} local={n_local} "
          f"procs={jax.process_count()}", flush=True)
    placements = mesh_lib.build_placements(
        mesh_lib.MeshConfig(enabled=True, shard_devices=n_local))
    print(f"PLACEMENTS process_id={process_id} count={len(placements)}", flush=True)
    print("PROCESSES " + json.dumps([d.process_index for d in devices]), flush=True)
    position = {d.id: i for i, d in enumerate(devices)}
    print("GROUPS " + json.dumps({s: [[position[d.id] for d in g] for g in
                                      mesh_lib._carve_device_groups(devices, s)]
                                  for s in range(1, n_global + 1)}), flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args_for, env) -> list:
    coordinator = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen([sys.executable, *args_for(coordinator, i)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env) for i in range(2)]


def _communicate(procs) -> list:
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=_TIMEOUT_S)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outputs


def _line(out: str, prefix: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith(prefix)]
    assert lines, f"no {prefix!r} line in:\n{out}"
    return lines[0][len(prefix):]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Both pairs at once: the port's (its arrays saved per process) and the
    JAX package's. Returns (port outputs, port arrays, JAX outputs)."""
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_ROOT, _TESTS]), OMP_NUM_THREADS="1")
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_env.pop("JAX_PLATFORMS", None)  # the worker pins the CPU through jax.config
    script = tmp / "jax_worker.py"
    script.write_text(_JAX_WORKER)
    worker = os.path.join(_TESTS, "torch_multihost_worker.py")
    port = _spawn(lambda c, i: [worker, c, str(i), str(tmp / f"port{i}"), "cpu", "2", "tiny"],
                  env)
    reference = _spawn(lambda c, i: [str(script), c, str(i)], jax_env)
    port_out, jax_out = _communicate(port), _communicate(reference)
    arrays = [dict(np.load(tmp / f"port{i}.npz")) for i in range(2)]
    return port_out, arrays, jax_out


def test_each_process_sees_the_global_mesh_as_the_jax_test_asserts(pairs):
    port_out, _, jax_out = pairs
    for outputs in (port_out, jax_out):
        for i, out in enumerate(outputs):
            assert f"RESULT process_id={i} global=4 local=2 procs=2" in out, out
            assert f"PLACEMENTS process_id={i} count=2" in out, out


def test_process_indices_and_carve_groups_equal_the_jax_pairs(pairs):
    port_out, _, jax_out = pairs
    for prefix in ("PROCESSES ", "GROUPS "):
        port = [json.loads(_line(out, prefix)) for out in port_out]
        reference = [json.loads(_line(out, prefix)) for out in jax_out]
        assert port[0] == port[1] == reference[0] == reference[1], (prefix, port, reference)
    assert json.loads(_line(port_out[0], "PROCESSES ")) == [0, 0, 1, 1]


def test_an_executor_refuses_a_placement_across_the_processes(pairs):
    port_out, _, _ = pairs
    for i, out in enumerate(port_out):
        assert "spans processes" in _line(out, f"REFUSED process_id={i} "), out


def test_each_process_runs_a_batched_flush_on_its_own_placement(pairs):
    """Each process's executor keeps its own placement (2 ``ProcessDevice``
    entries) and serves two studies there in one batched flush, with no
    fallback to the studies alone."""
    port_out, _, _ = pairs
    for i, out in enumerate(port_out):
        assert f"FLUSH process_id={i} placement=mesh{i} batched=2 fallbacks=0" in out, out


def test_nothing_after_the_join_gathers_until_the_sharded_run(pairs):
    """The join gathers the device counts once: a second join (process 0
    alone), the global list, the placements and both executors gather
    nothing, so one process may build them without its peers."""
    port_out, _, _ = pairs
    for i, out in enumerate(port_out):
        assert f"GATHERS process_id={i} after_join=0" in out, out


def test_the_sharded_helpers_across_processes_equal_the_one_process_run(pairs, monkeypatch):
    """Train (fixed inits), pool sweep (per-pool seeds) and the whole step
    (one seed) over the two processes' global mesh: the same floats in both
    processes, and the floats of one process over 4 patched devices."""
    _, arrays, _ = pairs
    torch_mesh_devices.patch_devices(monkeypatch, 4)
    want, _ = torch_multihost_worker.run(tparallel.create_mesh(device="cpu"), "cpu")
    for got in arrays:
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert np.all(np.isfinite(want["step_scores"])) and want["step_continuous"].shape == (2, 2)


class TestMultihostInit:
    """``tests/parallel/test_sharding.py::TestMultihostInit`` on the port."""

    def test_single_host_returns_full_mesh(self, monkeypatch):
        torch_mesh_devices.patch_devices(monkeypatch)
        mesh = tparallel.initialize_multihost(device="cpu")
        reference = jparallel.initialize_multihost()
        assert mesh.size == len(reference.devices.flat) == len(jax.devices()) == 8
        assert all(isinstance(d, torch.device) for d in mesh.devices)
        # The sharded train accepts the returned mesh unchanged.
        data = torch_multihost_worker._data("cpu")
        model = tgp.VizierGaussianProcess(num_continuous=2, num_categorical=0, device="cpu")
        states = tparallel.train_gp_sharded(
            model, tlbfgs.AdamOptimizer(maxiter=5, device="cpu"), data,
            torch.Generator().manual_seed(0), num_restarts=8, ensemble_size=1, mesh=mesh)
        assert bool(torch.isfinite(states.chol).all())
        jstates = jparallel.train_gp_sharded(
            jgp.VizierGaussianProcess(num_continuous=2, num_categorical=0),
            jlbfgs.AdamOptimizer(maxiter=5), _jax_data(), jax.random.PRNGKey(0),
            num_restarts=8, ensemble_size=1, mesh=reference)
        assert np.isfinite(np.asarray(jstates.chol)).all()
        assert tuple(states.chol.shape) == tuple(jstates.chol.shape)


def _jax_data():
    """The worker's data as the JAX package's ``GPData``."""
    data = torch_multihost_worker._data("cpu")
    return jgp.GPData(**{name: jax.numpy.asarray(getattr(data, name).numpy())
                         for name in ("continuous", "categorical", "labels", "row_mask",
                                      "cont_dim_mask", "cat_dim_mask")})
