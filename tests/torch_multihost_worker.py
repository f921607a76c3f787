"""One process of a two-process mesh of the port, for the multi-host tests
and ``chip_smoke.py``'s multi-host part.

Run as ``python tests/torch_multihost_worker.py COORDINATOR PROCESS_ID OUT
DEVICE LOCAL STUDY``: the process joins a two-process ``gloo`` group through
``parallel.initialize_multihost``, prints the lines the JAX package's
two-process test prints (``RESULT ...``, ``PLACEMENTS ...``), the global
list's process indices and carve groups, whether an executor refuses a
placement that spans the processes, one batched flush of two studies on its
own placement (``FLUSH ...``), and how many gathers all that made after the
join (``GATHERS ...``, none: the join gathered the device counts). Then it
runs :func:`run` over the global mesh and saves its arrays to ``OUT.npz``
and its figures to ``OUT.json``.
``LOCAL`` > 0 patches ``local_devices`` to that many entries of ``DEVICE``
(the CPU tests' devices, ``torch_mesh_devices``); 0 keeps the real ones (one
card on the GPU). ``STUDY`` is ``tiny`` (12 trials of a 2-D quadratic) or
``bench`` (bench.py's 1000 × 20-D study, ``chip_smoke.py``'s, on the card).

:func:`run` is also what the tests and ``chip_smoke.py`` call in one process
over a mesh of as many entries, the run the two processes must equal.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vizier_tpu_torch import parallel
from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.optimizers import vectorized

POOLS = 4
POOL_SEED = 11
STEP_SEED = 3


def _data(device) -> gp_lib.GPData:
    """12 noisy trials of a 2-D quadratic, padded to 16 rows."""
    rng = np.random.default_rng(0)
    x = np.zeros((16, 2), np.float32)
    x[:12] = rng.uniform(size=(12, 2))
    y = np.zeros(16, np.float32)
    y[:12] = -np.sum((x[:12] - 0.5) ** 2, axis=1) + 0.05 * rng.normal(size=12)
    as_tensor = lambda a, dtype: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    return gp_lib.GPData(
        continuous=as_tensor(x, torch.float32),
        categorical=torch.zeros((16, 0), dtype=torch.int32, device=device),
        labels=as_tensor(y, torch.float32),
        row_mask=as_tensor(np.arange(16) < 12, torch.bool),
        cont_dim_mask=torch.ones(2, dtype=torch.bool, device=device),
        cat_dim_mask=torch.ones(0, dtype=torch.bool, device=device),
    )


def study(name: str, device) -> Tuple[Any, Any, gp_lib.GPData, Any, int, int]:
    """(model, ARD optimizer, data, sweep optimizer, restarts, count) of
    ``name``: ``tiny``, or ``bench`` (``chip_smoke.py``'s bench.py study and
    its mesh phase's 5 000-evaluation pools, with the designer's ARD)."""
    device = torch.device(device)
    if name == "tiny":
        model = gp_lib.VizierGaussianProcess(num_continuous=2, num_categorical=0, device=device)
        vec = vectorized.VectorizedOptimizer(
            vectorized.RandomVectorizedStrategy(num_continuous=2, num_categorical=0,
                                                category_sizes=(), suggestion_batch_size=20),
            max_evaluations=200, device=device)
        return model, lbfgs.AdamOptimizer(maxiter=20, device=device), _data(device), vec, 8, 2
    if name == "bench":
        import chip_smoke

        from vizier_tpu_torch import pyvizier as vz

        encoder, data, model, optimizer = chip_smoke._bench_gp(vz)
        vec = vectorized.VectorizedOptimizer(encoder._vec_opt.strategy,
                                             max_evaluations=chip_smoke._MESH_SWEEP_EVALS)
        return model, optimizer, data, vec, encoder.ard_restarts, chip_smoke._COUNT
    raise ValueError(f"Unknown study {name!r}.")


def _timed(device, fn) -> Tuple[Any, float]:
    start = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - start) * 1e3


def run(mesh: parallel.Mesh, device, name: str = "tiny") -> Tuple[Dict[str, np.ndarray], dict]:
    """Over ``mesh``: the sharded train from fixed inits (the restarts
    rounded up to the mesh), the pool sweep of its ensemble from per-pool
    seeds, and the whole step from one seed and the same inits. Returns
    their results as host arrays, and the figures: the restarts, each part's
    wall and the launch counts by mode (set to 0 before the train, read
    after the step)."""
    device = torch.device(device)
    model, optimizer, data, vec, restarts, count = study(name, device)
    restarts = -(-restarts // mesh.size) * mesh.size
    inits = model.param_collection().batch_random_init_unconstrained(
        torch.Generator(device=device).manual_seed(0), restarts)
    kernels.reset_launch_counts()
    state, train_ms = _timed(device, lambda: parallel.train_gp_sharded(
        model, optimizer, data, None, restarts, 1, mesh, inits=inits))
    scoring = acquisitions.ScoringFunction(
        predictive=gp_lib.EnsemblePredictive(state), acquisition=acquisitions.UCB(1.8),
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
        trust_region=acquisitions.TrustRegion.from_data(data))
    sweep, sweep_ms = _timed(device, lambda: parallel.maximize_acquisition_sharded(
        vec, scoring, parallel.pool_generators(POOL_SEED, POOLS, mesh), count, POOLS, mesh))
    step, step_ms = _timed(device, lambda: parallel.suggest_step_sharded(
        model, optimizer, vec, data, STEP_SEED, count=count, num_restarts=restarts,
        ensemble_size=1, mesh=mesh, inits=inits))
    launches = {k: dict(modes) for k, modes in kernels.LAUNCHES_BY_MODE.items()}
    nll = model.neg_log_likelihood(model.param_collection().unconstrain(state.params), data)
    out = {f"train_{k}": v for k, v in state.params.items()}
    out.update(nll=nll, sweep_continuous=sweep.features.continuous, sweep_scores=sweep.scores,
               step_continuous=step.features.continuous, step_scores=step.scores)
    figures = dict(restarts=restarts, train_ms=train_ms, sweep_ms=sweep_ms, step_ms=step_ms,
                   launches=launches)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}, figures


def _flush_on_own_placement(device) -> Tuple[str, dict]:
    """Two GP-UCB-PE studies through an executor over this process's
    placements: one batched flush on its own placement. Returns (the
    placement's label, the executor's stats)."""
    import threading

    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.algorithms import core as core_lib
    from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.parallel import mesh as mesh_lib
    from vizier_tpu_torch.serving.stats import ServingStats

    problem = vz.ProblemStatement()
    for d in range(2):
        problem.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    designers = []
    for seed in (1, 2):
        # use_mesh=False: with several local devices a designer would
        # otherwise take a mesh of its own and suggest unbatched.
        d = VizierGPUCBPEBandit(problem, rng_seed=seed, ard_restarts=2,
                                ard_optimizer=lbfgs.AdamOptimizer(maxiter=10, device=device),
                                max_acquisition_evaluations=200, device=device,
                                use_mesh=False)
        rng = np.random.default_rng(seed)
        trials = []
        for i in range(5):
            t = vz.Trial(parameters={"x0": float(rng.uniform()), "x1": float(rng.uniform())},
                         id=i + 1)
            t.complete(vz.Measurement(metrics={"obj": float(rng.uniform())}))
            trials.append(t)
        d.update(core_lib.CompletedTrials(trials))
        designers.append(d)
    stats = ServingStats()
    n_local = len(mesh_lib.local_devices(device))
    ex = batch_executor.BatchExecutor(
        max_batch_size=2, max_wait_ms=60_000, stats=stats, device=device,
        mesh=mesh_lib.MeshConfig(enabled=True, shard_devices=n_local))
    results = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, ex.suggest(designers[i], 1))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        (placement,) = ex.placements()
    finally:
        ex.close()
    for suggestions in results:
        assert suggestions and all(0.0 <= v <= 1.0 for s in suggestions
                                   for v in s.parameters.as_dict().values()), results
    return placement.label(), stats.snapshot()


def main(coordinator: str, process_id: int, out: str, device: str, local: int,
         name: str) -> None:
    import torch.distributed as dist

    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.parallel import mesh as mesh_lib

    if local:
        entries = [torch.device(device)] * local
        mesh_lib.local_devices = parallel.local_devices = lambda device="cuda": list(entries)
    elif device == "cuda":
        from vizier_tpu_torch.ops import native

        native.library()  # built by the process that spawned this one: loaded as it is
    start = time.perf_counter()
    mesh = parallel.initialize_multihost(
        coordinator_address=coordinator, num_processes=2, process_id=process_id, device=device)
    init_s = time.perf_counter() - start
    # Every gather after the join, counted and timed: building lists,
    # placements and executors must make none; the sharded helpers' gathers
    # are the run's traffic.
    gathers, real_gather = {"calls": 0, "ms": 0.0}, dist.all_gather_object

    def counted_gather(*args, **kwargs):
        gathers["calls"] += 1
        t0 = time.perf_counter()
        try:
            return real_gather(*args, **kwargs)
        finally:
            gathers["ms"] += (time.perf_counter() - t0) * 1e3

    dist.all_gather_object = counted_gather
    try:
        n_global, n_local = mesh.size, len(mesh_lib.local_devices(device))
        print(f"RESULT process_id={process_id} global={n_global} local={n_local} "
              f"procs={dist.get_world_size()}", flush=True)
        if process_id == 0:  # alone: a second join must not wait for the peer
            parallel.initialize_multihost(
                coordinator_address=coordinator, num_processes=2, process_id=0, device=device)
        devices = mesh_lib.multihost_mesh(mesh_lib.MeshConfig(), device)
        assert len(devices) == n_global, (len(devices), n_global)
        placements = mesh_lib.build_placements(
            mesh_lib.MeshConfig(enabled=True, shard_devices=n_local), device)
        assert len(placements) == 2, placements
        print(f"PLACEMENTS process_id={process_id} count={len(placements)}", flush=True)
        print("PROCESSES " + json.dumps([d.process_index for d in devices]), flush=True)
        print("GROUPS " + json.dumps({s: [[d.id for d in g] for g in
                                          mesh_lib._carve_device_groups(devices, s)]
                                      for s in range(1, n_global + 1)}), flush=True)
        try:
            batch_executor.BatchExecutor(
                mesh=mesh_lib.MeshConfig(enabled=True, shard_devices=n_global), device=device)
        except ValueError as e:
            print(f"REFUSED process_id={process_id} {e}", flush=True)
        label, snap = _flush_on_own_placement(device)
        print(f"FLUSH process_id={process_id} placement={label} "
              f"batched={snap['batched_suggests']} fallbacks={snap['batch_fallbacks']}",
              flush=True)
        print(f"GATHERS process_id={process_id} after_join={gathers['calls']}", flush=True)
        gathers["ms"] = 0.0
        arrays, figures = run(mesh, device, name)
    finally:
        dist.all_gather_object = real_gather
    figures.update(gather_ms=gathers["ms"], init_s=init_s)
    print(f"RAN process_id={process_id} " + json.dumps(figures), flush=True)
    np.savez(f"{out}.npz", **arrays)
    with open(f"{out}.json", "w") as f:
        json.dump(figures, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]), sys.argv[6])
