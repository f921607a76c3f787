"""Batching A/B: suggestion throughput with the cross-study batch executor
on vs off, K concurrent same-bucket studies.

Usage: python -m vizier_tpu_torch.tools.batching_ab [--studies 8] [--rounds 6]
       [--device cuda|cpu] [--out FILE]
       python -m vizier_tpu_torch.tools.batching_ab --devices 8 [--buckets 8]
       [--studies-per-bucket 2] [--device cpu] [--out FILE]

The port's counterpart of the JAX package's ``tools/batching_ab.py``, with
its flags, report keys and public functions. The report is printed as one
JSON line, and written to ``--out`` when given (there is no default file).

Both arms run the SAME workload: K studies with identical search-space
shapes (thus one padding bucket), each driven by its own client thread
running ``suggest(1)`` -> complete cycles back to back, so the next suggest
trains on fresh data (the steady serving shape). Per-study designers and
budgets are identical across arms; only the dispatch differs:

- **batching_on**: suggests route through ``parallel.BatchExecutor``:
  same-bucket computations coalesce into one batched device program per
  flush (occupancy ~K);
- **batching_off**: every suggest runs its study's own ``designer.suggest``
  on its client thread, the same threads.

The report gives per-suggest latency p50/p95/p99, suggestions/s, mean batch
occupancy and the speedup. Acceptance: >= 2x throughput at 8 concurrent
same-bucket studies.

**Mesh arm** (``--devices N``): ``--buckets B`` study groups with distinct
shape buckets (distinct acquisition budgets), ``--studies-per-bucket`` each,
all driven at once through one ``BatchExecutor``, without the mesh
(``single_device``) and with ``MeshConfig(enabled=True, num_devices=N,
shard_devices=...)`` (``mesh``), plus the ``VIZIER_TORCH_MESH=0``
bit-identity check against the executor without the mesh. The devices are the
process's real ones (``parallel.mesh.local_devices``; a count above them is
capped), so one card is one placement: the arm means something with several
cards, or on the CPU with ``local_devices`` replaced, as the port's tests do.

The designers run unsharded (``use_mesh=False``), as the JAX tool's
``VIZIER_DISABLE_MESH=1`` default makes them. ``config.backend`` names the
device (``cpu``, or ``cuda:`` and the card); ``config.xla_flags`` is empty:
the port has no XLA flags.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.compute import registry as compute_registry
from vizier_tpu_torch.converters import padding as padding_lib
from vizier_tpu_torch.designers import gp_ucb_pe
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.parallel.mesh import MeshConfig
from vizier_tpu_torch.serving.stats import ServingStats
from vizier_tpu_torch.tools.warm_start_ab import backend, write_report


def _progress(msg: str) -> None:
    print(f"[batching_ab] {msg}", file=sys.stderr, flush=True)


def _problem(dim: int) -> vz.ProblemStatement:
    p = vz.ProblemStatement()
    for d in range(dim):
        p.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    p.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    return p


def _sphere(parameters: dict) -> float:
    return -sum((v - 0.3) ** 2 for v in parameters.values())


class _Study:
    """One study: a designer plus its completed-trial frontier."""

    def __init__(self, problem, seed, designer_kwargs, device):
        self.designer = gp_ucb_pe.VizierGPUCBPEBandit(
            problem, rng_seed=seed, use_mesh=False, device=device, **designer_kwargs
        )
        self.next_id = 1
        self.seed = seed

    def feed(self, n: int) -> None:
        rng = np.random.default_rng(self.seed * 1000 + self.next_id)
        trials = []
        for _ in range(n):
            params = {
                f"x{d}": float(rng.uniform())
                for d in range(len(self.designer.problem.search_space.parameters))
            }
            t = vz.Trial(parameters=params, id=self.next_id)
            t.complete(vz.Measurement(metrics={"obj": _sphere(params)}))
            trials.append(t)
            self.next_id += 1
        self.designer.update(core_lib.CompletedTrials(trials))

    def complete_suggestion(self, suggestion) -> None:
        params = dict(suggestion.parameters.as_dict())
        t = vz.Trial(parameters=params, id=self.next_id)
        t.complete(vz.Measurement(metrics={"obj": _sphere(params)}))
        self.next_id += 1
        self.designer.update(core_lib.CompletedTrials([t]))


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    rank = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _drive(pool, suggest, warmup_rounds: int, rounds: int, at_start=None):
    """One client thread per study, each running ``suggest`` -> complete
    cycles back to back with no round barrier; the measurement starts when
    every thread has ended its warmup rounds. Returns (the measured rounds'
    sorted latencies, their wall, ``at_start()`` taken as they start)."""
    latencies: list = []
    errors: list = []
    lat_lock = threading.Lock()
    barrier = threading.Barrier(len(pool) + 1)

    def one_suggest(st: _Study, record: bool):
        t0 = time.perf_counter()
        out = suggest(st)
        dt = time.perf_counter() - t0
        if record:
            with lat_lock:
                latencies.append(dt)
        return out

    def client(st: _Study):
        try:
            for _ in range(warmup_rounds):
                st.complete_suggestion(one_suggest(st, record=False)[0])
            barrier.wait()  # first uses paid; measurement starts together
            for _ in range(rounds):
                st.complete_suggestion(one_suggest(st, record=True)[0])
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(st,)) for st in pool]
    for t in threads:
        t.start()
    try:
        barrier.wait()
    except threading.BrokenBarrierError:
        pass  # a client failed in its warmup: its error is raised below
    started = at_start() if at_start is not None else None
    t_start = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    latencies.sort()
    return latencies, wall, started


def _latency_keys(latencies) -> dict:
    return {
        "suggest_p50_ms": round(_percentile(latencies, 50) * 1e3, 1),
        "suggest_p95_ms": round(_percentile(latencies, 95) * 1e3, 1),
        "suggest_p99_ms": round(_percentile(latencies, 99) * 1e3, 1),
    }


def _run_arm(
    *,
    batching: bool,
    studies: int,
    rounds: int,
    warmup_rounds: int,
    start_trials: int,
    problem,
    designer_kwargs,
    max_wait_ms: float,
    device,
) -> dict:
    pool = [_Study(problem, s + 1, designer_kwargs, device) for s in range(studies)]
    for st in pool:
        st.feed(start_trials)
    stats = ServingStats()
    executor = (
        BatchExecutor(
            max_batch_size=studies,
            max_wait_ms=max_wait_ms,
            stats=stats,
            metrics=stats.registry,
            device=device,
        )
        if batching
        else None
    )
    if executor is not None:
        suggest = lambda st: executor.suggest(st.designer, 1)  # noqa: E731
    else:
        suggest = lambda st: st.designer.suggest(1)  # noqa: E731
    try:
        latencies, wall, _ = _drive(pool, suggest, warmup_rounds, rounds)
    finally:
        if executor is not None:
            executor.close()

    snap = stats.snapshot()
    total = studies * rounds
    occupancy = (
        snap["batched_suggests"] / snap["batch_flushes"]
        if snap.get("batch_flushes")
        else 1.0
    )
    return {
        "batching": batching,
        **_latency_keys(latencies),
        "throughput_suggestions_per_sec": round(total / wall, 3),
        "wall_secs": round(wall, 2),
        "suggestions": total,
        "mean_batch_occupancy": round(occupancy, 2),
        "batch_stats": {k: v for k, v in snap.items() if k.startswith("batch")},
    }


def _make_pool(problem, buckets, studies_per_bucket, designer_kwargs_for, device):
    """One study pool: ``buckets`` groups with distinct shape buckets."""
    return [
        _Study(problem, b * 100 + c + 1, designer_kwargs_for(b), device)
        for b in range(buckets)
        for c in range(studies_per_bucket)
    ]


def _distinct_buckets(problem, buckets, designer_kwargs_for, start_trials, device) -> int:
    """How many distinct bucket keys the per-group acquisition budgets give."""
    keys = set()
    for b in range(buckets):
        st = _Study(problem, b + 1, designer_kwargs_for(b), device)
        st.feed(start_trials)
        resolved = compute_registry.resolve(st.designer, 1)
        if resolved is None:
            raise RuntimeError(f"bucket group {b} is unbatchable")
        keys.add(resolved[1])
    return len(keys)


def _run_mesh_arm(
    *,
    mesh,  # MeshConfig | None (None = the executor without the mesh)
    buckets: int,
    studies_per_bucket: int,
    rounds: int,
    warmup_rounds: int,
    start_trials: int,
    problem,
    designer_kwargs_for,
    max_wait_ms: float,
    max_batch_size: int,
    device,
) -> dict:
    pool = _make_pool(problem, buckets, studies_per_bucket, designer_kwargs_for, device)
    for st in pool:
        st.feed(start_trials)
    stats = ServingStats()
    executor = BatchExecutor(
        max_batch_size=max_batch_size,
        max_wait_ms=max_wait_ms,
        stats=stats,
        metrics=stats.registry,
        mesh=mesh,
        device=device,
    )
    try:
        latencies, wall, warm_snapshot = _drive(
            pool, lambda st: executor.suggest(st.designer, 1), warmup_rounds, rounds,
            at_start=stats.snapshot)
        placement_flushes = executor.placement_flush_counts()
        bucket_placements = executor.bucket_placements()
    finally:
        executor.close()

    snap = stats.snapshot()
    measured = {
        k: snap.get(k, 0) - warm_snapshot.get(k, 0)
        for k in ("batch_flushes", "batched_suggests", "mesh_flushes")
    }
    total = len(pool) * rounds
    occupancy = (
        measured["batched_suggests"] / measured["batch_flushes"]
        if measured["batch_flushes"]
        else 1.0
    )
    return {
        "mesh": bool(mesh is not None and mesh.enabled),
        **_latency_keys(latencies),
        "throughput_suggestions_per_sec": round(total / wall, 3),
        "flush_throughput_per_sec": round(measured["batch_flushes"] / wall, 3)
        if measured["batch_flushes"]
        else 0.0,
        "wall_secs": round(wall, 2),
        "suggestions": total,
        "measured_flushes": measured["batch_flushes"],
        "mean_batch_occupancy": round(occupancy, 2),
        "placement_flushes": placement_flushes,
        "bucket_placements": bucket_placements,
        "batch_stats": {k: v for k, v in snap.items() if k.startswith(("batch", "mesh"))},
    }


def _mesh_off_bit_identity(problem, designer_kwargs, device) -> bool:
    """``VIZIER_TORCH_MESH=0`` (``MeshConfig.from_env`` with the switch unset)
    must route through the executor without the mesh: the same concurrent
    workload, slot-for-slot equal suggestions."""

    def run(mesh):
        pool = [_Study(problem, s + 1, designer_kwargs, device) for s in range(3)]
        for st in pool:
            st.feed(9)
        executor = BatchExecutor(max_batch_size=8, max_wait_ms=30.0, mesh=mesh, device=device)
        outs = [None] * len(pool)

        def one(i):
            outs[i] = executor.suggest(pool[i].designer, 1)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(pool))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            executor.close()
        return [s.parameters.as_dict() for out in outs for s in out]

    return run(None) == run(MeshConfig.from_env())


def _check_one_bucket(args) -> None:
    """A bucket boundary inside the measured rounds would time a new layout's
    first use instead of steady-state serving."""
    schedule = padding_lib.DEFAULT_PADDING
    end_trials = args.start_trials + args.warmup_rounds + args.rounds
    if schedule.pad_trials(args.start_trials) != schedule.pad_trials(end_trials):
        raise SystemExit(
            f"start_trials={args.start_trials} grows to {end_trials} across a "
            f"padding-bucket boundary ({schedule.pad_trials(args.start_trials)}"
            f" -> {schedule.pad_trials(end_trials)}); shrink --rounds or move "
            "--start-trials so the whole run stays in one bucket."
        )


def _ard(args, device) -> lbfgs_lib.AdamOptimizer:
    return lbfgs_lib.AdamOptimizer(maxiter=args.ard_maxiter, device=device)


def run_mesh_ab(args) -> dict:
    """The mesh arm's report (``--devices N``)."""
    device = device_lib.resolve(args.device)
    problem = _problem(args.dim)
    _check_one_bucket(args)

    def designer_kwargs_for(bucket_index: int) -> dict:
        # Distinct acquisition budgets -> distinct bucket keys with
        # near-identical per-slot cost (the budget delta is < 1%).
        return dict(
            max_acquisition_evaluations=args.max_evals + 8 * bucket_index,
            ard_restarts=args.ard_restarts,
            ard_optimizer=_ard(args, device),
        )

    distinct = _distinct_buckets(
        problem, args.buckets, designer_kwargs_for, args.start_trials, device)
    if distinct != args.buckets:
        raise RuntimeError(f"{distinct} distinct buckets, expected {args.buckets}")
    mesh_config = MeshConfig(
        enabled=True, num_devices=args.devices, shard_devices=args.shard_devices)
    config = dict(
        devices=args.devices,
        shard_devices=args.shard_devices,
        buckets=args.buckets,
        studies_per_bucket=args.studies_per_bucket,
        rounds=args.rounds,
        warmup_rounds=args.warmup_rounds,
        start_trials=args.start_trials,
        dim=args.dim,
        designer="VizierGPUCBPEBandit",
        max_acquisition_evaluations=args.max_evals,
        ard_maxiter=args.ard_maxiter,
        ard_restarts=args.ard_restarts,
        max_wait_ms=args.max_wait_ms,
        max_batch_size=8,
        backend=backend(device),
        xla_flags="",
    )

    arms = {}
    for name, mesh in (("single_device", None), ("mesh", mesh_config)):
        _progress(f"running mesh arm: {name}")
        arms[name] = _run_mesh_arm(
            mesh=mesh,
            buckets=args.buckets,
            studies_per_bucket=args.studies_per_bucket,
            rounds=args.rounds,
            warmup_rounds=args.warmup_rounds,
            start_trials=args.start_trials,
            problem=problem,
            designer_kwargs_for=designer_kwargs_for,
            max_wait_ms=args.max_wait_ms,
            max_batch_size=8,
            device=device,
        )

    _progress("checking VIZIER_TORCH_MESH=0 bit-identity")
    bit_identical = _mesh_off_bit_identity(problem, designer_kwargs_for(0), device)

    on, off = arms["mesh"], arms["single_device"]
    flush_speedup = on["flush_throughput_per_sec"] / max(off["flush_throughput_per_sec"], 1e-9)
    speedup = on["throughput_suggestions_per_sec"] / max(
        off["throughput_suggestions_per_sec"], 1e-9)
    return {
        "config": config,
        "single_device": off,
        "mesh": on,
        "verdict": {
            "flush_throughput_speedup": round(flush_speedup, 2),
            "throughput_speedup": round(speedup, 2),
            "meets_2x_at_8_devices": bool(
                flush_speedup >= 2.0 and args.devices >= 8 and args.buckets >= 8),
            "concurrent_buckets": args.buckets,
            "mesh_off_bit_identical": bool(bit_identical),
        },
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def run_batching_ab(args) -> dict:
    """The classic arm's report: batching on against off at ``--studies``."""
    device = device_lib.resolve(args.device)
    problem = _problem(args.dim)
    _check_one_bucket(args)
    designer_kwargs = dict(
        max_acquisition_evaluations=args.max_evals,
        ard_restarts=args.ard_restarts,
        ard_optimizer=_ard(args, device),
    )
    config = dict(
        studies=args.studies,
        rounds=args.rounds,
        warmup_rounds=args.warmup_rounds,
        start_trials=args.start_trials,
        dim=args.dim,
        designer="VizierGPUCBPEBandit",
        max_acquisition_evaluations=args.max_evals,
        ard_maxiter=args.ard_maxiter,
        ard_restarts=args.ard_restarts,
        max_wait_ms=args.max_wait_ms,
        backend=backend(device),
    )

    arms = {}
    for name, batching in (("batching_off", False), ("batching_on", True)):
        _progress(f"running arm: {name}")
        arms[name] = _run_arm(
            batching=batching,
            studies=args.studies,
            rounds=args.rounds,
            warmup_rounds=args.warmup_rounds,
            start_trials=args.start_trials,
            problem=problem,
            designer_kwargs=designer_kwargs,
            max_wait_ms=args.max_wait_ms,
            device=device,
        )

    on, off = arms["batching_on"], arms["batching_off"]
    speedup = on["throughput_suggestions_per_sec"] / max(
        off["throughput_suggestions_per_sec"], 1e-9)
    return {
        "config": config,
        "batching_off": off,
        "batching_on": on,
        "verdict": {
            "throughput_speedup": round(speedup, 2),
            "meets_2x_at_8_studies": bool(speedup >= 2.0 and args.studies >= 8),
            "mean_batch_occupancy": on["mean_batch_occupancy"],
        },
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def run(args) -> dict:
    """The mesh arm's report with ``--devices``, else the classic arm's."""
    return run_mesh_ab(args) if args.devices else run_batching_ab(args)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--warmup-rounds", type=int, default=1)
    # 9 completed trials land in the 16-row bucket; one warmup plus six
    # measured rounds grow each study to 16, so the run stays in one bucket.
    ap.add_argument("--start-trials", type=int, default=9)
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--max-evals", type=int, default=2000)
    ap.add_argument("--ard-maxiter", type=int, default=30)
    ap.add_argument("--ard-restarts", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh A/B over N devices; 0 = classic batching A/B")
    ap.add_argument("--buckets", type=int, default=8)
    ap.add_argument("--studies-per-bucket", type=int, default=2)
    ap.add_argument("--shard-devices", type=int, default=1,
                    help="devices per placement in the mesh arm")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    write_report(run(args), args.out)


if __name__ == "__main__":
    main()
