"""Drives the PyTorch/CUDA port on one GPU and checks it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. Prints the card (``nvidia-smi`` name and power limit) and builds the CUDA
   kernels from ``vizier_tpu_torch/csrc`` (timed, with ptxas' register report).
2. Holds K1 (``matern52_ard_fwd``) and K2 (``matern52_ard_bwd``) against their
   plain PyTorch versions on the card at the main path's shapes, a mixed
   masked shape and a >64-D shape; times each kernel, its plain version and
   the nearest PyTorch call.
3. Runs the main path through the designer entry points: a
   ``VizierGPUCBPEBandit`` on a 20-D float space takes bench.py's 1000
   synthetic completed trials and serves three ``suggest(count=5)`` requests,
   completing the five suggestions between requests. Launch counts are reset
   just before and read just after; both kernels must have run.
4. Checks the outputs: suggestions finite and in bounds, every trained
   Cholesky finite, and the trained posterior's predictions on the card
   against the port's plain CPU path at the same parameters.
5. Prints one ``{"kernels": [...]}`` line, the card line again, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no GPU is visible or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores. A card set below 700 W runs slower; its limit is printed.
_HBM_BYTES_PER_S = 3.35e12
_FP32_FLOPS = 67e12

# Tolerances of the kernel checks, as max |kernel - plain| over
# max |plain| of each output. Float32 sums in another order differ by a few
# ulps of the largest partial sum; the >64-D plain forward uses the
# ||a||^2 - 2ab + ||b||^2 expansion, whose float32 cancellation the kernel's
# exact differences do not have.
_FWD_TOL = 1e-5
_FWD_WIDE_TOL = 1e-3
_BWD_TOL = 1e-4
# Posterior mean/stddev (warped label units, ~N(0, 1)) on the card against
# the CPU at 1000 trained rows: both factor a float32 Gram whose noise
# variance is ~1e-4 of its diagonal, in different orders, and the condition
# number amplifies the rounding (5.7e-4 measured on an H100).
_PREDICT_TOL = 5e-3

# The main path's shapes at 1000 trials x 20-D (padded to 1024 rows): the
# ARD Gram over 4 restarts + the warm row, and the sweep's pool of 50.
_GRAM = "gram B=5 N=M=1024 Dc=20 Ds=0"
_CROSS = "cross B=1 N=50 M=1024 Dc=20"

_REPLACES = (
    "JAX package models/kernels.py:85 matern52_ard (an XLA fusion on the TPU; its Pallas "
    "kernel ops/matern_pallas.py was removed in d3abbcb)"
)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel_err(got, want) -> float:
    scale = float(torch.max(torch.abs(want))) if want.numel() else 1.0
    err = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    return err / max(scale, 1e-30), err


def _case(gen, b, n, m, dc, ds, *, same=False, masked=False, batched_x1=False):
    """Random kernel inputs on the card."""
    dev = "cuda"
    x1 = torch.rand((b, n, dc) if batched_x1 else (n, dc), generator=gen, device=dev)
    x2 = x1 if same else torch.rand((m, dc), generator=gen, device=dev)
    z1 = torch.randint(0, 3, (n, ds), generator=gen, device=dev, dtype=torch.int32)
    z2 = z1 if same else torch.randint(0, 3, (m, ds), generator=gen, device=dev, dtype=torch.int32)
    amp = 0.5 + torch.rand((b,), generator=gen, device=dev)
    inv = 1.0 / (0.3 + 1.7 * torch.rand((b, dc), generator=gen, device=dev))
    inv_sq = 1.0 / (0.3 + 1.7 * torch.rand((b, ds), generator=gen, device=dev)) ** 2
    if masked:
        inv[:, dc // 2:] = 0.0
        inv_sq[:, ds // 2:] = 0.0
    return x1, z1, x2, z2, amp, inv.contiguous(), inv_sq.contiguous()


def _bytes_fwd(args, out_elems) -> int:
    seen, total = set(), 0
    for t in args:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total + 4 * out_elems


def check_kernels(kernels):
    """Phase 2: K1/K2 against their plain versions; returns the timing rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        (_GRAM, dict(b=5, n=1024, m=1024, dc=20, ds=0, same=True)),
        (_CROSS, dict(b=1, n=50, m=1024, dc=20, ds=0)),
        ("mixed B=2 N=M=300 Dc=8 Ds=4 masked",
         dict(b=2, n=300, m=300, dc=8, ds=4, masked=True, batched_x1=True)),
        ("wide B=2 N=M=256 Dc=80", dict(b=2, n=256, m=256, dc=80, ds=0)),
    ]
    timing = {}
    for name, spec in cases:
        args = _case(gen, **spec)
        x1, z1, x2, z2, amp, inv, inv_sq = args
        got = kernels.matern52_ard_fwd_cuda(*args)
        want = kernels.matern52_ard_fwd_plain(*args)
        torch.cuda.synchronize()
        rel, err = _rel_err(got, want)
        tol = _FWD_WIDE_TOL if spec["dc"] > 64 else _FWD_TOL
        print(f"K1 {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        grad = torch.randn(got.shape, generator=gen, device="cuda")
        need_x = not spec.get("same", False)
        g_cuda = kernels.matern52_ard_bwd_cuda(grad, *args, need_x1=need_x, need_x2=need_x)
        g_plain = kernels.matern52_ard_bwd_plain(grad, *args)
        torch.cuda.synchronize()
        worst_rel = worst_abs = 0.0
        for label, a, b in zip(("amp", "inv_cont", "inv_sq_cat", "x1", "x2"), g_cuda, g_plain):
            if a is None or b.numel() == 0:
                continue
            r, e = _rel_err(a, b)
            worst_rel, worst_abs = max(worst_rel, r), max(worst_abs, e)
            print(f"K2 {name} d/{label}: max_abs_err={e:.3e} max_rel_err={r:.3e} (tol {_BWD_TOL})")
        if not worst_rel <= _BWD_TOL:
            raise AssertionError(f"K2 disagrees with its plain version at {name}")
        if name in (_GRAM, _CROSS):
            timing[name] = _time_case(kernels, args, grad, err, worst_abs)
    return timing


def _time_case(kernels, args, grad, fwd_err, bwd_err):
    x1, z1, x2, z2, amp, inv, inv_sq = args
    b, n, m, dc, ds = amp.shape[0], x1.shape[-2], x2.shape[-2], inv.shape[1], inv_sq.shape[1]
    elems = b * n * m

    def library():
        # Nearest PyTorch calls: cdist of the scaled points + elementwise Matern.
        d = torch.cdist(x1[None] * inv[:, None, :], x2[None] * inv[:, None, :])
        return (amp * amp)[:, None, None] * kernels.matern52(d * d)

    fwd_ms = _time_ms(lambda: kernels.matern52_ard_fwd_cuda(*args))
    fwd_plain_ms = _time_ms(lambda: kernels.matern52_ard_fwd_plain(*args), reps=5)
    lib_ms = _time_ms(library)
    bwd_ms = _time_ms(lambda: kernels.matern52_ard_bwd_cuda(grad, *args))
    bwd_plain_ms = _time_ms(lambda: kernels.matern52_ard_bwd_plain(grad, *args), reps=5)
    # Operations the function needs, not what the kernels happen to do: the
    # rows are scaled by the inverse length scales once (one multiply per
    # row and dim); then each (pair, dim) is a subtract and an FMA forward,
    # and a subtract, a square, an add and an FMA backward; each categorical
    # dim is a compare and a select-add (x2 backward); the Matern and the
    # amplitude cost ~10 per pair forward, ~15 backward.
    rows = b * (x1.shape[-2] + (0 if x2 is x1 else x2.shape[-2]))
    prescale = rows * dc
    fwd_bytes = _bytes_fwd(args, elems)
    fwd_ops = elems * (3 * dc + 2 * ds + 10) + prescale
    bwd_bytes = _bytes_fwd(args + (grad,), b * (1 + dc + ds))
    bwd_ops = elems * (5 * dc + 4 * ds + 15) + prescale
    return {
        "fwd": (fwd_ms, fwd_plain_ms, lib_ms, fwd_bytes, fwd_ops, fwd_err),
        "bwd": (bwd_ms, bwd_plain_ms, None, bwd_bytes, bwd_ops, bwd_err),
    }


def _bound(nbytes: int, ops: int):
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = ops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bench_trials(vz, num_trials: int, dim: int):
    """bench.py's synthetic study: uniform x, y = -|x - 0.5|^2 + 0.1 noise."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(num_trials, dim)).astype(np.float32)
    y_raw = -np.sum((x - 0.5) ** 2, axis=1) + 0.1 * rng.normal(size=num_trials)
    trials = []
    for i in range(num_trials):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[i, j]) for j in range(dim)})
        t.complete(vz.Measurement(metrics={"obj": float(y_raw[i])}))
        trials.append(t)
    return trials


def run_main_path(vz, gp_ucb_pe, kernels, gp_lib):
    """Phase 3 + 4: three suggest(count=5) requests at 1000 trials x 20-D."""
    dim, num_trials, count = 20, 1000, 5
    problem = vz.ProblemStatement()
    for j in range(dim):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    trials = _bench_trials(vz, num_trials, dim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    designer = gp_ucb_pe.VizierGPUCBPEBandit(problem, rng_seed=0)
    designer.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    latencies, next_id, states = [], num_trials + 1, []
    for request in range(3):
        start = time.perf_counter()
        suggestions = designer.suggest(count=count)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - start)
        state = designer._cached_states[0]
        states.append(state)
        if len(suggestions) != count:
            raise AssertionError(f"request {request}: {len(suggestions)} suggestions")
        if not bool(torch.isfinite(state.chol).all()):
            raise AssertionError(f"request {request}: non-finite Cholesky factor")
        completed = []
        for s in suggestions:
            values = np.array([s.parameters.get_value(f"x{j}") for j in range(dim)], float)
            if not (np.all(np.isfinite(values)) and np.all((values >= 0.0) & (values <= 1.0))):
                raise AssertionError(f"request {request}: suggestion out of bounds {values}")
            t = s.to_trial(next_id)
            next_id += 1
            t.complete(vz.Measurement(metrics={"obj": float(-np.sum((values - 0.5) ** 2))}))
            completed.append(t)
        print(f"request {request}: suggest(count={count}) {latencies[-1] * 1e3:.1f} ms, "
              f"first acquisition {suggestions[0].metadata.ns('gp_ucb_pe')['acquisition']}")
        designer.update(vz.CompletedTrials(completed), vz.ActiveTrials())
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: latencies_ms={[round(t * 1e3, 1) for t in latencies]} "
          f"peak_memory_bytes={peak} launches={launches}")
    for name, count_ in launches.items():
        if count_ <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    _check_against_cpu(states[-1], kernels, gp_lib)
    return designer, launches


def _check_against_cpu(state, kernels, gp_lib):
    """The trained posterior on the card against the port's plain CPU path."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    query = torch.rand((64, state.data.continuous.shape[1]), generator=gen, device="cuda")
    feats = kernels.MixedFeatures(query, torch.zeros((64, 0), dtype=torch.int32, device="cuda"))
    mean, std = gp_lib.EnsemblePredictive(state).predict(feats)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    data = gp_lib.GPData(**{f: cpu(getattr(state.data, f)) for f in (
        "continuous", "categorical", "labels", "row_mask", "cont_dim_mask", "cat_dim_mask")})
    params = {k: cpu(v) for k, v in state.params.items()}
    cpu_model = dataclasses.replace(state.model, device="cpu")
    cpu_state = cpu_model.precompute_constrained(params, data)
    mean_c, std_c = gp_lib.EnsemblePredictive(cpu_state).predict(
        kernels.MixedFeatures(cpu(query), cpu(feats.categorical)))
    err_mean = float(torch.max(torch.abs(cpu(mean) - mean_c)))
    err_std = float(torch.max(torch.abs(cpu(std) - std_c)))
    print(f"predict on the card vs CPU plain path: max_abs_err mean={err_mean:.3e} "
          f"stddev={err_std:.3e} (tol {_PREDICT_TOL})")
    if not (max(err_mean, err_std) <= _PREDICT_TOL and math.isfinite(err_mean + err_std)):
        raise AssertionError("predict on the card disagrees with the CPU plain path")


def _is_cuda_kernel(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _device_us(evt) -> float:
    value = getattr(evt, "self_device_time_total", None)
    return float(value if value is not None else evt.self_cuda_time_total)


def profile_request(designer, count: int = 5):
    """One more request after the main path, split into ARD training and the
    rest (pick loop, sweeps, decode), under torch.profiler: device busy time
    by kernel and the device's idle share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: recording every host op too multiplies the
    # trace's size and its post-processing time.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        designer._train_states()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        designer.suggest(count=count)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    kernels = [e for e in prof.key_averages() if _is_cuda_kernel(e) and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    print(f"profiled request: wall {wall_s * 1e3:.1f} ms = ARD train {train_s * 1e3:.1f} ms "
          f"+ picks/sweeps/decode {(wall_s - train_s) * 1e3:.1f} ms (profiler on)")
    print(f"profiled request: device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall_s:.3f}, {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  {_device_us(e) / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vizier_tpu_torch import device as device_lib
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.designers import gp_ucb_pe
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import kernels
    from vizier_tpu_torch.ops import native

    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device_lib.resolve("cuda")
    lib = native.library()
    print(f"kernel build: {lib.build_seconds:.1f} s")
    print(lib.build_log.strip())

    start = time.perf_counter()
    timing = check_kernels(kernels)
    print(f"[{time.perf_counter() - start:.1f} s] kernel checks done")
    designer, launches = run_main_path(vz, gp_ucb_pe, kernels, gp_lib)
    print(f"[{time.perf_counter() - start:.1f} s] main path done")
    profile_request(designer)
    print(f"[{time.perf_counter() - start:.1f} s] profiled request done")

    # One JSON row per kernel, at the shape that carries most of its
    # main-path launches: K1 at the sweep's cross shape, K2 at the ARD Gram.
    headline = {"fwd": _CROSS, "bwd": _GRAM}
    rows = []
    for key, name in (("fwd", "matern52_ard_fwd"), ("bwd", "matern52_ard_bwd")):
        for shape, t in timing.items():
            ms, plain_ms, lib_ms, nbytes, ops, err = t[key]
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"{name} [{shape}]: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
                  f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {bound_ms:.4f} ms "
                  f"by {bound_by})")
            if shape == headline[key]:
                rows.append({
                    "name": name, "route": "cuda", "source": "vizier_tpu_torch/csrc/matern52.cu",
                    "replaces": _REPLACES, "launches": launches[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "shape": shape,
                })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
