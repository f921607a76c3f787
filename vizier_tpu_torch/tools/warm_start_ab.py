"""A/B: warm-started vs cold-started ARD for steady-state serving.

Usage: python -m vizier_tpu_torch.tools.warm_start_ab [--out FILE]
       [--trials 1000] [--dim 20] [--evals 75000] [--repeats 5]
       [--parity-trials 45] [--parity-seeds 1 2 3 4 5] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/warm_start_ab.py``, with
its flags and report keys. Two measurements, one JSON report, printed as
one line (and written to ``--out`` when given; there is no default file):

1. **Device-side steady-state suggest latency** at the north-star config
   (1000 trials x 20-D): per repeat, one fresh completed trial replaces a
   row (what a steady-state serving step sees), then the measured step is
   ARD train (``designers/gp_bandit.py`` ``_train_gp``) + one full
   acquisition sweep (one study's ``_sweep_studies``: UCB(1.8), the trust
   region, the eagle pool seeded at the study's best points), ending in
   ``torch.cuda.synchronize()``.
   - cold arm: ``DEFAULT_RANDOM_RESTARTS`` L-BFGS restarts from random
     inits, the reference's per-request behaviour;
   - warm arm: ONE restart seeded with the previous repeat's trained
     unconstrained optimum (the serving runtime's steady state,
     ``ServingConfig.warm_ard_restarts=1``).
   Step 0 (the first use of the shapes: kernel build, handles, graph
   captures, and the warm arm's mandatory cold train) is excluded. The
   steps draw from torch generators seeded 2·step (train) and 2·step + 1
   (sweep), where the JAX tool splits ``PRNGKey(step)``.

2. **Regret parity**: full BO loops of the DEFAULT on shifted 20-D Sphere
   instances, warm (1 warm restart) vs cold (full budget), >= 5 seeds,
   two-sided rank-sum on final regrets. Parity is green when p > 0.05.

``backend`` names the device: ``cpu``, or ``cuda:`` and the card's name and
power limit as ``nvidia-smi`` prints them (its name alone where
``nvidia-smi`` does not answer).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import types
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks import regret
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import output_warpers
from vizier_tpu_torch.optimizers import eagle as eagle_lib
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.surrogates import sparse_gp


def _progress(msg: str) -> None:
    print(f"[warm_start_ab] {msg}", file=sys.stderr, flush=True)


def backend(device) -> str:
    """The report's ``backend``: the device type, and on CUDA the card."""
    device = device_lib.resolve(device)
    if device.type != "cuda":
        return device.type
    try:
        return f"cuda: {regret.card_line()}"
    except (OSError, subprocess.SubprocessError):
        return f"cuda: {torch.cuda.get_device_name(device)}"


def steady_state_data(num_trials: int, dim: int, step: int, device) -> gp_lib.GPData:
    """The latency arms' study at a steady-state ``step``: bench.py's data
    (seed 0) with one row replaced by a fresh observation per step, so the
    padded shapes stay the same."""
    n_pad = 1 << (num_trials - 1).bit_length()
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(num_trials, dim)).astype(np.float32)
    ys = -np.sum((xs - 0.5) ** 2, axis=1) + 0.1 * rng.normal(size=num_trials)
    if step > 0:
        row = (step * 37) % num_trials
        r = np.random.default_rng(1000 + step)
        xs[row] = r.uniform(size=dim).astype(np.float32)
        ys[row] = -np.sum((xs[row] - 0.5) ** 2) + 0.1 * r.normal()
    warped = output_warpers.create_default_warper()(ys)
    features = types.ContinuousAndCategorical(
        continuous=types.PaddedArray.from_array(xs, (n_pad, dim)),
        categorical=types.PaddedArray.from_array(
            np.zeros((num_trials, 0), np.int32), (n_pad, 0), fill_value=0
        ),
    )
    labels = types.PaddedArray.from_array(
        warped[:, None].astype(np.float32), (n_pad, 1), fill_value=np.nan
    )
    return gp_lib.GPData.from_model_data(types.ModelData(features, labels), device)


def step_generators(device, step: int):
    """(train, sweep) generators of a latency step."""
    return (gp_bandit._generator(device, 2 * step),
            gp_bandit._generator(device, 2 * step + 1))


def sweep(vec_opt, states, data: gp_lib.GPData, generator, count: int):
    """One study's UCB(1.8) sweep with the trust region over ``states``
    (exact or sparse), as a study axis of one."""
    one = lambda tree: batch_executor.stack_pytrees([tree])  # noqa: E731
    if isinstance(states, sparse_gp.SparseGPState):
        states = dataclasses.replace(states, sdata=one(states.sdata))
    else:
        states = dataclasses.replace(states, data=one(states.data))
    return gp_bandit._sweep_studies(
        vec_opt, acquisitions.UCB(1.8), states, one(data), [generator], count, True)


def measure_latency(args) -> dict:
    device = device_lib.resolve(args.device)
    num_trials, dim = args.trials, args.dim
    model = gp_lib.VizierGaussianProcess(num_continuous=dim, num_categorical=0, device=device)
    ard = lbfgs_lib.LbfgsOptimizer(maxiter=50, device=device)
    strategy = eagle_lib.VectorizedEagleStrategy(num_continuous=dim, category_sizes=())
    vec_opt = vectorized_lib.VectorizedOptimizer(
        strategy, max_evaluations=args.evals, device=device
    )
    coll = model.param_collection()
    cold_restarts = lbfgs_lib.DEFAULT_RANDOM_RESTARTS
    datas = [steady_state_data(num_trials, dim, i, device) for i in range(args.repeats + 1)]

    def run_arm(warm: bool):
        times = []
        prev_params = None
        for step, data in enumerate(datas):
            g_train, g_acq = step_generators(device, step)
            t0 = time.perf_counter()
            if warm and prev_params is not None:
                states = gp_bandit._train_gp(model, ard, data, g_train, 1, 1, prev_params)
            else:
                states = gp_bandit._train_gp(model, ard, data, g_train, cold_restarts, 1)
            sweep(vec_opt, states, data, g_acq, args.batch)
            gp_bandit._synchronize(device)
            elapsed = (time.perf_counter() - t0) * 1000.0
            if warm:
                prev_params = coll.unconstrain({k: v[0] for k, v in states.params.items()})
                if step == 0:
                    # The first 1-restart warm train outside the timed steps,
                    # so the first TIMED step measures compute, not first use.
                    gp_bandit._train_gp(model, ard, data, g_train, 1, 1, prev_params)
                    gp_bandit._synchronize(device)
            # step 0 is the first-use run for BOTH arms (and the warm arm's
            # mandatory first cold train): excluded.
            if step > 0:
                times.append(elapsed)
                _progress(f"{'warm' if warm else 'cold'} step {step}: {elapsed:.0f} ms")
        return times

    _progress(f"latency: cold arm at {num_trials}x{dim}d, {args.evals} evals")
    cold_times = run_arm(warm=False)
    _progress("latency: warm arm")
    warm_times = run_arm(warm=True)
    cold_p50 = float(np.percentile(cold_times, 50))
    warm_p50 = float(np.percentile(warm_times, 50))
    return {
        "config": {
            "num_trials": num_trials,
            "dim": dim,
            "max_evaluations": args.evals,
            "batch": args.batch,
            "cold_restarts": cold_restarts,
            "warm_restarts": 1,
            "repeats": args.repeats,
        },
        "cold_suggest_p50_ms": round(cold_p50, 1),
        "warm_suggest_p50_ms": round(warm_p50, 1),
        "cold_suggest_ms": [round(t, 1) for t in cold_times],
        "warm_suggest_ms": [round(t, 1) for t in warm_times],
        "speedup": round(cold_p50 / warm_p50, 3),
    }


def rank_sum_p(a, b) -> float:
    """Two-sided Mann-Whitney p (normal approximation), H0: same dist."""
    from scipy import stats

    a, b = np.asarray(a, float), np.asarray(b, float)
    ranks = stats.rankdata(np.concatenate([a, b]))
    n, m = len(a), len(b)
    u = ranks[:n].sum() - n * (n + 1) / 2.0
    mu, sigma = n * m / 2.0, np.sqrt(n * m * (n + m + 1) / 12.0)
    return float(2.0 * (1.0 - stats.norm.cdf(abs(u - mu) / max(sigma, 1e-9))))


def final_regret(designer, exp, trials: int, batch: int) -> float:
    """The best ``bbob_eval`` of one full BO loop of ``designer`` on ``exp``."""
    best, tid = np.inf, 0
    while tid < trials:
        picks = [s.to_trial(tid + i + 1) for i, s in enumerate(designer.suggest(batch))]
        tid += len(picks)
        exp.evaluate(picks)
        designer.update(core_lib.CompletedTrials(picks))
        for t in picks:
            best = min(best, t.final_measurement.metrics["bbob_eval"].value)
    return best


def measure_parity(args) -> dict:
    def run_arm(seed: int, warm: bool) -> float:
        exp = experimenter_factory.shifted_bbob_instance("Sphere", seed, dim=args.dim)
        designer = VizierGPUCBPEBandit(
            exp.problem_statement(),
            rng_seed=seed,
            num_seed_trials=5,
            max_acquisition_evaluations=args.parity_evals,
            use_warm_start_ard=warm,
            warm_ard_restarts=1 if warm else None,
            device=args.device,
        )
        return final_regret(designer, exp, args.parity_trials, args.parity_batch)

    warm_finals, cold_finals = [], []
    for seed in args.parity_seeds:
        t0 = time.perf_counter()
        warm_finals.append(run_arm(seed, warm=True))
        cold_finals.append(run_arm(seed, warm=False))
        _progress(
            f"parity seed {seed}: warm={warm_finals[-1]:.4f} "
            f"cold={cold_finals[-1]:.4f} ({time.perf_counter() - t0:.0f}s)"
        )
    p = rank_sum_p(warm_finals, cold_finals)
    return {
        "config": {
            "fn": "Sphere(shifted)",
            "dim": args.dim,
            "trials": args.parity_trials,
            "batch": args.parity_batch,
            "max_evaluations": args.parity_evals,
            "seeds": list(args.parity_seeds),
        },
        "warm_final_regrets": [round(v, 4) for v in warm_finals],
        "cold_final_regrets": [round(v, 4) for v in cold_finals],
        "rank_sum_p": round(p, 4),
        "parity_green": p > 0.05,
    }


def write_report(report: dict, out: Optional[str]) -> None:
    """Prints the report as one JSON line, and writes it to ``out`` if given."""
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))


def run(args) -> dict:
    report = {
        "backend": backend(args.device),
        "note": (
            "Warm-started steady-state ARD (serving designer cache, "
            "warm_ard_restarts=1) vs the reference's cold per-request "
            "train. Latency is the device-side suggest step (ARD train + "
            "acquisition sweep) at the north-star scale; parity is "
            "two-sided rank-sum on final regrets over full BO loops."
        ),
    }
    if not args.skip_latency:
        report["latency"] = measure_latency(args)
    if not args.skip_parity:
        report["parity"] = measure_parity(args)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--evals", type=int, default=75_000)
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--parity-trials", type=int, default=45)
    ap.add_argument("--parity-batch", type=int, default=5)
    ap.add_argument("--parity-evals", type=int, default=2_000)
    ap.add_argument("--parity-seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--skip-latency", action="store_true")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    write_report(run(args), args.out)


if __name__ == "__main__":
    main()
