"""A/B: sparse inducing-point surrogate vs the exact O(n³) GP.

Usage: python -m vizier_tpu_torch.tools.surrogate_ab [--out FILE]
       [--designer gp_bandit|ucb_pe]
       [--trials 1000] [--dim 20] [--evals 75000] [--inducing 128]
       [--exact-repeats 2] [--sparse-repeats 5]
       [--parity-trials 45] [--parity-seeds 1 2 3 4 5] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/surrogate_ab.py``, with
its flags and report keys, on the port's ``surrogates/`` (``SurrogateConfig``,
``sparse_bandit``, ``sparse_gp``). The report is printed as one JSON line,
and written to ``--out`` when given (there is no default file).

``--designer ucb_pe`` runs the three measurements for the service DEFAULT
(GP-UCB-PE): the sparse arm conditions the greedy batch on pending picks
through the inducing-point posterior (the ``gp_ucb_pe_sparse`` program)
instead of the exact per-pick O(n³) re-factorization; the latency arms drive
the full designer suggest (train + greedy batch) at the north-star scale.

Three measurements, one JSON report:

1. **Device-side suggest latency** at the north-star scale (1000 trials x
   20-D, 75k acquisition evals, batch 25): per repeat, ARD train + one
   full acquisition sweep, ending in ``torch.cuda.synchronize()``.
   - exact arm: multi-restart L-BFGS over the exact GP's O(n³) marginal
     likelihood (``designers/gp_bandit.py`` ``_train_gp``);
   - sparse arm: the SAME restart budget over the SGPR collapsed bound with
     m inducing points (k-center-selected inside the train,
     ``sparse_bandit._train_sparse_gp``): O(n·m²) train, O(m²) posterior
     queries in the sweep.
   Both sweep through one study's ``_sweep_studies``. Step 0 (first use) is
   excluded from both arms.

2. **Regret parity**: full BO loops on shifted Sphere instances, the sparse
   auto-switch from the first post-seed suggest vs the exact path, >= 5
   seeds, two-sided rank-sum on final regrets. Green when p > 0.05.

3. **Off-switch bit-identity**: with ``VIZIER_TORCH_SPARSE=0`` (ucb_pe:
   ``VIZIER_TORCH_SPARSE_UCB_PE=0``) the config built from the environment
   must reproduce the no-config exact path's suggestions float for float,
   proving the switch is a pure bypass (the same kernels on the same batch,
   one device: ROADMAP C6).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional
from unittest import mock

import numpy as np

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
from vizier_tpu_torch.converters import padding
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit
from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.optimizers import eagle as eagle_lib
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib
from vizier_tpu_torch.surrogates import SurrogateConfig
from vizier_tpu_torch.surrogates import sparse_bandit
from vizier_tpu_torch.surrogates import sparse_gp
from vizier_tpu_torch.tools.warm_start_ab import (
    backend, final_regret, rank_sum_p, step_generators, steady_state_data, sweep, write_report,
)


def _progress(msg: str) -> None:
    print(f"[surrogate_ab] {msg}", file=sys.stderr, flush=True)


def measure_latency(args) -> dict:
    device = device_lib.resolve(args.device)
    num_trials, dim = args.trials, args.dim
    m_pad = padding.PaddingSchedule().pad_trials(args.inducing)
    base = gp_lib.VizierGaussianProcess(num_continuous=dim, num_categorical=0, device=device)
    sparse_model = sparse_gp.SparseGaussianProcess(base=base, num_inducing=m_pad)
    ard = lbfgs_lib.LbfgsOptimizer(maxiter=50, device=device)
    strategy = eagle_lib.VectorizedEagleStrategy(num_continuous=dim, category_sizes=())
    vec_opt = vectorized_lib.VectorizedOptimizer(
        strategy, max_evaluations=args.evals, device=device
    )
    restarts = lbfgs_lib.DEFAULT_RANDOM_RESTARTS

    def run_arm(sparse: bool, repeats: int):
        times = []
        for step in range(repeats + 1):
            data = steady_state_data(num_trials, dim, step, device)
            g_train, g_acq = step_generators(device, step)
            t0 = time.perf_counter()
            if sparse:
                states = sparse_bandit._train_sparse_gp(
                    sparse_model, ard, data, g_train, restarts, 1, None
                )
            else:
                states = gp_bandit._train_gp(base, ard, data, g_train, restarts, 1)
            sweep(vec_opt, states, data, g_acq, args.batch)
            gp_bandit._synchronize(device)
            elapsed = (time.perf_counter() - t0) * 1000.0
            # step 0 is the first-use run for both arms: excluded.
            if step > 0:
                times.append(elapsed)
            _progress(
                f"{'sparse' if sparse else 'exact'} step {step}: "
                f"{elapsed:.0f} ms{' (first use, excluded)' if step == 0 else ''}"
            )
        return times

    _progress(
        f"latency: sparse arm at {num_trials}x{dim}d, m={args.inducing} "
        f"(padded {m_pad}), {args.evals} evals"
    )
    sparse_times = run_arm(sparse=True, repeats=args.sparse_repeats)
    _progress(f"latency: exact arm ({args.exact_repeats} repeats)")
    exact_times = run_arm(sparse=False, repeats=args.exact_repeats)
    sparse_p50 = float(np.percentile(sparse_times, 50))
    exact_p50 = float(np.percentile(exact_times, 50))
    return {
        "config": {
            "num_trials": num_trials,
            "dim": dim,
            "max_evaluations": args.evals,
            "batch": args.batch,
            "restarts": restarts,
            "num_inducing": args.inducing,
            "num_inducing_padded": m_pad,
            "exact_repeats": args.exact_repeats,
            "sparse_repeats": args.sparse_repeats,
        },
        "exact_suggest_p50_ms": round(exact_p50, 1),
        "sparse_suggest_p50_ms": round(sparse_p50, 1),
        "exact_suggest_ms": [round(t, 1) for t in exact_times],
        "sparse_suggest_ms": [round(t, 1) for t in sparse_times],
        "speedup": round(exact_p50 / sparse_p50, 2),
    }


def _sparse_config(num_inducing: int) -> SurrogateConfig:
    """The sparse surrogate from the first post-seed suggest."""
    return SurrogateConfig(sparse_threshold_trials=1, hysteresis_trials=0,
                           num_inducing=num_inducing)


def _ucb_pe_designer(problem, seed, args, sparse: bool):
    return VizierGPUCBPEBandit(
        problem,
        rng_seed=seed,
        max_acquisition_evaluations=args.evals,
        surrogate=_sparse_config(args.inducing) if sparse else None,
        device=args.device,
    )


def _float_problem(dim: int) -> vz.ProblemStatement:
    problem = vz.ProblemStatement()
    for d in range(dim):
        problem.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    return problem


def measure_latency_ucb_pe(args) -> dict:
    """End-to-end UCB-PE suggest latency (train + greedy batch) at the
    north-star scale: the full designer path, so the exact arm pays the
    O(n³) ARD *and* the per-pick O(n³) pending re-conditioning, the sparse
    arm their O(n·m²) inducing-point twins: same study data, same device,
    same process. Each suggest ends in ``torch.cuda.synchronize()``."""
    device = device_lib.resolve(args.device)
    num_trials, dim = args.trials, args.dim
    problem = _float_problem(dim)

    def make_trials(start_id, n, seed):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            params = {f"x{d}": float(rng.uniform()) for d in range(dim)}
            t = vz.Trial(parameters=params, id=start_id + i)
            t.complete(
                vz.Measurement(
                    metrics={
                        "obj": float(
                            -sum((v - 0.5) ** 2 for v in params.values())
                            + 0.1 * rng.normal()
                        )
                    }
                )
            )
            out.append(t)
        return out

    base_trials = make_trials(1, num_trials, seed=0)

    def run_arm(sparse: bool, repeats: int):
        designer = _ucb_pe_designer(problem, 0, args, sparse)
        designer.update(core_lib.CompletedTrials(base_trials))
        times = []
        for step in range(repeats + 1):
            if step > 0:
                # One fresh completion per steady-state step forces a
                # retrain without leaving the 1024-row padding bucket.
                designer.update(
                    core_lib.CompletedTrials(
                        make_trials(num_trials + step, 1, seed=1000 + step)
                    )
                )
            t0 = time.perf_counter()
            out = designer.suggest(args.ucb_batch)
            gp_bandit._synchronize(device)
            if len(out) != args.ucb_batch:
                raise AssertionError(f"{len(out)} suggestions for a batch of {args.ucb_batch}")
            elapsed = (time.perf_counter() - t0) * 1000.0
            if step > 0:
                times.append(elapsed)
            _progress(
                f"ucb_pe {'sparse' if sparse else 'exact'} step {step}: "
                f"{elapsed:.0f} ms"
                f"{' (first use, excluded)' if step == 0 else ''}"
            )
        if sparse and not (designer.surrogate_counts["sparse_suggests"] > 0
                           and designer.surrogate_mode == "sparse"):
            raise AssertionError("the sparse arm did not run the sparse surrogate")
        return times

    _progress(
        f"ucb_pe latency: sparse arm at {num_trials}x{dim}d, "
        f"m={args.inducing}, batch {args.ucb_batch}, {args.evals} evals"
    )
    sparse_times = run_arm(sparse=True, repeats=args.sparse_repeats)
    _progress(f"ucb_pe latency: exact arm ({args.exact_repeats} repeats)")
    exact_times = run_arm(sparse=False, repeats=args.exact_repeats)
    sparse_p50 = float(np.percentile(sparse_times, 50))
    exact_p50 = float(np.percentile(exact_times, 50))
    return {
        "config": {
            "designer": "gp_ucb_pe",
            "num_trials": num_trials,
            "dim": dim,
            "max_evaluations": args.evals,
            "batch": args.ucb_batch,
            "num_inducing": args.inducing,
            "exact_repeats": args.exact_repeats,
            "sparse_repeats": args.sparse_repeats,
        },
        "exact_suggest_p50_ms": round(exact_p50, 1),
        "sparse_suggest_p50_ms": round(sparse_p50, 1),
        "exact_suggest_ms": [round(t, 1) for t in exact_times],
        "sparse_suggest_ms": [round(t, 1) for t in sparse_times],
        "speedup": round(exact_p50 / sparse_p50, 2),
    }


def _parity(args, designer_type, **designer_kwargs) -> dict:
    """Sparse-vs-exact regret parity of ``designer_type``: full BO loops on
    shifted Sphere instances, rank-sum on final regrets."""

    def run_arm(seed: int, sparse: bool) -> float:
        exp = experimenter_factory.shifted_bbob_instance("Sphere", seed, dim=args.parity_dim)
        designer = designer_type(
            exp.problem_statement(),
            rng_seed=seed,
            max_acquisition_evaluations=args.parity_evals,
            surrogate=_sparse_config(args.parity_inducing) if sparse else None,
            device=args.device,
            **designer_kwargs,
        )
        best = final_regret(designer, exp, args.parity_trials, args.parity_batch)
        if sparse and not designer.surrogate_counts["sparse_suggests"] > 0:
            raise AssertionError("the sparse arm did not run the sparse surrogate")
        return best

    label = "ucb_pe parity" if designer_type is VizierGPUCBPEBandit else "parity"
    sparse_finals, exact_finals = [], []
    for seed in args.parity_seeds:
        t0 = time.perf_counter()
        sparse_finals.append(run_arm(seed, sparse=True))
        exact_finals.append(run_arm(seed, sparse=False))
        _progress(
            f"{label} seed {seed}: sparse={sparse_finals[-1]:.4f} "
            f"exact={exact_finals[-1]:.4f} ({time.perf_counter() - t0:.0f}s)"
        )
    p = rank_sum_p(sparse_finals, exact_finals)
    config = {
        "fn": "Sphere(shifted)",
        "dim": args.parity_dim,
        "trials": args.parity_trials,
        "batch": args.parity_batch,
        "max_evaluations": args.parity_evals,
        "num_inducing": args.parity_inducing,
        "sparse_threshold_trials": 1,
        "seeds": list(args.parity_seeds),
    }
    if designer_type is VizierGPUCBPEBandit:
        config = {"designer": "gp_ucb_pe", **config}
    return {
        "config": config,
        "sparse_final_regrets": [round(v, 4) for v in sparse_finals],
        "exact_final_regrets": [round(v, 4) for v in exact_finals],
        "rank_sum_p": round(p, 4),
        "parity_green": p > 0.05,
    }


def measure_parity_ucb_pe(args) -> dict:
    """Sparse-vs-exact UCB-PE regret parity at >= 5 seeds."""
    return _parity(args, VizierGPUCBPEBandit)


def measure_parity(args) -> dict:
    """Sparse-vs-exact GP-bandit regret parity at >= 5 seeds."""
    return _parity(args, VizierGPBandit, num_seed_trials=5)


def _off_switch(switch: str, designer_type, device, **designer_kwargs) -> bool:
    """Whether ``switch``=0's config from the environment reproduces the
    no-config path's suggestions float for float on a 4-D study of 16
    trials (two rounds of ``suggest(2)``)."""
    problem = _float_problem(4)
    rng = np.random.default_rng(7)
    trials = []
    for i in range(16):
        params = {f"x{d}": float(rng.uniform()) for d in range(4)}
        t = vz.Trial(parameters=params, id=i + 1)
        t.complete(vz.Measurement(metrics={"obj": float(sum(params.values()))}))
        trials.append(t)
    with mock.patch.dict(os.environ, {switch: "0"}):
        off_cfg = SurrogateConfig.from_env()
    if designer_type is VizierGPUCBPEBandit:
        if off_cfg.sparse_ucb_pe:
            raise AssertionError(f"{switch}=0 left the UCB-PE surrogate on")
        # The threshold below the study, so only the ucb_pe gate stands
        # between this designer and the sparse path.
        off_cfg = SurrogateConfig(
            sparse=off_cfg.sparse, sparse_threshold_trials=1, hysteresis_trials=0,
            num_inducing=8, sparse_ucb_pe=off_cfg.sparse_ucb_pe,
        )
    elif off_cfg.sparse:
        raise AssertionError(f"{switch}=0 left the surrogate on")

    def run(surrogate):
        d = designer_type(problem, rng_seed=11, max_acquisition_evaluations=500,
                          surrogate=surrogate, device=device, **designer_kwargs)
        d.update(core_lib.CompletedTrials(trials))
        return [[s.parameters.as_dict() for s in d.suggest(2)] for _ in range(2)]

    return run(None) == run(off_cfg)


def check_off_bit_identity_ucb_pe(device="cuda") -> dict:
    """VIZIER_TORCH_SPARSE_UCB_PE=0 must reproduce the no-config UCB-PE path
    bit for bit (even with the study above the sparse threshold)."""
    identical = _off_switch("VIZIER_TORCH_SPARSE_UCB_PE", VizierGPUCBPEBandit, device)
    _progress(f"ucb_pe off-switch bit-identity: {identical}")
    return {"off_bit_identical": identical}


def check_off_bit_identity(device="cuda") -> dict:
    """VIZIER_TORCH_SPARSE=0 must reproduce the no-config path bit for bit."""
    identical = _off_switch("VIZIER_TORCH_SPARSE", VizierGPBandit, device, num_seed_trials=1)
    _progress(f"off-switch bit-identity: {identical}")
    return {"off_bit_identical": identical}


def run(args) -> dict:
    ucb_pe = args.designer == "ucb_pe"
    report = {
        "backend": backend(args.device),
        "designer": args.designer,
        # Which path produced what: both arms are stamped explicitly, and
        # the process-wide env default rides along for provenance.
        "surrogates_env_config": SurrogateConfig.from_env().as_dict(),
        "note": (
            (
                "Sparse UCB-PE (SGPR collapsed-bound train + pending-pick "
                "conditioning through the Nyström-augmented inducing "
                "posterior; compute-IR kind gp_ucb_pe_sparse) vs the exact "
                "UCB-PE path (O(n³) ARD + O(n³) per-pick re-conditioning). "
                "Latency is the full designer suggest (train + greedy "
                "batch) at the north-star scale, same run/device; parity "
                "is two-sided rank-sum on final regrets over full BO "
                "loops; VIZIER_TORCH_SPARSE_UCB_PE=0 is checked "
                "bit-identical to the exact path."
            )
            if ucb_pe
            else (
                "Sparse SGPR collapsed-bound surrogate (k-center inducing "
                "selection, same multi-restart L-BFGS ARD) vs the "
                "exact O(n³) GP. Latency is the device-side suggest step "
                "(train + acquisition sweep) at the north-star scale; "
                "parity is two-sided rank-sum on final regrets over full "
                "BO loops; VIZIER_TORCH_SPARSE=0 is checked bit-identical "
                "to the exact path."
            )
        ),
    }
    if not args.skip_latency:
        report["latency"] = measure_latency_ucb_pe(args) if ucb_pe else measure_latency(args)
    if not args.skip_parity:
        report["parity"] = measure_parity_ucb_pe(args) if ucb_pe else measure_parity(args)
    report["off_switch"] = (
        check_off_bit_identity_ucb_pe(args.device) if ucb_pe
        else check_off_bit_identity(args.device)
    )
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--designer", choices=("gp_bandit", "ucb_pe"), default="gp_bandit")
    ap.add_argument("--ucb-batch", type=int, default=5)
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--evals", type=int, default=75_000)
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--inducing", type=int, default=128)
    ap.add_argument("--exact-repeats", type=int, default=2)
    ap.add_argument("--sparse-repeats", type=int, default=5)
    ap.add_argument("--parity-trials", type=int, default=45)
    ap.add_argument("--parity-batch", type=int, default=5)
    ap.add_argument("--parity-dim", type=int, default=20)
    ap.add_argument("--parity-evals", type=int, default=2_000)
    ap.add_argument("--parity-inducing", type=int, default=16)
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
