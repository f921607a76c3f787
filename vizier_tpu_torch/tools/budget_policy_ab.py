"""A/B of the acquisition budget policies on shifted 20-D BBOB.

Usage: python -m vizier_tpu_torch.tools.budget_policy_ab [--trials 150]
       [--seeds 1 2 3 4 5] [--device cuda|cpu] [--out FILE]

The port's counterpart of the JAX package's ``tools/budget_policy_ab.py``,
with its flags and report keys. It compares ``first_pick_full`` (the
DEFAULT's policy: a full budget on the exploitation pick, one further budget
split across the exploration picks) against ``per_pick`` (a full budget on
every pick) and ``per_batch`` (one split budget) on the pinned shifted
instances (``experimenter_factory.shifted_bbob_instance``): Sphere and
Rastrigin in 20-D and Branin in the BBOB frame. The report is printed as one
JSON line, and written to ``--out`` when given (there is no default file);
one line per (function, policy, seed) goes to standard error as it finishes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
from vizier_tpu_torch.tools.warm_start_ab import final_regret, write_report

POLICIES = ("first_pick_full", "per_batch", "per_pick")
# Two 20-D BBOB families plus a low-D classic, so the evidence does not rest
# on one dimensionality.
CONFIGS = (("Sphere", 20), ("Rastrigin", 20), ("Branin", 2))
# Optimum VALUE of each objective (the shift moves the argmin, not the
# minimum), subtracted so "final_regret" is a true regret.
OPTIMA = {"Sphere": 0.0, "Rastrigin": 0.0, "Branin": 0.3978873577}


def run(args) -> dict:
    device = device_lib.resolve(args.device)
    results: dict = {}
    for fn_name, dim in CONFIGS:
        for policy in POLICIES:
            finals = []
            for seed in args.seeds:
                exp = experimenter_factory.shifted_bbob_instance(fn_name, seed, dim=dim)
                designer = VizierGPUCBPEBandit(
                    exp.problem_statement(),
                    rng_seed=seed,
                    max_acquisition_evaluations=args.evals,
                    num_seed_trials=5,
                    acquisition_budget_policy=policy,
                    device=device,
                )
                t0 = time.perf_counter()
                best = final_regret(designer, exp, args.trials, args.batch)
                elapsed = time.perf_counter() - t0
                best -= OPTIMA[fn_name]
                finals.append(best)
                print(json.dumps({"fn": fn_name, "dim": dim, "policy": policy, "seed": seed,
                                  "final_regret": round(best, 4),
                                  "wall_s": round(elapsed, 1)}),
                      file=sys.stderr, flush=True)
            results[(f"{fn_name}{dim}d", policy)] = finals
    summary = {
        f"{cfg}:{policy}": float(np.median(finals))
        for (cfg, policy), finals in results.items()
    }
    return {
        "seeds": args.seeds,
        "trials": args.trials,
        "batch": args.batch,
        "evals": args.evals,
        "per_run": {
            f"{cfg}:{pol}": [round(v, 4) for v in finals]
            for (cfg, pol), finals in results.items()
        },
        "median_final_regret": summary,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=150)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--evals", type=int, default=25_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    write_report(run(args), args.out)


if __name__ == "__main__":
    main()
