"""Noise-robustness sweep: the DEFAULT designer under the BBOB-noisy zoo.

Usage: python -m vizier_tpu_torch.tools.noise_robustness [--trials 60]
       [--seeds 1 2 3] [--device cuda|cpu] [--out FILE]

The port's counterpart of the JAX package's ``tools/noise_robustness.py``,
with its flags and report keys. It runs ``VizierGPUCBPEBandit`` on shifted
4-D Sphere under every noise model in ``wrappers.NOISE_TYPES`` and reports
the final TRUE simple regret (the ``_before_noise`` metric of the
observed-noisy incumbent: what the tuner delivered, judged on clean ground
truth). The report is printed as one JSON line, and written to ``--out``
when given (there is no default file); one line per (noise, seed) goes to
standard error as it finishes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory, wrappers
from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
from vizier_tpu_torch.tools.warm_start_ab import write_report


def true_regret_of_noisy_incumbent(designer, exp, trials: int, batch: int) -> float:
    """One BO loop of ``designer`` on the noisy ``exp``: the clean value of
    the trial whose noisy value was best."""
    best_noisy, best_true, tid = np.inf, np.inf, 0
    while tid < trials:
        picks = [s.to_trial(tid + i + 1) for i, s in enumerate(designer.suggest(batch))]
        tid += len(picks)
        exp.evaluate(picks)
        designer.update(core_lib.CompletedTrials(picks))
        for t in picks:
            m = t.final_measurement.metrics
            noisy = m["bbob_eval"].value
            if noisy < best_noisy:
                best_noisy = noisy
                # True regret of the incumbent the tuner believes in.
                best_true = m["bbob_eval_before_noise"].value
    return best_true


def run(args) -> dict:
    device = device_lib.resolve(args.device)
    results: dict = {}
    for noise_type in wrappers.NOISE_TYPES:
        finals = []
        for seed in args.seeds:
            clean = experimenter_factory.shifted_bbob_instance("Sphere", seed, dim=args.dim)
            exp = wrappers.NoisyExperimenter.from_type(clean, noise_type, seed=seed)
            designer = VizierGPUCBPEBandit(
                exp.problem_statement(),
                rng_seed=seed,
                max_acquisition_evaluations=args.evals,
                num_seed_trials=5,
                device=device,
            )
            best_true = true_regret_of_noisy_incumbent(designer, exp, args.trials, args.batch)
            finals.append(best_true)
            print(json.dumps({"noise": noise_type, "seed": seed,
                              "true_regret": round(best_true, 4)}),
                  file=sys.stderr, flush=True)
        results[noise_type] = {
            "per_seed_true_regret": [round(v, 4) for v in finals],
            "median": round(float(np.median(finals)), 4),
        }
    return {
        "config": (
            f"shifted Sphere {args.dim}-D, {args.trials} trials x batch "
            f"{args.batch}, DEFAULT designer, seeds {args.seeds}"
        ),
        "metric": "true simple regret of the noisy-incumbent (before_noise)",
        "results": results,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--evals", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    write_report(run(args), args.out)


if __name__ == "__main__":
    main()
