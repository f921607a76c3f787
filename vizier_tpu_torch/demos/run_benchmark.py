"""Benchmark demo: compares designers on a BBOB function.

The port's counterpart of the JAX package's ``demos/run_benchmark.py``.

Usage::

  python -m vizier_tpu_torch.demos.run_benchmark [--function Sphere] [--dim 4]
      [--trials 30] [--repeats 2] [--platform cuda|cpu] [--out convergence.png]

The GP bandit runs on ``--platform`` (``cuda`` by default, which needs a
GPU). Each run's best objective is printed; a convergence plot is written
only when ``--out`` is given (it needs matplotlib).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    """Runs every designer ``--repeats`` times; returns each one's best
    objective per repeat."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--function", default="Sphere")
    parser.add_argument("--dim", type=int, default=4)
    parser.add_argument("--trials", type=int, default=30)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--out", default=None)
    parser.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from vizier_tpu_torch import benchmarks
    from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob
    from vizier_tpu_torch.designers import QuasiRandomDesigner, RandomDesigner
    from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit

    functions = dict(bbob.BBOB_FUNCTIONS, **bbob.EXTRA_FUNCTIONS)
    fn = functions[args.function]
    factories = {
        "random": lambda p, **kw: RandomDesigner(p.search_space, seed=kw.get("seed", 0)),
        "quasirandom": lambda p, **kw: QuasiRandomDesigner(p.search_space, seed=kw.get("seed", 0)),
        "gp_ucb": lambda p, **kw: VizierGPBandit(
            p, rng_seed=kw.get("seed") or 0, max_acquisition_evaluations=5000,
            device=args.platform,
        ),
    }
    states, names = [], []
    best: Dict[str, List[float]] = {}
    for name, factory in factories.items():
        for r in range(args.repeats):
            exp = benchmarks.NumpyExperimenter(fn, benchmarks.bbob_problem(args.dim))
            state = benchmarks.BenchmarkState.from_designer_factory(exp, factory, seed=r)
            benchmarks.BenchmarkRunner(
                [benchmarks.GenerateAndEvaluate(2)],
                num_repeats=-(-args.trials // 2),  # ceil: honor odd budgets
            ).run(state)
            metric = exp.problem_statement().metric_information.item()
            values = [
                t.final_measurement.metrics[metric.name].value
                for t in state.algorithm.supporter.GetTrials()
            ]
            value = max(values) if metric.goal.is_maximize else min(values)
            best.setdefault(name, []).append(value)
            states.append(state)
            names.append(name)
            print(f"{name} repeat {r}: {len(values)} trials, best {value:.6g}", flush=True)
    if args.out:
        from vizier_tpu_torch.benchmarks.analyzers import plot_utils

        ax = plot_utils.plot_states(
            states, algorithm_names=names, title=f"{args.function} {args.dim}D"
        )
        ax.get_figure().savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    return best


if __name__ == "__main__":
    main()
