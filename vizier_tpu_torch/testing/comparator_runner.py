"""Statistical algorithm-comparison testers.

The port's copy of the JAX package's ``testing/comparator_runner.py``:
``EfficiencyComparisonTester`` (log-efficiency score of candidate vs
baseline over repeated runs) and ``SimpleRegretComparisonTester`` (one-sided
regret comparison), used by convergence tests to gate algorithm changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as cc
from vizier_tpu_torch.benchmarks.experimenters import base as experimenter_base
from vizier_tpu_torch.benchmarks.runners import benchmark_runner, benchmark_state
from vizier_tpu_torch.pyvizier import trial as trial_


class FailedComparisonTestError(Exception):
    """The candidate did not beat/meet the baseline."""


def _run_curves(
    experimenter: experimenter_base.Experimenter,
    factory: core_lib.DesignerFactory,
    *,
    num_trials: int,
    num_repeats: int,
    batch_size: int = 1,
    seed: int = 0,
) -> cc.ConvergenceCurve:
    curves = []
    problem = experimenter.problem_statement()
    metric = next(m for m in problem.metric_information if not m.is_safety_metric)
    converter = cc.ConvergenceCurveConverter(metric, flip_signs_for_min=True)
    for r in range(num_repeats):
        state = benchmark_state.BenchmarkState.from_designer_factory(
            experimenter, factory, seed=seed + r
        )
        benchmark_runner.BenchmarkRunner(
            [benchmark_runner.GenerateAndEvaluate(batch_size)],
            num_repeats=num_trials // batch_size,
        ).run(state)
        trials = state.algorithm.supporter.GetTrials(
            status_matches=trial_.TrialStatus.COMPLETED
        )
        curves.append(converter.convert(trials))
    return cc.ConvergenceCurve.align_xs(curves)


@dataclasses.dataclass
class EfficiencyComparisonTester:
    """Asserts the candidate is at least ``baseline - margin`` efficient."""

    num_trials: int = 50
    num_repeats: int = 3
    margin: float = 0.3

    def assert_better_efficiency(
        self,
        experimenter: experimenter_base.Experimenter,
        candidate_factory: core_lib.DesignerFactory,
        baseline_factory: core_lib.DesignerFactory,
        *,
        batch_size: int = 1,
        seed: int = 0,
    ) -> float:
        baseline = _run_curves(
            experimenter,
            baseline_factory,
            num_trials=self.num_trials,
            num_repeats=self.num_repeats,
            batch_size=batch_size,
            seed=seed,
        )
        candidate = _run_curves(
            experimenter,
            candidate_factory,
            num_trials=self.num_trials,
            num_repeats=self.num_repeats,
            batch_size=batch_size,
            seed=seed + 1000,
        )
        score = cc.LogEfficiencyConvergenceCurveComparator(baseline).score(candidate)
        if score < -self.margin:
            raise FailedComparisonTestError(
                f"Candidate log-efficiency {score:.3f} below -margin {-self.margin}."
            )
        return score


@dataclasses.dataclass
class SimpleRegretComparisonTester:
    """Asserts candidate's median simple regret <= baseline's + tolerance."""

    num_trials: int = 50
    num_repeats: int = 3
    tolerance: float = 0.0

    def assert_better_simple_regret(
        self,
        experimenter: experimenter_base.Experimenter,
        candidate_factory: core_lib.DesignerFactory,
        baseline_factory: core_lib.DesignerFactory,
        *,
        seed: int = 0,
    ) -> None:
        def final_median(factory, offset):
            curve = _run_curves(
                experimenter,
                factory,
                num_trials=self.num_trials,
                num_repeats=self.num_repeats,
                seed=seed + offset,
            )
            # Curves are flipped to INCREASING; bigger is better.
            return float(np.median(curve.ys[:, -1]))

        baseline = final_median(baseline_factory, 0)
        candidate = final_median(candidate_factory, 1000)
        if candidate + self.tolerance < baseline:
            raise FailedComparisonTestError(
                f"Candidate final objective {candidate:.4f} worse than "
                f"baseline {baseline:.4f} (tolerance {self.tolerance})."
            )
