"""SimpleKD convergence tester.

The port's copy of the JAX package's ``testing/simplekd_runner.py``: runs a
designer on the SimpleKD mixed-space objective and asserts it gets within
``max_abs_error`` of the known optimum. The designer runs wherever its
factory puts it (the port's designers default to CUDA).
"""

from __future__ import annotations

import dataclasses

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks.experimenters.synthetic import simplekd
from vizier_tpu_torch.benchmarks.runners import benchmark_runner, benchmark_state
from vizier_tpu_torch.pyvizier import trial as trial_


class ConvergenceTestError(Exception):
    pass


@dataclasses.dataclass
class SimpleKDConvergenceTester:
    best_category: str = "corner"
    num_trials: int = 60
    batch_size: int = 5
    max_abs_error: float = 0.4  # objective units below the optimum (0.0)
    seed: int = 0

    def assert_converges(self, designer_factory: core_lib.DesignerFactory) -> float:
        experimenter = simplekd.SimpleKDExperimenter(self.best_category)
        state = benchmark_state.BenchmarkState.from_designer_factory(
            experimenter, designer_factory, seed=self.seed
        )
        benchmark_runner.BenchmarkRunner(
            [benchmark_runner.GenerateAndEvaluate(self.batch_size)],
            num_repeats=self.num_trials // self.batch_size,
        ).run(state)
        trials = state.algorithm.supporter.GetTrials(
            status_matches=trial_.TrialStatus.COMPLETED
        )
        best = max(
            t.final_measurement.metrics["value"].value
            for t in trials
            if t.final_measurement is not None
        )
        error = experimenter.optimal_value - best
        if error > self.max_abs_error:
            raise ConvergenceTestError(
                f"Best value {best:.4f} is {error:.4f} below the optimum "
                f"(allowed {self.max_abs_error})."
            )
        return best
