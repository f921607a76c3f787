"""Designer smoke-test runners.

The port's copy of the JAX package's ``testing/test_runners.py``: drive a
designer through suggest/update loops with random metrics, asserting every
suggestion stays inside the search space.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class RandomMetricsRunner:
    """Feeds random metric values to a designer for N iterations."""

    problem: base_study_config.ProblemStatement
    iters: int = 5
    batch_size: int = 1
    seed: int = 0
    verify_parameters: bool = True

    def run_designer(self, designer: core_lib.Designer) -> List[trial_.Trial]:
        rng = np.random.default_rng(self.seed)
        all_trials: List[trial_.Trial] = []
        next_id = 1
        for _ in range(self.iters):
            suggestions = designer.suggest(self.batch_size)
            if not suggestions:
                break
            completed = []
            for s in suggestions:
                if self.verify_parameters:
                    self.problem.search_space.assert_contains(s.parameters)
                t = s.to_trial(next_id)
                next_id += 1
                metrics = {
                    m.name: float(rng.uniform(-1, 1))
                    for m in self.problem.metric_information
                }
                t.complete(trial_.Measurement(metrics=metrics))
                completed.append(t)
            all_trials.extend(completed)
            designer.update(
                core_lib.CompletedTrials(completed), core_lib.ActiveTrials()
            )
        return all_trials
