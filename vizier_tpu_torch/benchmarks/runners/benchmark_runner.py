"""Benchmark runner: composable suggest/evaluate subroutines.

Parity with
``vizier/_src/benchmarks/runners/benchmark_runner.py:63-237``.

Copy of the JAX package's ``benchmarks/runners/benchmark_runner.py``, on the port's pythia and designer policies.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional, Sequence

from vizier_tpu_torch.benchmarks.runners import benchmark_state
from vizier_tpu_torch.pyvizier import trial as trial_


class BenchmarkSubroutine(abc.ABC):
    @abc.abstractmethod
    def run(self, state: benchmark_state.BenchmarkState) -> None:
        ...


@dataclasses.dataclass
class GenerateSuggestions(BenchmarkSubroutine):
    num_suggestions: int = 1

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        state.algorithm.suggest(self.num_suggestions)


@dataclasses.dataclass
class EvaluateActiveTrials(BenchmarkSubroutine):
    """Evaluates all (or the first ``max_num_trials``) ACTIVE trials."""

    max_num_trials: Optional[int] = None

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        active = state.algorithm.supporter.GetTrials(
            status_matches=trial_.TrialStatus.ACTIVE
        )
        if self.max_num_trials is not None:
            active = active[: self.max_num_trials]
        state.experimenter.evaluate(active)


@dataclasses.dataclass
class GenerateAndEvaluate(BenchmarkSubroutine):
    num_suggestions: int = 1

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        trials = state.algorithm.suggest(self.num_suggestions)
        state.experimenter.evaluate(trials)


@dataclasses.dataclass
class AddPriorTrials(BenchmarkSubroutine):
    """Injects pre-existing (completed) trials into the study."""

    trials: Sequence[trial_.Trial] = ()

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        state.algorithm.supporter.AddTrials(list(self.trials))


@dataclasses.dataclass
class BenchmarkRunner(BenchmarkSubroutine):
    """Runs subroutines in order, ``num_repeats`` times."""

    benchmark_subroutines: Sequence[BenchmarkSubroutine] = ()
    num_repeats: int = 1

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        for _ in range(self.num_repeats):
            for sub in self.benchmark_subroutines:
                sub.run(state)
