"""Benchmark-state → records/DataFrame summaries.

Parity with ``vizier/_src/benchmarks/analyzers/state_analyzer.py:87``.

Copy of the JAX package's ``benchmarks/analyzers/state_analyzer.py``, over
the port's ``BenchmarkState``; pandas is imported by the DataFrame helpers
only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as cc
from vizier_tpu_torch.benchmarks.runners import benchmark_state
from vizier_tpu_torch.pyvizier import trial as trial_


class BenchmarkStateAnalyzer:
    """Summarizes finished benchmark states into plain records."""

    @staticmethod
    def to_records(
        states: Sequence[benchmark_state.BenchmarkState],
        *,
        algorithm_names: Optional[Sequence[str]] = None,
    ) -> List[Dict]:
        records = []
        for i, state in enumerate(states):
            problem = state.experimenter.problem_statement()
            metric = next(
                m for m in problem.metric_information if not m.is_safety_metric
            )
            trials = state.algorithm.supporter.GetTrials(
                status_matches=trial_.TrialStatus.COMPLETED
            )
            curve = cc.ConvergenceCurveConverter(
                metric, flip_signs_for_min=True
            ).convert(trials)
            records.append(
                {
                    "algorithm": (
                        algorithm_names[i] if algorithm_names else f"algo_{i}"
                    ),
                    "num_trials": len(trials),
                    "best_objective": float(curve.ys[0, -1]) if len(trials) else np.nan,
                    "curve_xs": curve.xs,
                    "curve_ys": curve.ys[0],
                }
            )
        return records

    @staticmethod
    def to_dataframe(states, *, algorithm_names=None):
        import pandas as pd

        return pd.DataFrame(
            BenchmarkStateAnalyzer.to_records(states, algorithm_names=algorithm_names)
        )


@dataclasses.dataclass
class PlotElement:
    """One named curve of a benchmark run (reference ``PlotElement``)."""

    curve: cc.ConvergenceCurve
    yscale: str = "linear"  # 'linear' | 'symlog'


@dataclasses.dataclass
class BenchmarkRecord:
    """One (algorithm, experimenter) result bundle (reference ``:76``).

    ``plot_elements`` maps element names (e.g. 'objective', 'hypervolume')
    to curves; comparison scores are added by ``BenchmarkRecordAnalyzer``.
    """

    algorithm: str
    experimenter_metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    plot_elements: Dict[str, PlotElement] = dataclasses.field(default_factory=dict)
    scores: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def experimenter_key(self) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(self.experimenter_metadata.items()))


class BenchmarkRecordAnalyzer:
    """Cross-record comparison + pandas summaries (reference ``:195``)."""

    @staticmethod
    def add_comparison_metrics(
        records: Sequence[BenchmarkRecord],
        baseline_algo: str,
        *,
        element: str = "objective",
    ) -> List[BenchmarkRecord]:
        """Scores every record against the baseline algorithm's curve on the
        same experimenter: log-efficiency, win-rate, percentage-better."""
        baselines = {
            r.experimenter_key: r
            for r in records
            if r.algorithm == baseline_algo and element in r.plot_elements
        }
        for r in records:
            if element not in r.plot_elements:
                continue
            base = baselines.get(r.experimenter_key)
            if base is None:
                continue
            base_curve = base.plot_elements[element].curve
            curve = r.plot_elements[element].curve
            # Align lengths: extrapolate the shorter run at its incumbent.
            gap = len(base_curve.xs) - len(curve.xs)
            if gap > 0:
                curve = curve.extrapolate_ys(gap)
            elif gap < 0:
                base_curve = base_curve.extrapolate_ys(-gap)
            r.scores[f"log_efficiency_vs_{baseline_algo}"] = (
                cc.LogEfficiencyConvergenceCurveComparator(base_curve).score(curve)
            )
            r.scores[f"win_rate_vs_{baseline_algo}"] = cc.WinRateComparator(
                base_curve
            ).score(curve)
            r.scores[f"pct_better_vs_{baseline_algo}"] = (
                cc.PercentageBetterComparator(base_curve).score(curve)
            )
        return list(records)

    @staticmethod
    def summarize(records: Sequence[BenchmarkRecord]) -> List[Dict]:
        """Flat records (one row per (algorithm, experimenter)) for pandas."""
        rows = []
        for r in records:
            row: Dict = {
                "algorithm": r.algorithm,
                "experimenter": r.experimenter_key,
            }
            for name, element in r.plot_elements.items():
                curve = element.curve
                if curve.ys.size:
                    row[f"{name}_final_median"] = float(
                        np.median(curve.ys[:, -1])
                    )
                    row[f"{name}_num_trials"] = int(curve.xs[-1])
            row.update(r.scores)
            rows.append(row)
        return rows

    @staticmethod
    def summarize_dataframe(records: Sequence[BenchmarkRecord]):
        import pandas as pd

        return pd.DataFrame(BenchmarkRecordAnalyzer.summarize(records))
