"""Curve-based automated early stopping.

Copy of the JAX package's ``algorithms/early_stopping.py`` (host numpy).
The median-curve rule is a policy of its own: a trial should stop when its
objective at its latest reported step or time is below the median of the
other trials' objectives at a comparable point, once ``min_num_trials``
trials carry measurements. The regression rule stops an active trial whose
predicted final objective (``algorithms/regression.py``) falls below the
median completed final. Reached through ``Policy.early_stop``, as
``InRamPolicySupporter.EarlyStopTrials`` calls it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter as supporter_lib


def _latest_value(
    trial: vz.Trial, metric: str, use_steps: bool
) -> Optional[Tuple[float, float]]:
    """(position, value) of the trial's latest intermediate measurement."""
    best = None
    for m in trial.measurements:
        if metric not in m.metrics:
            continue
        pos = m.steps if use_steps else m.elapsed_secs
        if best is None or pos >= best[0]:
            best = (pos, m.metrics[metric].value)
    if best is None and trial.final_measurement and metric in trial.final_measurement.metrics:
        fm = trial.final_measurement
        pos = fm.steps if use_steps else fm.elapsed_secs
        best = (pos, fm.metrics[metric].value)
    return best


def _value_at(
    trial: vz.Trial, metric: str, position: float, use_steps: bool
) -> Optional[float]:
    """The trial's objective at the last measurement with pos <= position."""
    value = None
    for m in trial.measurements:
        if metric not in m.metrics:
            continue
        pos = m.steps if use_steps else m.elapsed_secs
        if pos <= position:
            value = m.metrics[metric].value
    return value


@dataclasses.dataclass
class MedianEarlyStopPolicy(policy_lib.Policy):
    """Median rule over intermediate measurement curves."""

    supporter: supporter_lib.PolicySupporter
    use_steps: bool = True
    min_num_trials: int = 5

    def suggest(self, request: policy_lib.SuggestRequest) -> policy_lib.SuggestDecision:
        raise NotImplementedError("MedianEarlyStopPolicy only early-stops.")

    def early_stop(
        self, request: policy_lib.EarlyStopRequest
    ) -> policy_lib.EarlyStopDecisions:
        config = request.study_config
        problem = config.to_problem()
        metric_info = None
        for m in problem.metric_information:
            if not m.is_safety_metric:
                metric_info = m
                break
        if metric_info is None:
            return policy_lib.EarlyStopDecisions()
        metric = metric_info.name
        sign = 1.0 if metric_info.goal.is_maximize else -1.0

        all_trials = self.supporter.GetTrials()
        with_curves = [t for t in all_trials if t.measurements]
        decisions = []
        for tid in sorted(request.trial_ids):
            trial = next((t for t in all_trials if t.id == tid), None)
            if trial is None:
                continue
            if len(with_curves) < self.min_num_trials:
                decisions.append(
                    policy_lib.EarlyStopDecision(
                        id=tid, should_stop=False,
                        reason=f"Fewer than {self.min_num_trials} trials with curves.",
                    )
                )
                continue
            latest = _latest_value(trial, metric, self.use_steps)
            if latest is None:
                decisions.append(
                    policy_lib.EarlyStopDecision(
                        id=tid, should_stop=False, reason="No measurements yet."
                    )
                )
                continue
            position, value = latest
            others = [
                v
                for t in with_curves
                if t.id != tid
                and (v := _value_at(t, metric, position, self.use_steps)) is not None
            ]
            if len(others) < self.min_num_trials - 1:
                decisions.append(
                    policy_lib.EarlyStopDecision(
                        id=tid, should_stop=False,
                        reason="Not enough comparable curves.",
                    )
                )
                continue
            median = float(np.median(np.asarray(others)))
            should = sign * value < sign * median
            decisions.append(
                policy_lib.EarlyStopDecision(
                    id=tid,
                    should_stop=should,
                    reason=(
                        f"value {value:.4g} vs median {median:.4g} at "
                        f"{'step' if self.use_steps else 'secs'} {position:g}"
                    ),
                )
            )
        return policy_lib.EarlyStopDecisions(decisions=decisions)


@dataclasses.dataclass
class RegressionEarlyStopPolicy(policy_lib.Policy):
    """Curve-regression stopping rule.

    Trains the gradient-boosted final-objective regressor
    (``algorithms/regression.py``) on completed trials' curves and stops any
    ACTIVE trial whose predicted final objective falls below the median
    completed final — sharper than the median rule once enough curves exist
    (a trial that starts slow but trends well is kept; one plateauing below
    the pack is cut even while its current value still looks median-ish).
    Falls back to keep-running while the regressor is underfit.
    """

    supporter: supporter_lib.PolicySupporter
    min_num_trials: int = 10

    def __post_init__(self):
        # GBM training is the expensive step; cache the fit keyed by the
        # completed-trial count so repeated CheckTrialEarlyStoppingState
        # polls between completions reuse it (this policy object itself is
        # cached per study by the Pythia servicer).
        self._regressor = None
        self._trained_on = -1

    @property
    def should_be_cached(self) -> bool:
        return True

    def suggest(self, request: policy_lib.SuggestRequest) -> policy_lib.SuggestDecision:
        raise NotImplementedError("RegressionEarlyStopPolicy only early-stops.")

    def _trained_regressor(self, metric: str, completed):
        from vizier_tpu_torch.algorithms import regression

        if len(completed) == self._trained_on:
            return self._regressor
        regressor = regression.GBMAutoRegressor(
            metric, min_train_trials=self.min_num_trials
        )
        self._regressor = regressor if regressor.train(completed) else None
        self._trained_on = len(completed)
        return self._regressor

    def early_stop(
        self, request: policy_lib.EarlyStopRequest
    ) -> policy_lib.EarlyStopDecisions:
        config = request.study_config
        problem = config.to_problem()
        metric_info = next(
            (m for m in problem.metric_information if not m.is_safety_metric), None
        )
        if metric_info is None:
            return policy_lib.EarlyStopDecisions()
        metric = metric_info.name
        sign = 1.0 if metric_info.goal.is_maximize else -1.0

        all_trials = self.supporter.GetTrials()
        completed = [t for t in all_trials if t.is_completed and not t.infeasible]
        decisions = []

        regressor = (
            self._trained_regressor(metric, completed)
            if len(completed) >= self.min_num_trials
            else None
        )
        trained = regressor is not None
        if trained:
            finals = [
                sign * t.final_measurement.metrics[metric].value
                for t in completed
                if t.final_measurement and metric in t.final_measurement.metrics
            ]
            threshold = float(np.median(finals)) if finals else -np.inf
        for tid in sorted(request.trial_ids):
            trial = next((t for t in all_trials if t.id == tid), None)
            if trial is None:
                continue
            if not trained or not trial.measurements:
                decisions.append(
                    policy_lib.EarlyStopDecision(
                        id=tid, reason="Too little curve data.", should_stop=False
                    )
                )
                continue
            pred = regressor.predict(trial)
            should = pred is not None and sign * pred < threshold
            decisions.append(
                policy_lib.EarlyStopDecision(
                    id=tid,
                    reason=(
                        f"Predicted final {pred:.4g} below completed median."
                        if should
                        else "Predicted final at or above completed median."
                    ),
                    should_stop=bool(should),
                )
            )
        return policy_lib.EarlyStopDecisions(decisions=decisions)
