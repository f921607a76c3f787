"""Meta-learning designer: tunes a designer's own hyperparameters online.

Copy of the JAX package's ``designers/meta_learning.py`` (host numpy): an
outer (meta) designer proposes hyperparameter configs for the inner designer
factory; each config is scored by the objective progress made during its
tenure, and the meta designer is updated with those scores. The default
meta designer is the port's ``RandomDesigner(seed)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

META_METRIC = "meta_reward"


@dataclasses.dataclass
class MetaLearningConfig:
    """Reference ``MetaLearningConfig`` (``meta_learning.py:58``) semantics.

    The meta-learner runs through three phases by completed-trial count:
    INITIALIZE (below ``tuning_min_num_trials``: default hyperparams, gather
    signal), TUNE (between the thresholds: each meta round tries one
    hyperparameter config for ``tuning_interval`` trials and scores it), and
    USE_BEST_PARAMS (past ``tuning_max_num_trials``: lock in the best-scoring
    config — further exploration wastes suggestion budget).
    """

    tuning_interval: int = 100  # trials per meta round (num_trials_per_tuning)
    num_seed_rounds: int = 1
    tuning_min_num_trials: int = 3_000  # TUNE starts at this many completed
    tuning_max_num_trials: int = 10_000  # TUNE stops here → USE_BEST_PARAMS


class MetaLearningState:
    """Phase labels (reference ``MetaLearningState``)."""

    INITIALIZE = "INITIALIZE"
    TUNE = "TUNE"
    USE_BEST_PARAMS = "USE_BEST_PARAMS"


@dataclasses.dataclass
class MetaLearningDesigner(core_lib.Designer):
    """Outer loop tuning inner-designer hyperparameters.

    Args:
      problem: the user problem.
      tuning_space: search space over the inner designer's hyperparameters.
      inner_factory: (problem, **hyperparams) -> Designer.
      meta_factory: factory for the meta problem (defaults to random search).
    """

    problem: base_study_config.ProblemStatement
    tuning_space: base_study_config.pc.SearchSpace = None  # type: ignore[assignment]
    inner_factory: Callable[..., core_lib.Designer] = None  # type: ignore[assignment]
    meta_factory: Optional[core_lib.DesignerFactory] = None
    config: MetaLearningConfig = dataclasses.field(default_factory=MetaLearningConfig)
    seed: Optional[int] = None

    def __post_init__(self):
        if self.tuning_space is None or self.inner_factory is None:
            raise ValueError("tuning_space and inner_factory are required.")
        meta_problem = base_study_config.ProblemStatement(
            search_space=self.tuning_space,
            metric_information=base_study_config.MetricsConfig(
                [
                    base_study_config.MetricInformation(
                        name=META_METRIC,
                        goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
                    )
                ]
            ),
        )
        if self.meta_factory is None:
            from vizier_tpu_torch.designers import random as random_designer

            self.meta_factory = lambda p, **kw: random_designer.RandomDesigner(
                p.search_space, seed=self.seed
            )
        self._meta = self.meta_factory(meta_problem)
        self._metrics = converters.MetricsEncoder(self.problem.metric_information)
        self._current_hparams: Optional[trial_.TrialSuggestion] = None
        self._inner: Optional[core_lib.Designer] = None
        self._round_trials = 0
        self._round_best = -np.inf
        self._prev_best = -np.inf
        self._meta_trial_id = 0
        self._all_completed: List[trial_.Trial] = []
        self._meta_trials: List[trial_.Trial] = []  # scored hyperparam configs
        self._locked_best = False

    @property
    def state(self) -> str:
        n = len(self._all_completed)
        if self._locked_best or n >= self.config.tuning_max_num_trials:
            return MetaLearningState.USE_BEST_PARAMS
        if n < self.config.tuning_min_num_trials:
            return MetaLearningState.INITIALIZE
        return MetaLearningState.TUNE

    def _default_hparams(self) -> Dict:
        """Center/default point of the tuning space (INITIALIZE phase)."""
        return {
            cfg.name: cfg.first_feasible_value()
            for cfg in self.tuning_space.parameters
        }

    def _best_hparams(self) -> Dict:
        """Hyperparams of the best-scoring completed meta trial."""
        if not self._meta_trials:
            return self._default_hparams()
        best = max(
            self._meta_trials,
            key=lambda t: t.final_measurement.metrics[META_METRIC].value,
        )
        return {k: v.value for k, v in best.parameters.items()}

    def _start_fixed(self, hparams: Dict) -> None:
        """Builds the inner designer on fixed hyperparams (no meta round)."""
        self._current_hparams = None
        self._inner = self.inner_factory(self.problem, **hparams)
        if self._all_completed:
            self._inner.update(
                core_lib.CompletedTrials(self._all_completed),
                core_lib.ActiveTrials(),
            )
        self._round_trials = 0

    def _start_round(self) -> None:
        (suggestion,) = self._meta.suggest(1)
        self._current_hparams = suggestion
        hparams = {k: v.value for k, v in suggestion.parameters.items()}
        self._inner = self.inner_factory(self.problem, **hparams)
        if self._all_completed:
            self._inner.update(
                core_lib.CompletedTrials(self._all_completed), core_lib.ActiveTrials()
            )
        self._prev_best = max(self._prev_best, self._round_best)
        self._round_trials = 0
        self._round_best = -np.inf

    def _finish_round(self) -> None:
        """Scores the finished config by its improvement over the incumbent."""
        if self._current_hparams is None:
            return  # fixed-hyperparam tenure (INITIALIZE/USE_BEST), unscored
        if np.isfinite(self._prev_best) and np.isfinite(self._round_best):
            reward = float(self._round_best - self._prev_best)
        elif np.isfinite(self._round_best):
            # First round: no incumbent to improve over — neutral reward.
            reward = 0.0
        else:
            reward = 0.0
        self._meta_trial_id += 1
        t = self._current_hparams.to_trial(self._meta_trial_id)
        t.complete(trial_.Measurement(metrics={META_METRIC: reward}))
        self._meta_trials.append(t)
        self._meta.update(core_lib.CompletedTrials([t]), core_lib.ActiveTrials())

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        self._all_completed.extend(completed.trials)
        for t in completed.trials:
            label = self._metrics.encode([t])[0, 0]
            if np.isfinite(label):
                self._round_best = max(self._round_best, float(label))
        self._round_trials += len(completed.trials)
        if self._inner is not None:
            self._inner.update(completed, all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        state = self.state
        if state == MetaLearningState.USE_BEST_PARAMS:
            if not self._locked_best:
                # Transition: score the in-flight config, lock in the winner.
                self._finish_round()
                self._locked_best = True
                self._start_fixed(self._best_hparams())
        elif state == MetaLearningState.INITIALIZE:
            if self._inner is None:
                self._start_fixed(self._default_hparams())
        elif self._inner is None or self._current_hparams is None:
            # Entering TUNE (fresh, or leaving INITIALIZE).
            self._start_round()
        elif self._round_trials >= self.config.tuning_interval:
            self._finish_round()
            self._start_round()
        return list(self._inner.suggest(count))
