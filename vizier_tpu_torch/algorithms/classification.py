"""Feasibility classifiers and trial-curve regression.

Copy of the JAX package's ``algorithms/classification.py`` (host numpy):
probabilistic feasibility models over trial features (to down-weight
acquisition in regions that keep failing) and power-law regression over a
trial's intermediate measurements (for stopping and extrapolation). The
feasibility classifier needs scikit-learn, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class FeasibilityClassifier:
    """P(feasible | x) from completed trials (sklearn GP/logistic backend)."""

    problem: base_study_config.ProblemStatement
    kind: str = "gp"  # 'gp' | 'logistic'
    seed: int = 0

    def __post_init__(self):
        self._converter = converters.TrialToArrayConverter.from_study_config(
            self.problem
        )
        self._model = None
        self._constant: Optional[float] = None

    def fit(self, trials: Sequence[trial_.Trial]) -> "FeasibilityClassifier":
        xs = self._converter.to_features(trials)
        ys = np.asarray([0.0 if t.infeasible else 1.0 for t in trials])
        if len(np.unique(ys)) < 2:
            # All-feasible or all-infeasible: constant predictor.
            self._constant = float(ys[0]) if len(ys) else 1.0
            self._model = None
            return self
        self._constant = None
        try:
            import sklearn  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "FeasibilityClassifier needs scikit-learn."
            ) from e
        if self.kind == "gp":
            from sklearn.gaussian_process import GaussianProcessClassifier
            from sklearn.gaussian_process.kernels import Matern

            self._model = GaussianProcessClassifier(
                kernel=Matern(nu=2.5), random_state=self.seed
            ).fit(xs, ys)
        elif self.kind == "logistic":
            from sklearn.linear_model import LogisticRegression

            # Weak regularization: features live in [0, 1], so the default
            # C=1 shrinks boundaries far too much.
            self._model = LogisticRegression(C=100.0, random_state=self.seed).fit(
                xs, ys
            )
        else:
            raise ValueError(f"Unknown classifier kind {self.kind!r}.")
        return self

    def predict_proba_feasible(
        self, suggestions: Sequence[trial_.TrialSuggestion]
    ) -> np.ndarray:
        trials = [s.to_trial(i + 1) for i, s in enumerate(suggestions)]
        if self._constant is not None or self._model is None:
            return np.full(len(trials), self._constant if self._constant is not None else 1.0)
        xs = self._converter.to_features(trials)
        proba = self._model.predict_proba(xs)
        feasible_col = list(self._model.classes_).index(1.0)
        return proba[:, feasible_col]


@dataclasses.dataclass
class TrialCurveRegressor:
    """Power-law extrapolation of a trial's measurement curve.

    Fits ``y(s) ≈ a - b·s^{-c}`` (the classic learning-curve family) by
    least squares over a small grid of exponents; ``predict(s)`` gives the
    extrapolated objective — the regression backbone for curve-based
    stopping decisions.
    """

    metric_name: str
    use_steps: bool = True

    def fit(self, trial: trial_.Trial) -> Optional["TrialCurveRegressor"]:
        xs, ys = [], []
        for m in trial.measurements:
            if self.metric_name in m.metrics:
                pos = m.steps if self.use_steps else m.elapsed_secs
                if pos > 0:
                    xs.append(pos)
                    ys.append(m.metrics[self.metric_name].value)
        if len(xs) < 3:
            return None
        xs_arr, ys_arr = np.asarray(xs, dtype=np.float64), np.asarray(ys)
        best = None
        for c in (0.25, 0.5, 1.0, 2.0):
            basis = np.stack([np.ones_like(xs_arr), -(xs_arr**-c)], axis=1)
            coef, residuals, _, _ = np.linalg.lstsq(basis, ys_arr, rcond=None)
            err = (
                float(residuals[0])
                if len(residuals)
                else float(np.sum((basis @ coef - ys_arr) ** 2))
            )
            if best is None or err < best[0]:
                best = (err, c, coef)
        _, self._c, (self._a, self._b) = best
        return self

    def predict(self, position: float) -> float:
        return float(self._a - self._b * position**-self._c)

    @property
    def asymptote(self) -> float:
        """The predicted converged value (position → ∞)."""
        return float(self._a)
