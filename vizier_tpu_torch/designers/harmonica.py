"""Harmonica: staged boolean Fourier-basis regression designer.

Copy of the JAX package's ``designers/harmonica.py`` (host numpy, the same
draws in the same order; Hazan et al., "Hyperparameter Optimization: A
Spectral Approach", 2017): each *stage* fits a sparse (lasso) low-degree
Fourier expansion over {-1,+1} features of the samples drawn in that stage,
identifies the most influential variables, fixes them to their best
polarity, and restarts sampling in the restricted subcube — fixed sets
accumulate across stages, shrinking the search space geometrically.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.designers.bocs import _binary_dim
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class HarmonicaDesigner(core_lib.Designer):
    problem: base_study_config.ProblemStatement
    degree: int = 2
    num_top_monomials: int = 5
    # Staged restarts: after `samples_per_stage` observations, fix
    # `num_fixed_per_stage` more variables and restart in the subcube.
    num_stages: int = 3
    samples_per_stage: Optional[int] = None  # default: max(8, dim)
    num_fixed_per_stage: int = 3
    lasso_alpha: float = 0.01
    seed: Optional[int] = None

    def __post_init__(self):
        self._dim = _binary_dim(self.problem.search_space)
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        self._rng = np.random.default_rng(self.seed)
        self._monomials: List[Tuple[int, ...]] = []
        for deg in range(1, self.degree + 1):
            self._monomials.extend(itertools.combinations(range(self._dim), deg))
        if self.samples_per_stage is None:
            self.samples_per_stage = max(8, self._dim)
        self._fixed: Dict[int, int] = {}  # accumulated across stages
        self._stage = 0
        self._stage_x: List[np.ndarray] = []
        self._stage_y: List[float] = []

    def _signs(self, bits: np.ndarray) -> np.ndarray:
        return 2.0 * np.atleast_2d(bits) - 1.0  # {0,1} -> {-1,+1}

    def _phi(self, bits: np.ndarray) -> np.ndarray:
        s = self._signs(bits)
        cols = [np.prod(s[:, list(mono)], axis=1) for mono in self._monomials]
        return np.stack(cols, axis=1) if cols else np.zeros((s.shape[0], 0))

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        trials = list(completed.trials)
        if not trials:
            return
        _, cat = self._converter.encoder.encode(trials)
        labels = self._converter.metrics.encode(trials)[:, 0]
        for row, y in zip(cat, labels):
            if np.isfinite(y):
                self._stage_x.append(row.astype(np.float64))
                self._stage_y.append(float(y))

    def _fit_coefficients(self, phi: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Sparse Fourier coefficients (lasso; ridge only without sklearn)."""
        try:
            from sklearn import linear_model
        except ImportError:
            d = phi.shape[1]
            return np.linalg.solve(phi.T @ phi + 1e-2 * np.eye(d), phi.T @ y)
        model = linear_model.Lasso(
            alpha=self.lasso_alpha, fit_intercept=False, max_iter=2000
        )
        model.fit(phi, y)  # genuine fit errors must surface, not degrade
        return np.asarray(model.coef_, dtype=np.float64)

    def _advance_stage(self) -> None:
        """Fits this stage's samples; fixes the top free variables."""
        phi = self._phi(np.stack(self._stage_x))
        y = np.asarray(self._stage_y)
        y = y - y.mean()
        coef = self._fit_coefficients(phi, y)
        top = np.argsort(-np.abs(coef))[: self.num_top_monomials]
        # Influence of each FREE variable: sum |coef| over monomials using it.
        influence = np.zeros(self._dim)
        for idx in top:
            for var in self._monomials[idx]:
                if var not in self._fixed:
                    influence[var] += abs(coef[idx])
        candidates = [
            int(v) for v in np.argsort(-influence) if influence[v] > 0
        ][: self.num_fixed_per_stage]
        if candidates:
            # Best polarity: evaluate the surrogate with the candidates set to
            # each assignment and the remaining free vars sampled uniformly.
            probes = self._rng.integers(0, 2, size=(64, self._dim)).astype(
                np.float64
            )
            for var, bit in self._fixed.items():
                probes[:, var] = bit
            best_assign, best_val = None, -np.inf
            for assign in itertools.product([0.0, 1.0], repeat=len(candidates)):
                probes_a = probes.copy()
                for var, bit in zip(candidates, assign):
                    probes_a[:, var] = bit
                val = float(np.mean(self._phi(probes_a) @ coef))
                if val > best_val:
                    best_assign, best_val = assign, val
            for var, bit in zip(candidates, best_assign):
                self._fixed[var] = int(bit)
        # Restart: next stage samples fresh in the restricted subcube.
        self._stage += 1
        self._stage_x, self._stage_y = [], []

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        if (
            self._stage < self.num_stages
            and len(self._stage_x) >= self.samples_per_stage
            and len(self._fixed) < self._dim
        ):
            self._advance_stage()
        out = []
        for _ in range(count):
            bits = self._rng.integers(0, 2, size=self._dim)
            for var, bit in self._fixed.items():
                bits[var] = bit
            params = self._converter.to_parameters(
                np.zeros((1, 0)), np.asarray(bits, dtype=np.int32)[None, :]
            )[0]
            out.append(trial_.TrialSuggestion(parameters=params))
        return out
