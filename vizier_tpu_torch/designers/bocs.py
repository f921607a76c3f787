"""BOCS: Bayesian Optimization of Combinatorial Structures.

Copy of the JAX package's ``designers/bocs.py`` (host numpy, the same draws
in the same order; Baptista & Poloczek 2018): a second-order Bayesian linear
surrogate over binary features with a Thompson-sampled coefficient draw,
maximized over bit vectors.

Two surrogates (``surrogate=``):
- ``"horseshoe"`` (default): sparse Bayesian regression with the horseshoe
  prior, Gibbs-sampled via the Makalic–Schmidt (2015) auxiliary-variable
  hierarchy — second-order interaction coefficients are mostly near-zero in
  real combinatorial objectives, and the sparse prior recovers that
  structure from few samples.
- ``"ridge"``: a Bayesian ridge (cheap).

Two acquisition optimizers (``acquisition_optimizer=``):
- ``"sa"``: simulated annealing over bit flips (default).
- ``"sdp"``: spectral relaxation + randomized hyperplane rounding — a
  solver-free semidefinite rounding (the Goemans–Williamson rounding idea,
  using the relaxation's top eigenvectors instead of the exact SDP factor).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


def _binary_dim(space: pc.SearchSpace) -> int:
    total = 0
    for p in space.parameters:
        if p.type == pc.ParameterType.CATEGORICAL and p.num_feasible_values == 2:
            total += 1
        else:
            raise ValueError(
                "BOCSDesigner requires all parameters to be binary "
                f"(2-value categorical/bool); got {p.name} ({p.type})."
            )
    return total


def _horseshoe_gibbs(
    phi: np.ndarray,
    y: np.ndarray,
    rng: np.random.Generator,
    num_samples: int = 50,
) -> np.ndarray:
    """One horseshoe-posterior coefficient draw (last sample of a Gibbs run).

    Makalic & Schmidt (2015) auxiliary hierarchy: β|A ~ N(A⁻¹Φ'y, σ²A⁻¹)
    with A = Φ'Φ + diag(1/(τ²λ²)); λ²,ν,τ²,ξ inverse-gamma steps. The y mean
    is absorbed host-side so the intercept needs no shrinkage exception.
    """
    n, p = phi.shape
    mu_y = float(np.mean(y))
    y = y - mu_y

    def inv_gamma(shape, scale):
        return scale / rng.gamma(shape, 1.0, size=np.shape(scale))

    sigma2 = 1.0
    lambda2 = rng.uniform(size=p) + 1e-3
    tau2, xi = 1.0, 1.0
    nu = np.ones(p)
    ptp = phi.T @ phi
    beta = np.zeros(p)
    for _ in range(num_samples):
        # β | rest
        a = ptp + np.diag(1.0 / np.maximum(tau2 * lambda2, 1e-12))
        chol = np.linalg.cholesky(a + 1e-10 * np.eye(p))
        mean = np.linalg.solve(chol.T, np.linalg.solve(chol, phi.T @ y))
        z = rng.standard_normal(p)
        beta = mean + np.sqrt(sigma2) * np.linalg.solve(chol.T, z)
        # σ² | rest
        resid = y - phi @ beta
        shrink = np.sum(beta**2 / np.maximum(tau2 * lambda2, 1e-12))
        sigma2 = float(
            inv_gamma((n + p) / 2.0, (resid @ resid + shrink) / 2.0 + 1e-12)
        )
        # λ², ν | rest
        lambda2 = inv_gamma(
            1.0, 1.0 / nu + beta**2 / np.maximum(2.0 * tau2 * sigma2, 1e-12)
        )
        nu = inv_gamma(1.0, 1.0 + 1.0 / np.maximum(lambda2, 1e-12))
        # τ², ξ | rest
        tau2 = float(
            inv_gamma(
                (p + 1) / 2.0,
                1.0 / xi
                + np.sum(beta**2 / np.maximum(lambda2, 1e-12))
                / max(2.0 * sigma2, 1e-12),
            )
        )
        xi = float(inv_gamma(1.0, 1.0 + 1.0 / max(tau2, 1e-12)))
    out = beta.copy()
    # Re-inject the absorbed mean into the intercept coefficient (column 0
    # of phi is the all-ones feature).
    out[0] += mu_y
    return out


@dataclasses.dataclass
class BOCSDesigner(core_lib.Designer):
    problem: base_study_config.ProblemStatement
    num_restarts: int = 4
    anneal_steps: int = 200
    regularization: float = 1.0
    surrogate: str = "horseshoe"  # 'horseshoe' | 'ridge'
    acquisition_optimizer: str = "sa"  # 'sa' | 'sdp'
    gibbs_samples: int = 50
    seed: Optional[int] = None

    def __post_init__(self):
        self._dim = _binary_dim(self.problem.search_space)
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        self._rng = np.random.default_rng(self.seed)
        self._pairs = list(itertools.combinations(range(self._dim), 2))
        self._x: List[np.ndarray] = []
        self._y: List[float] = []

    # -- features: [1, x, x_i x_j] -----------------------------------------

    def _phi(self, bits: np.ndarray) -> np.ndarray:
        bits = np.atleast_2d(bits)
        inter = np.stack(
            [bits[:, i] * bits[:, j] for i, j in self._pairs], axis=1
        ) if self._pairs else np.zeros((bits.shape[0], 0))
        return np.concatenate(
            [np.ones((bits.shape[0], 1)), bits, inter], axis=1
        )

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
                self._x.append(row.astype(np.float64))
                self._y.append(float(y))

    def _sample_coefficients(self) -> np.ndarray:
        """Thompson draw: horseshoe Gibbs sample or Bayesian-ridge draw."""
        phi = self._phi(np.stack(self._x))
        y = np.asarray(self._y)
        if self.surrogate == "horseshoe":
            return _horseshoe_gibbs(phi, y, self._rng, self.gibbs_samples)
        if self.surrogate != "ridge":
            raise ValueError(f"Unknown surrogate {self.surrogate!r}.")
        d = phi.shape[1]
        precision = self.regularization * np.eye(d) + phi.T @ phi
        cov = np.linalg.inv(precision)
        mean = cov @ phi.T @ y
        noise = np.var(y - phi @ mean) + 1e-6
        chol = np.linalg.cholesky(noise * cov + 1e-10 * np.eye(d))
        return mean + chol @ self._rng.standard_normal(d)

    def _coef_to_quadratic(self, coef: np.ndarray):
        """Splits φ-space coefficients into (linear b [d], pair matrix Q)."""
        b = coef[1 : 1 + self._dim]
        q = np.zeros((self._dim, self._dim))
        for k, (i, j) in enumerate(self._pairs):
            q[i, j] = q[j, i] = coef[1 + self._dim + k] / 2.0
        return b, q

    def _sdp_round(self, coef: np.ndarray, num_rounds: int = 64) -> np.ndarray:
        """Spectral relaxation + randomized hyperplane rounding.

        Maximize b'x + x'Qx over x∈{0,1}^d via the ±1 substitution
        s = 2x − 1, relaxing the augmented quadratic form [[M, c/2],[c'/2, 0]]
        to its top eigenvectors and rounding random Gaussian combinations by
        sign — the Goemans–Williamson rounding step without an SDP solver.
        """
        b, q = self._coef_to_quadratic(coef)
        # f(x) over s: x = (1+s)/2 ⇒ quadratic M = Q/4, linear c = b/2 + Q·1/2.
        m = q / 4.0
        c = b / 2.0 + q.sum(axis=1) / 4.0
        aug = np.zeros((self._dim + 1, self._dim + 1))
        aug[: self._dim, : self._dim] = m
        aug[: self._dim, -1] = c / 2.0
        aug[-1, : self._dim] = c / 2.0
        w, v = np.linalg.eigh(aug)
        k = min(8, len(w))
        top = v[:, np.argsort(w)[-k:]] * np.sqrt(np.maximum(w[np.argsort(w)[-k:]], 0.0))
        best_bits, best_val = None, -np.inf
        for _ in range(num_rounds):
            r = self._rng.standard_normal(k)
            s = np.sign(top @ r)
            s[s == 0] = 1.0
            s = s[: self._dim] * s[-1]  # gauge-fix the homogenizing variable
            bits = (s + 1.0) / 2.0
            val = float((self._phi(bits) @ coef)[0])
            if val > best_val:
                best_bits, best_val = bits, val
        return best_bits

    def _anneal(self, coef: np.ndarray) -> np.ndarray:
        best_bits, best_val = None, -np.inf
        for _ in range(self.num_restarts):
            bits = self._rng.integers(0, 2, size=self._dim).astype(np.float64)
            val = float((self._phi(bits) @ coef)[0])
            temp = 1.0
            for step in range(self.anneal_steps):
                flip = self._rng.integers(0, self._dim)
                cand = bits.copy()
                cand[flip] = 1.0 - cand[flip]
                cand_val = float((self._phi(cand) @ coef)[0])
                if cand_val > val or self._rng.uniform() < np.exp(
                    (cand_val - val) / max(temp, 1e-8)
                ):
                    bits, val = cand, cand_val
                temp *= 0.97
            if val > best_val:
                best_bits, best_val = bits, val
        return best_bits

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        out = []
        for _ in range(count):
            if len(self._x) < 2:
                bits = self._rng.integers(0, 2, size=self._dim)
            else:
                coef = self._sample_coefficients()
                if self.acquisition_optimizer == "sdp":
                    bits = self._sdp_round(coef)
                elif self.acquisition_optimizer == "sa":
                    bits = self._anneal(coef)
                else:
                    raise ValueError(
                        f"Unknown acquisition_optimizer "
                        f"{self.acquisition_optimizer!r}."
                    )
            params = self._converter.to_parameters(
                np.zeros((1, 0)), np.asarray(bits, dtype=np.int32)[None, :]
            )[0]
            out.append(trial_.TrialSuggestion(parameters=params))
        return out
