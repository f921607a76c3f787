"""CMA-ES designer (continuous search spaces).

Copy of the JAX package's ``designers/cmaes.py`` (host numpy, the same
draws in the same order): the standard (mu/mu_w, lambda) CMA-ES — weighted
recombination, cumulative step-size adaptation, rank-one + rank-mu
covariance updates — over the [0, 1]^D model space.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


class _CMAState:
    def __init__(self, dim: int, sigma: float, rng: np.random.Generator):
        self.dim = dim
        self.mean = rng.uniform(0.3, 0.7, size=dim)
        self.sigma = sigma
        self.cov = np.eye(dim)
        self.p_sigma = np.zeros(dim)
        self.p_c = np.zeros(dim)
        self.generation = 0


@dataclasses.dataclass
class CMAESDesigner(core_lib.Designer):
    problem: base_study_config.ProblemStatement
    population_size: Optional[int] = None  # default 4 + 3 ln D
    sigma0: float = 0.3
    seed: Optional[int] = None

    def __post_init__(self):
        space = self.problem.search_space
        if space.is_conditional:
            raise ValueError("CMAESDesigner requires a flat search space.")
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        enc = self._converter.encoder
        if enc.num_categorical:
            raise ValueError("CMAESDesigner supports continuous parameters only.")
        self._dim = enc.num_continuous
        self._rng = np.random.default_rng(self.seed)
        self._lambda = self.population_size or (4 + int(3 * np.log(self._dim)))
        self._state = _CMAState(self._dim, self.sigma0, self._rng)
        self._setup_weights()
        self._told: List[tuple] = []  # (genome, objective) awaiting a generation

    def _setup_weights(self):
        lam, dim = self._lambda, self._dim
        mu = lam // 2
        raw = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self._weights = raw / raw.sum()
        self._mu = mu
        self._mu_eff = 1.0 / np.sum(self._weights**2)
        self._c_sigma = (self._mu_eff + 2) / (dim + self._mu_eff + 5)
        self._d_sigma = (
            1
            + 2 * max(0.0, np.sqrt((self._mu_eff - 1) / (dim + 1)) - 1)
            + self._c_sigma
        )
        self._c_c = (4 + self._mu_eff / dim) / (dim + 4 + 2 * self._mu_eff / dim)
        self._c_1 = 2.0 / ((dim + 1.3) ** 2 + self._mu_eff)
        self._c_mu = min(
            1 - self._c_1,
            2 * (self._mu_eff - 2 + 1 / self._mu_eff) / ((dim + 2) ** 2 + self._mu_eff),
        )
        self._chi_n = np.sqrt(dim) * (1 - 1 / (4 * dim) + 1 / (21 * dim**2))

    # -- Designer ----------------------------------------------------------

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        trials = list(completed.trials)
        if not trials:
            return
        cont, _ = self._converter.encoder.encode(trials)
        objectives = self._converter.metrics.encode(trials)[:, 0]  # MAXIMIZE
        for x, y in zip(cont, objectives):
            if np.isfinite(y):
                self._told.append((x, y))
        # One CMA generation per lambda evaluations.
        while len(self._told) >= self._lambda:
            batch = self._told[: self._lambda]
            self._told = self._told[self._lambda :]
            self._tell_generation(batch)

    def _tell_generation(self, batch) -> None:
        s = self._state
        xs = np.stack([x for x, _ in batch])
        ys = np.asarray([y for _, y in batch])
        order = np.argsort(-ys)  # best (max) first
        elite = xs[order[: self._mu]]

        old_mean = s.mean.copy()
        sigma_old = s.sigma  # sampling-time sigma: scales y_w AND artmp below
        s.mean = self._weights @ elite
        y_w = (s.mean - old_mean) / sigma_old

        # Step-size path (CSA).
        cov_inv_sqrt = self._cov_inv_sqrt(s.cov)
        s.p_sigma = (1 - self._c_sigma) * s.p_sigma + np.sqrt(
            self._c_sigma * (2 - self._c_sigma) * self._mu_eff
        ) * (cov_inv_sqrt @ y_w)
        s.sigma = s.sigma * np.exp(
            (self._c_sigma / self._d_sigma)
            * (np.linalg.norm(s.p_sigma) / self._chi_n - 1)
        )
        s.sigma = float(np.clip(s.sigma, 1e-8, 1.0))

        # Covariance paths and update.
        h_sigma = float(
            np.linalg.norm(s.p_sigma)
            / np.sqrt(1 - (1 - self._c_sigma) ** (2 * (s.generation + 1)))
            < (1.4 + 2 / (self._dim + 1)) * self._chi_n
        )
        s.p_c = (1 - self._c_c) * s.p_c + h_sigma * np.sqrt(
            self._c_c * (2 - self._c_c) * self._mu_eff
        ) * y_w
        artmp = (elite - old_mean) / sigma_old
        rank_mu = sum(
            w * np.outer(a, a) for w, a in zip(self._weights, artmp)
        )
        s.cov = (
            (1 - self._c_1 - self._c_mu) * s.cov
            + self._c_1
            * (np.outer(s.p_c, s.p_c) + (1 - h_sigma) * self._c_c * (2 - self._c_c) * s.cov)
            + self._c_mu * rank_mu
        )
        s.cov = (s.cov + s.cov.T) / 2.0  # keep symmetric
        s.generation += 1

    @staticmethod
    def _cov_inv_sqrt(cov: np.ndarray) -> np.ndarray:
        vals, vecs = np.linalg.eigh(cov)
        vals = np.maximum(vals, 1e-12)
        return vecs @ np.diag(vals**-0.5) @ vecs.T

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        s = self._state
        vals, vecs = np.linalg.eigh(s.cov)
        sqrt_cov = vecs @ np.diag(np.sqrt(np.maximum(vals, 1e-12))) @ vecs.T
        out = []
        for _ in range(count):
            z = self._rng.standard_normal(self._dim)
            x = np.clip(s.mean + s.sigma * (sqrt_cov @ z), 0.0, 1.0)
            params = self._converter.to_parameters(
                x[None, :], np.zeros((1, 0), dtype=np.int32)
            )[0]
            out.append(trial_.TrialSuggestion(parameters=params))
        return out
