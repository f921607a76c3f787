"""Combinatorial benchmark experimenters (COMBO suite + L1-categorical).

Parity with the reference's combinatorial objectives
(``combo_experimenter.py:34,100,185,273`` and
``l1_categorical_experimenter.py:28``; problems from Oh et al., "Combinatorial
Bayesian Optimization using the Graph Cartesian Product", NeurIPS 2019, and
Baptista & Poloczek, "Bayesian Optimization of Combinatorial Structures",
ICML 2018). These are the standard data-free combinatorial BO testbeds that
exercise BOCS / categorical-kernel designers.

Implementation is batched numpy throughout: the Ising spin enumeration is a
single einsum over all 2^16 configurations instead of a python loop, and the
KLD pairwise sum is two vectorized edge contractions. Spins are indexed
row-major ((r, c) -> r*W + c) consistently for non-square grids.

Copy of the JAX package's ``benchmarks/experimenters/combinatorial.py``, on
the port's data model: the same seed and trials give the same floats.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

Interaction = Tuple[np.ndarray, np.ndarray]  # (horizontal [H, W-1], vertical [H-1, W])


# ---------------------------------------------------------------------------
# Ising grid math (batched).
# ---------------------------------------------------------------------------


def random_ising_interaction(
    grid_h: int, grid_w: int, rng: np.random.Generator
) -> Interaction:
    """Random ±[0.05, 5] couplings on the edges of an H×W grid."""

    def draw(n: int) -> np.ndarray:
        sign = rng.integers(0, 2, n) * 2 - 1
        return sign * (rng.uniform(size=n) * (5.0 - 0.05) + 0.05)

    horizontal = draw(grid_h * (grid_w - 1)).reshape(grid_h, grid_w - 1)
    vertical = draw((grid_h - 1) * grid_w).reshape(grid_h - 1, grid_w)
    return horizontal, vertical


def _all_spin_grids(grid_h: int, grid_w: int) -> np.ndarray:
    """[2^n, H, W] array of every ±1 spin configuration (row-major bits)."""
    n = grid_h * grid_w
    if n > 20:
        raise ValueError(f"Exact Ising enumeration infeasible for {n} spins.")
    codes = np.arange(1 << n, dtype=np.uint32)
    bits = (codes[:, None] >> np.arange(n, dtype=np.uint32)[None, :]) & 1
    return (bits.astype(np.int8) * 2 - 1).reshape(-1, grid_h, grid_w)


def _interaction_energies(spins: np.ndarray, interaction: Interaction) -> np.ndarray:
    """[C] log interaction energy 2·Σ J_ij s_i s_j for every configuration."""
    h, v = interaction
    e_h = np.einsum("chw,hw->c", (spins[:, :, :-1] * spins[:, :, 1:]).astype(np.float64), h)
    e_v = np.einsum("chw,hw->c", (spins[:, :-1, :] * spins[:, 1:, :]).astype(np.float64), v)
    return 2.0 * (e_h + e_v)


def log_partition(interaction: Interaction, grid_shape: Tuple[int, int]) -> float:
    """log Σ exp(energy) over all spin configurations (stable logsumexp)."""
    energies = _interaction_energies(_all_spin_grids(*grid_shape), interaction)
    peak = np.max(energies)
    return float(peak + np.log(np.sum(np.exp(energies - peak))))


def spin_covariance(
    interaction: Interaction, grid_shape: Tuple[int, int]
) -> Tuple[np.ndarray, float]:
    """(⟨s_i s_j⟩ covariance [n, n], log partition) under the Gibbs density."""
    spins = _all_spin_grids(*grid_shape)
    energies = _interaction_energies(spins, interaction)
    peak = np.max(energies)
    density = np.exp(energies - peak)
    log_z = float(peak + np.log(density.sum()))
    density = density / density.sum()
    flat = spins.reshape(spins.shape[0], -1).astype(np.float64)
    covariance = flat.T @ (flat * density[:, None])
    return covariance, log_z


def ising_kl_divergence(
    interaction_original: Interaction,
    interaction_new: Interaction,
    covariance: np.ndarray,
    log_z_original: float,
    log_z_new: float,
    grid_shape: Tuple[int, int],
) -> float:
    """KL(p_original || p_new) between two Ising Gibbs distributions.

    KL = 2·Σ_edges (J_orig − J_new)·⟨s_i s_j⟩ + log Z_new − log Z_orig,
    with both edge families contracted in one vectorized pass.
    """
    grid_h, grid_w = grid_shape
    diff_h = interaction_original[0] - interaction_new[0]  # [H, W-1]
    diff_v = interaction_original[1] - interaction_new[1]  # [H-1, W]
    idx = np.arange(grid_h * grid_w).reshape(grid_h, grid_w)
    h_cov = covariance[idx[:, :-1].ravel(), idx[:, 1:].ravel()].reshape(diff_h.shape)
    v_cov = covariance[idx[:-1, :].ravel(), idx[1:, :].ravel()].reshape(diff_v.shape)
    kld = np.sum(diff_h * h_cov) + np.sum(diff_v * v_cov)
    return float(2.0 * kld + log_z_new - log_z_original)


# ---------------------------------------------------------------------------
# Experimenters.
# ---------------------------------------------------------------------------


def _bool_problem(n: int, metric: str = "main_objective") -> base_study_config.ProblemStatement:
    problem = base_study_config.ProblemStatement()
    for i in range(n):
        problem.search_space.root.add_bool_param(f"x_{i}")
    problem.metric_information.append(
        base_study_config.MetricInformation(
            name=metric, goal=base_study_config.ObjectiveMetricGoal.MINIMIZE
        )
    )
    return problem


def _bool_vector(t: trial_.Trial, n: int) -> np.ndarray:
    return np.array(
        [str(t.parameters[f"x_{i}"].value) == "True" for i in range(n)], dtype=float
    )


class IsingExperimenter(base.Experimenter):
    """Ising sparsification: drop couplings, pay KL divergence + L1 cost.

    Each boolean keeps (True) or removes (False) one grid edge; the score is
    KL(original ‖ sparsified) + λ·#kept — MINIMIZE finds the cheapest
    faithful sparsification (reference ``IsingExperimenter``).
    """

    def __init__(
        self,
        lamda: float = 1e-2,
        grid_h: int = 4,
        grid_w: int = 4,
        seed: Optional[int] = None,
    ):
        self._lamda = lamda
        self._grid = (grid_h, grid_w)
        self._n_h = grid_h * (grid_w - 1)
        self._n_edges = self._n_h + (grid_h - 1) * grid_w
        rng = np.random.default_rng(seed)
        self._interaction = random_ising_interaction(grid_h, grid_w, rng)
        self._covariance, self._log_z = spin_covariance(self._interaction, self._grid)
        self._problem = _bool_problem(self._n_edges)

    def _split(self, x: np.ndarray) -> Interaction:
        grid_h, grid_w = self._grid
        return (
            x[: self._n_h].reshape(grid_h, grid_w - 1),
            x[self._n_h :].reshape(grid_h - 1, grid_w),
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        metric = self._problem.metric_information.item().name
        for t in suggestions:
            x = _bool_vector(t, self._n_edges)
            keep_h, keep_v = self._split(x)
            sparsified = (
                keep_h * self._interaction[0],
                keep_v * self._interaction[1],
            )
            kld = ising_kl_divergence(
                self._interaction,
                sparsified,
                self._covariance,
                self._log_z,
                log_partition(sparsified, self._grid),
                self._grid,
            )
            t.complete(
                trial_.Measurement(
                    metrics={metric: kld + self._lamda * float(x.sum())}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


class ContaminationExperimenter(base.Experimenter):
    """Contamination control over a 25-stage food chain (reference parity).

    Each boolean applies a costly intervention at one stage; contamination
    propagates via random rates; the score is intervention cost minus the
    chance-constraint margin, + λ·#interventions. Monte-Carlo dynamics are
    drawn once at construction (one seeded Generator).
    """

    def __init__(
        self,
        lamda: float = 1e-2,
        n_stages: int = 25,
        seed: Optional[int] = None,
        n_simulations: int = 100,
    ):
        self._lamda = lamda
        self._n = n_stages
        self._sims = n_simulations
        rng = np.random.default_rng(seed)
        self._init_z = rng.beta(1.0, 30.0, size=n_simulations)
        self._lambdas = rng.beta(1.0, 17.0 / 3.0, size=(n_stages, n_simulations))
        self._gammas = rng.beta(1.0, 3.0 / 7.0, size=(n_stages, n_simulations))
        self._problem = _bool_problem(n_stages)

    def _score(self, x: np.ndarray, u: float = 0.1, eps: float = 0.05) -> float:
        z = np.empty((self._n, self._sims))
        prev = self._init_z
        for i in range(self._n):
            z[i] = self._lambdas[i] * (1.0 - x[i]) * (1.0 - prev) + (
                1.0 - self._gammas[i] * x[i]
            ) * prev
            prev = z[i]
        constraints = np.mean(z < u, axis=1) - (1.0 - eps)
        return float(np.sum(x - constraints))

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        metric = self._problem.metric_information.item().name
        for t in suggestions:
            x = _bool_vector(t, self._n)
            t.complete(
                trial_.Measurement(
                    metrics={metric: self._score(x) + self._lamda * float(x.sum())}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


class CentroidExperimenter(base.Experimenter):
    """Ising centroid: pick each edge's coupling from one of K models.

    Categorical generalization of sparsification (reference
    ``CentroidExperimenter``): minimize the average KL divergence from the K
    source models to the mixed model.
    """

    def __init__(
        self,
        n_choice: int = 3,
        grid: Tuple[int, int] = (4, 4),
        n_models: int = 3,
        seed: Optional[int] = None,
    ):
        self._n_choice = n_choice
        self._grid = grid
        grid_h, grid_w = grid
        self._n_h = grid_h * (grid_w - 1)
        self._n_edges = self._n_h + (grid_h - 1) * grid_w
        rng = np.random.default_rng(seed)
        self._models: List[Interaction] = []
        self._covs: List[np.ndarray] = []
        self._log_zs: List[float] = []
        for _ in range(n_models):
            inter = random_ising_interaction(grid_h, grid_w, rng)
            cov, log_z = spin_covariance(inter, grid)
            self._models.append(inter)
            self._covs.append(cov)
            self._log_zs.append(log_z)
        # Flat per-edge coupling table [K, n_edges] for vectorized selection.
        self._edge_table = np.stack(
            [np.concatenate([m[0].ravel(), m[1].ravel()]) for m in self._models]
        )
        self._problem = base_study_config.ProblemStatement()
        for i in range(self._n_edges):
            self._problem.search_space.root.add_categorical_param(
                f"x_{i}", [str(j) for j in range(n_choice)]
            )
        self._problem.metric_information.append(
            base_study_config.MetricInformation(
                name="main_objective",
                goal=base_study_config.ObjectiveMetricGoal.MINIMIZE,
            )
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        grid_h, grid_w = self._grid
        for t in suggestions:
            choice = np.array(
                [int(str(t.parameters[f"x_{i}"].value)) for i in range(self._n_edges)]
            )
            mixed_flat = self._edge_table[
                np.minimum(choice, len(self._models) - 1), np.arange(self._n_edges)
            ]
            mixed = (
                mixed_flat[: self._n_h].reshape(grid_h, grid_w - 1),
                mixed_flat[self._n_h :].reshape(grid_h - 1, grid_w),
            )
            log_z_mixed = log_partition(mixed, self._grid)
            klds = [
                ising_kl_divergence(
                    self._models[i], mixed, self._covs[i],
                    self._log_zs[i], log_z_mixed, self._grid,
                )
                for i in range(len(self._models))
            ]
            t.complete(
                trial_.Measurement(
                    metrics={"main_objective": float(np.mean(klds))}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


class PestControlExperimenter(base.Experimenter):
    """Pest control: choose one of K pesticides (or none) at each stage.

    Sequential dynamics with pesticide-specific control rates, tolerance
    development, and bulk discounts (reference ``PestControlExperimenter``).
    Random rates come from one seeded Generator (drawn per stage, unlike the
    reference's re-seeded identical draws — same benchmark family, cleaner
    stochasticity).
    """

    def __init__(
        self,
        n_choice: int = 5,
        n_stages: int = 25,
        seed: Optional[int] = None,
        n_simulations: int = 100,
    ):
        self._n_choice = n_choice
        self._n = n_stages
        self._sims = n_simulations
        self._seed = seed
        self._problem = base_study_config.ProblemStatement()
        for i in range(n_stages):
            self._problem.search_space.root.add_categorical_param(
                f"x_{i}", [str(j) for j in range(n_choice)]
            )
        self._problem.metric_information.append(
            base_study_config.MetricInformation(
                name="main_objective",
                goal=base_study_config.ObjectiveMetricGoal.MINIMIZE,
            )
        )

    def _score(self, x: np.ndarray) -> float:
        u = 0.1
        rng = np.random.default_rng(self._seed)
        control_price = {1: 1.0, 2: 0.8, 3: 0.7, 4: 0.5}
        max_discount = {1: 0.2, 2: 0.3, 3: 0.3, 4: 0.0}
        tolerance_rate = {1: 1.0 / 7, 2: 2.5 / 7, 3: 2.0 / 7, 4: 0.5 / 7}
        control_beta: Dict[int, float] = {1: 2.0 / 7, 2: 3.0 / 7, 3: 3.0 / 7, 4: 5.0 / 7}
        pest = rng.beta(1.0, 30.0, size=self._sims)
        price_sum = 0.0
        above = 0.0
        for i in range(self._n):
            spread = rng.beta(1.0, 17.0 / 3.0, size=self._sims)
            k = int(x[i])
            if k > 0:
                control = rng.beta(1.0, control_beta[k], size=self._sims)
                nxt = (1.0 - control) * pest
                # Pests develop tolerance to a pesticide the more it is used.
                control_beta[k] += tolerance_rate[k] / float(self._n)
                # Bulk discount grows with how often this pesticide appears.
                price = control_price[k] * (
                    1.0 - max_discount[k] / float(self._n) * float(np.sum(x == k))
                )
            else:
                nxt = spread * (1.0 - pest) + pest
                price = 0.0
            price_sum += price
            above += float(np.mean(pest > u))
            pest = nxt
        return price_sum + above

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            x = np.array(
                [int(str(t.parameters[f"x_{i}"].value)) for i in range(self._n)]
            )
            t.complete(
                trial_.Measurement(metrics={"main_objective": self._score(x)})
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


class L1CategoricalExperimenter(base.Experimenter):
    """Hamming distance to a hidden categorical optimum (MINIMIZE to 0).

    Reference ``L1CategorialExperimenter``: parameter c{i} has
    ``num_categories[i]`` values; the loss counts mismatches against the
    (possibly random) optimum — the simplest categorical convergence gate.
    """

    def __init__(
        self,
        *,
        num_categories: Sequence[int],
        optimum: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
    ):
        rng = np.random.default_rng(seed)
        self._problem = base_study_config.ProblemStatement()
        self._optimum: Dict[str, str] = {}
        for i, k in enumerate(num_categories):
            name = f"c{i}"
            self._problem.search_space.root.add_categorical_param(
                name, [str(v) for v in range(k)]
            )
            if optimum is None:
                self._optimum[name] = str(rng.integers(0, k))
            elif optimum[i] >= k:
                raise ValueError(
                    f"Optimum index {optimum[i]} out of range for {k} categories."
                )
            else:
                self._optimum[name] = str(optimum[i])
        self._problem.metric_information.append(
            base_study_config.MetricInformation(
                name="objective",
                goal=base_study_config.ObjectiveMetricGoal.MINIMIZE,
            )
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            loss = sum(
                1.0
                for name, best in self._optimum.items()
                if str(t.parameters[name].value) != best
            )
            t.complete(trial_.Measurement(metrics={"objective": loss}))

    @property
    def optimal_trial(self) -> trial_.Trial:
        t = trial_.Trial(id=0, parameters=dict(self._optimum))
        self.evaluate([t])
        return t

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


# ---------------------------------------------------------------------------
# MAXSAT (weighted CNF).
# ---------------------------------------------------------------------------


def parse_wcnf(
    text: str,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse DIMACS WCNF into padded clause tensors.

    Returns ``(n_variables, weights [C], var_idx [C, L], want_true [C, L],
    literal_mask [C, L])`` where ``L`` is the longest clause. Mirrors the
    reference's parse (``combo_experimenter.py:384-404``: header ``p wcnf
    V C``, per-line ``weight lit ... 0``) but materializes the clauses as
    padded arrays so evaluation is one vectorized reduction instead of a
    per-clause python loop.
    """
    n_variables = n_clauses = None
    weights: List[float] = []
    clauses: List[List[int]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("c"):
            continue
        if line.startswith("p "):
            parts = line.split()
            n_variables, n_clauses = int(parts[2]), int(parts[3])
            continue
        # DIMACS allows several "weight lit... 0" clauses on one line; walk
        # the token stream splitting at each 0 terminator so a mid-line 0 is
        # a clause boundary, never a literal.
        tokens = line.split()
        pos = 0
        while pos < len(tokens):
            weight = float(tokens[pos])
            pos += 1
            lits: List[int] = []
            while pos < len(tokens) and tokens[pos] != "0":
                lits.append(int(tokens[pos]))
                pos += 1
            pos += 1  # skip the 0 terminator (or run off a missing one)
            if not lits:
                continue
            weights.append(weight)
            clauses.append(lits)
    if n_variables is None:
        raise ValueError("WCNF text has no 'p wcnf <vars> <clauses>' header.")
    if not clauses:
        raise ValueError("WCNF text contains no clauses.")
    if n_clauses is not None and len(clauses) != n_clauses:
        raise ValueError(
            f"WCNF header declares {n_clauses} clauses, found {len(clauses)}."
        )
    max_len = max(len(c) for c in clauses)
    var_idx = np.zeros((len(clauses), max_len), dtype=np.int64)
    want_true = np.zeros((len(clauses), max_len), dtype=bool)
    mask = np.zeros((len(clauses), max_len), dtype=bool)
    for i, lits in enumerate(clauses):
        for j, lit in enumerate(lits):
            var_idx[i, j] = abs(lit) - 1
            want_true[i, j] = lit > 0
            mask[i, j] = True
    if var_idx.max() >= n_variables:
        raise ValueError("WCNF clause references a variable beyond the header.")
    return n_variables, np.asarray(weights, np.float64), var_idx, want_true, mask


def random_wcnf(
    n_variables: int, n_clauses: int, rng: np.random.Generator, max_clause_len: int = 3
) -> str:
    """Synthetic DIMACS WCNF text (for tests; no COMBO data download)."""
    lines = [f"c synthetic random wcnf", f"p wcnf {n_variables} {n_clauses}"]
    for _ in range(n_clauses):
        k = int(rng.integers(1, max_clause_len + 1))
        vars_ = rng.choice(n_variables, size=k, replace=False) + 1
        signs = rng.integers(0, 2, size=k) * 2 - 1
        w = float(rng.uniform(1.0, 10.0))
        lits = " ".join(str(int(v * s)) for v, s in zip(vars_, signs))
        lines.append(f"{w:.3f} {lits} 0")
    return "\n".join(lines) + "\n"


class MAXSATExperimenter(base.Experimenter):
    """Weighted MAXSAT over boolean assignments.

    Parity target: ``combo_experimenter.py:380-447`` (MAXSATExperimenter) —
    same normalized-weight objective ``-Σ w̃_c · satisfied_c`` (MINIMIZE,
    weights z-scored across clauses) and the same ``x_i`` bool search
    space. Evaluation here is batched: all suggestions' assignments are
    stacked into ``[B, n]`` and every clause is checked with one gather +
    ``any`` reduction over the padded literal tensors.

    Data files (maxsat2018 ``.wcnf``) are external downloads in the
    reference too; use :meth:`from_file` when present, or construct
    directly from WCNF text (``random_wcnf`` for synthetic instances).
    """

    def __init__(self, wcnf_text: str):
        (
            self._n_variables,
            raw_weights,
            self._var_idx,
            self._want_true,
            self._mask,
        ) = parse_wcnf(wcnf_text)
        std = np.std(raw_weights)
        # Reference z-scores clause weights (combo_experimenter.py:396-399).
        # Unweighted instances (all weights equal) would z-score to an
        # identically-zero objective; keep the raw weights there so the
        # clause-count signal survives.
        if std:
            self._weights = (raw_weights - np.mean(raw_weights)) / std
        else:
            self._weights = raw_weights
        self._problem = _bool_problem(self._n_variables)

    @classmethod
    def from_file(cls, path: str) -> "MAXSATExperimenter":
        with open(path, "rt") as f:
            return cls(f.read())

    @property
    def num_variables(self) -> int:
        return self._n_variables

    @property
    def num_clauses(self) -> int:
        return len(self._weights)

    def evaluate_batch(self, assignments: np.ndarray) -> np.ndarray:
        """``[B, n] bool -> [B]`` objective values (vectorized)."""
        x = np.asarray(assignments, dtype=bool)
        lit_ok = x[:, self._var_idx] == self._want_true[None]  # [B, C, L]
        satisfied = (lit_ok & self._mask[None]).any(axis=-1)  # [B, C]
        return -(satisfied @ self._weights)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        if not suggestions:
            return
        x = np.stack(
            [_bool_vector(t, self._n_variables).astype(bool) for t in suggestions]
        )
        values = self.evaluate_batch(x)
        for t, v in zip(suggestions, values):
            t.complete(trial_.Measurement(metrics={"main_objective": float(v)}))

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)
