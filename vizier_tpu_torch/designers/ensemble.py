"""Ensemble designers: multi-armed-bandit expert selection.

Copy of the JAX package's ``designers/ensemble.py`` (host numpy): each
suggestion round picks an expert (inner designer) by a bandit rule (Random,
EXP3 with uniform mixing, EXP3-IX, UCB) over observed rewards; the reward is
1 when a completed trial improves on the incumbent, else 0. The experts are
the port's designers; the bandit draws ``np.random.default_rng(seed)`` in
the JAX package's order, so both packages pick the same arms from one seed.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

_NS = "ensemble"


class EnsembleDesign(abc.ABC):
    """Bandit over K experts: observe(arm, reward) / select(rng)."""

    def __init__(self, num_experts: int):
        self.num_experts = num_experts

    @abc.abstractmethod
    def observe(self, arm: int, reward: float) -> None:
        ...

    @abc.abstractmethod
    def select(self, rng: np.random.Generator) -> int:
        ...

    @property
    @abc.abstractmethod
    def probabilities(self) -> np.ndarray:
        ...


class RandomEnsembleDesign(EnsembleDesign):
    def observe(self, arm: int, reward: float) -> None:
        pass

    def select(self, rng: np.random.Generator) -> int:
        return int(rng.integers(0, self.num_experts))

    @property
    def probabilities(self) -> np.ndarray:
        return np.full(self.num_experts, 1.0 / self.num_experts)


class EXP3UniformEnsembleDesign(EnsembleDesign):
    """EXP3 with uniform exploration mixing."""

    def __init__(self, num_experts: int, *, learning_rate: float = 0.5, mix: float = 0.1):
        super().__init__(num_experts)
        self._lr = learning_rate
        self._mix = mix
        self._log_weights = np.zeros(num_experts)

    @property
    def probabilities(self) -> np.ndarray:
        w = np.exp(self._log_weights - self._log_weights.max())
        p = w / w.sum()
        return (1 - self._mix) * p + self._mix / self.num_experts

    def observe(self, arm: int, reward: float) -> None:
        p = self.probabilities[arm]
        self._log_weights[arm] += self._lr * reward / max(p, 1e-6)
        self._log_weights -= self._log_weights.max()  # stability

    def select(self, rng: np.random.Generator) -> int:
        return int(rng.choice(self.num_experts, p=self.probabilities))


class EXP3IXEnsembleDesign(EXP3UniformEnsembleDesign):
    """EXP3-IX: implicit exploration via a biased importance weight."""

    def __init__(self, num_experts: int, *, learning_rate: float = 0.5, gamma: float = 0.1):
        super().__init__(num_experts, learning_rate=learning_rate, mix=0.0)
        self._gamma = gamma

    def observe(self, arm: int, reward: float) -> None:
        p = self.probabilities[arm]
        self._log_weights[arm] += self._lr * reward / (p + self._gamma)
        self._log_weights -= self._log_weights.max()


class UCBEnsembleDesign(EnsembleDesign):
    def __init__(self, num_experts: int, *, exploration: float = 1.0):
        super().__init__(num_experts)
        self._counts = np.zeros(num_experts)
        self._sums = np.zeros(num_experts)
        self._exploration = exploration

    def observe(self, arm: int, reward: float) -> None:
        self._counts[arm] += 1
        self._sums[arm] += reward

    def select(self, rng: np.random.Generator) -> int:
        unseen = np.nonzero(self._counts == 0)[0]
        if len(unseen):
            return int(unseen[0])
        t = self._counts.sum()
        means = self._sums / self._counts
        ucb = means + self._exploration * np.sqrt(2 * np.log(t) / self._counts)
        return int(np.argmax(ucb))

    @property
    def probabilities(self) -> np.ndarray:
        p = np.zeros(self.num_experts)
        p[self.select(np.random.default_rng(0))] = 1.0
        return p


@dataclasses.dataclass
class EnsembleDesigner(core_lib.Designer):
    """Routes each suggestion round to a bandit-selected inner designer."""

    problem: base_study_config.ProblemStatement
    designers: Dict[str, core_lib.Designer] = dataclasses.field(default_factory=dict)
    design: Optional[EnsembleDesign] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if not self.designers:
            raise ValueError("EnsembleDesigner needs at least one inner designer.")
        self._names = list(self.designers)
        if self.design is None:
            self.design = EXP3IXEnsembleDesign(len(self._names))
        self._rng = np.random.default_rng(self.seed)
        self._metrics = converters.MetricsEncoder(self.problem.metric_information)
        self._best = -np.inf

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        for t in completed.trials:
            label = self._metrics.encode([t])[0, 0]
            expert_raw = t.metadata.ns(_NS).get("expert")
            if expert_raw in self.designers and np.isfinite(label):
                arm = self._names.index(expert_raw)
                # Reward: improvement over the incumbent, squashed to [0, 1].
                reward = 1.0 if label > self._best else 0.0
                self.design.observe(arm, reward)
            if np.isfinite(label):
                self._best = max(self._best, label)
        for designer in self.designers.values():
            designer.update(completed, all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        arm = self.design.select(self._rng)
        name = self._names[arm]
        suggestions = list(self.designers[name].suggest(count))
        for s in suggestions:
            s.metadata.ns(_NS)["expert"] = name
        return suggestions
