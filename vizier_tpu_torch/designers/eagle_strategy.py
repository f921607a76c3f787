"""EagleStrategyDesigner: ask/tell firefly algorithm as a Designer.

Copy of the JAX package's ``designers/eagle_strategy.py`` (host numpy, the
same ``np.random.Generator`` draws in the same order, so both packages give
the same suggestions from one seed on one machine): a pool of fireflies
explores the scaled feature space.

- the pool fills with RANDOM suggestions until a dimension-dependent
  capacity ``10 + round((d^1.2 + d)/2)``;
- moves are sequential *interpolations* toward (away from) each shuffled
  pool member with weight ``±exp(-visibility · 10·d²/dof)`` per parameter
  type;
- perturbation is a max-normalized Laplace direction scaled by the fly's
  perturbation level (fraction of the scaled range); categorical values
  resample with probability ``min(level · factor, 1)``;
- a fly that fails to improve decays its perturbation by ``penalize_factor``
  and is evicted below the lower bound (unless it is the incumbent), making
  room for fresh random flies.

State is partially serializable (trial-level algorithm checkpointing via
study metadata) in the JAX package's format. Distinct from
``vizier_tpu_torch.optimizers.eagle``, the vectorized *acquisition* sweep;
this one spends real (expensive) trials.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import json_utils, serializable

_NS = "eagle"


@dataclasses.dataclass(frozen=True)
class FireflyConfig:
    """Reference ``FireflyAlgorithmConfig`` defaults."""

    gravity: float = 1.0
    negative_gravity: float = 0.02
    visibility: float = 3.0
    categorical_visibility: float = 0.2
    perturbation: float = 0.1
    max_perturbation: float = 0.5
    perturbation_lower_bound: float = 1e-3
    categorical_perturbation_factor: float = 25.0
    pure_categorical_perturbation: float = 0.1
    explore_rate: float = 1.0
    penalize_factor: float = 0.9
    pool_size_factor: float = 1.2
    max_pool_size: int = 1000


@dataclasses.dataclass
class _Fly:
    x: np.ndarray  # [Dc] scaled continuous
    cat: np.ndarray  # [Ds] int
    reward: float
    perturbation: float


@dataclasses.dataclass
class EagleStrategyDesigner(core_lib.PartiallySerializableDesigner):
    problem: base_study_config.ProblemStatement
    config: FireflyConfig = FireflyConfig()
    seed: Optional[int] = None

    def __post_init__(self):
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        self._enc = self._converter.encoder
        self._rng = np.random.default_rng(self.seed)
        df = max(self._enc.num_continuous + self._enc.num_categorical, 1)
        self._capacity = min(
            10 + round((df**self.config.pool_size_factor + df) * 0.5),
            self.config.max_pool_size,
        )
        self._pool: Dict[int, _Fly] = {}
        self._next_id = 0
        self._move_order: List[int] = []

    # -- ask ---------------------------------------------------------------

    def _random_point(self):
        x = self._rng.uniform(size=self._enc.num_continuous)
        cat = np.asarray(
            [self._rng.integers(0, s) for s in self._enc.category_sizes],
            dtype=np.int32,
        )
        return x, cat

    def _pull_weight(self, d2: float, dof: int, better: bool, visibility: float):
        direction = self.config.gravity if better else -self.config.negative_gravity
        if dof == 0:
            return 0.0
        w = float(np.exp(-visibility * (d2 / dof) * 10.0)) * direction
        # Exploration accentuation (reference `_mutate_fly`).
        er = self.config.explore_rate
        return er * w + (1.0 - er) if w > 0.5 else er * w

    def _mutate(self, fly: _Fly):
        """Sequential interpolation pulls from every (shuffled) pool member."""
        x = fly.x.copy()
        cat = fly.cat.copy()
        others = [f for fid, f in self._pool.items() if f is not fly]
        self._rng.shuffle(others)
        dc = self._enc.num_continuous
        ds = self._enc.num_categorical
        for other in others:
            better = other.reward > fly.reward
            if dc:
                d2 = float(np.sum((other.x - x) ** 2))
                w = self._pull_weight(d2, dc, better, self.config.visibility)
                x = other.x * w + x * (1.0 - w)
            if ds:
                # Reference counts categorical MATCHES into the "distance".
                d2 = float(np.sum(other.cat == cat))
                w = self._pull_weight(
                    d2, ds, better, self.config.categorical_visibility
                )
                if w >= 1.0:
                    cat = other.cat.copy()
                elif w > 0.0:
                    pick = self._rng.uniform(size=ds) < w
                    cat = np.where(pick, other.cat, cat)
        return np.clip(x, 0.0, 1.0), cat

    def _perturb(self, x: np.ndarray, cat: np.ndarray, level: float):
        """Max-normalized Laplace direction scaled by the perturbation level."""
        n = self._enc.num_continuous + self._enc.num_categorical
        if n == 0:
            return x, cat
        if self._enc.num_continuous == 0:
            # Pure-categorical space: a CONSTANT resample probability per
            # parameter — no Laplace direction and no
            # ×categorical_perturbation_factor (the scaled path would
            # resample ~every category each move, wiping out local search).
            cat = cat.copy()
            for j, size in enumerate(self._enc.category_sizes):
                if self._rng.uniform() < self.config.pure_categorical_perturbation:
                    cat[j] = self._rng.integers(0, size)
            return x, cat
        raw = self._rng.laplace(size=n)
        direction = raw / max(np.max(np.abs(raw)), 1e-12)
        pert = direction * level
        if self._enc.num_continuous:
            x = np.clip(x + pert[: self._enc.num_continuous], 0.0, 1.0)
        for j, size in enumerate(self._enc.category_sizes):
            p = min(
                abs(pert[self._enc.num_continuous + j])
                * self.config.categorical_perturbation_factor,
                1.0,
            )
            if self._rng.uniform() < p:
                cat = cat.copy()
                cat[j] = self._rng.integers(0, size)
        return x, cat

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        out = []
        for _ in range(count):
            # Pool-occupancy check (reference `_suggest_one`): random fill
            # whenever the pool is below capacity — initially, AND whenever
            # an exhausted fly has been evicted.
            if len(self._pool) < self._capacity:
                x, cat = self._random_point()
                fly_id = self._next_id
                self._next_id += 1
            else:
                if not self._move_order:
                    self._move_order = list(self._pool.keys())
                fly_id = self._move_order.pop(0)
                fly = self._pool.get(fly_id)
                if fly is None:  # evicted since scheduling; fall back random
                    x, cat = self._random_point()
                else:
                    x, cat = self._mutate(fly)
                    x, cat = self._perturb(x, cat, fly.perturbation)
            params = self._converter.to_parameters(x[None, :], cat[None, :])[0]
            s = trial_.TrialSuggestion(parameters=params)
            s.metadata.ns(_NS)["fly"] = str(fly_id)
            out.append(s)
        return out

    # -- tell --------------------------------------------------------------

    def _best_id(self) -> Optional[int]:
        if not self._pool:
            return None
        return max(self._pool, key=lambda fid: self._pool[fid].reward)

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        cfg = self.config
        for t in completed.trials:
            labels = self._converter.metrics.encode([t])[0]
            reward = float(labels[0]) if np.isfinite(labels[0]) else -np.inf
            cont, cat = self._enc.encode([t])
            fly_raw = t.metadata.ns(_NS).get("fly")
            if fly_raw is None:
                fly_id = self._next_id  # foreign trial: fresh fly id
                self._next_id += 1
            else:
                fly_id = int(fly_raw)
            fly = self._pool.get(fly_id)
            if fly is None:
                if len(self._pool) < self._capacity and np.isfinite(reward):
                    self._pool[fly_id] = _Fly(
                        x=cont[0].astype(np.float64),
                        cat=cat[0].astype(np.int32),
                        reward=reward,
                        perturbation=cfg.perturbation,
                    )
                elif np.isfinite(reward):
                    # Pool full: adopt into the closest fly ONLY if the trial
                    # improves on it — the closest parent is not responsible
                    # for a foreign failure (reference _assign_closest_parent),
                    # so non-improving orphans must not penalize it.
                    nearest = min(
                        self._pool,
                        key=lambda fid: np.sum(
                            (self._pool[fid].x - cont[0]) ** 2
                        )
                        + np.sum(self._pool[fid].cat != cat[0]),
                    )
                    if reward > self._pool[nearest].reward:
                        self._settle(nearest, cont[0], cat[0], reward)
                continue
            self._settle(fly_id, cont[0], cat[0], reward)

    def _settle(self, fly_id: int, x, cat, reward: float) -> None:
        """Improvement adopts the move; failure decays the perturbation."""
        cfg = self.config
        fly = self._pool[fly_id]
        if reward > fly.reward:
            # Perturbation stays put on improvement (the reference only
            # boosts it when a fly is stuck repeating the same point).
            fly.x = np.asarray(x, dtype=np.float64)
            fly.cat = np.asarray(cat, dtype=np.int32)
            fly.reward = reward
        else:
            fly.perturbation *= cfg.penalize_factor
            if (
                fly.perturbation < cfg.perturbation_lower_bound
                and fly_id != self._best_id()
                and len(self._pool) >= self._capacity
            ):
                # Exhausted AND the pool is full: evict to make room for a
                # fresh random fly. Below capacity the stalled fly is kept —
                # in studies with few feasible trials it still carries signal.
                del self._pool[fly_id]

    # -- PartiallySerializable --------------------------------------------

    def dump(self) -> common.Metadata:
        md = common.Metadata()
        md["eagle"] = json_utils.dumps(
            {
                "ids": list(self._pool.keys()),
                "xs": np.stack([f.x for f in self._pool.values()])
                if self._pool
                else np.zeros((0, self._enc.num_continuous)),
                "cats": np.stack([f.cat for f in self._pool.values()])
                if self._pool
                else np.zeros((0, self._enc.num_categorical), dtype=np.int32),
                "rewards": [f.reward for f in self._pool.values()],
                "perturbations": [f.perturbation for f in self._pool.values()],
                "next_id": self._next_id,
            }
        )
        return md

    def load(self, metadata: common.Metadata) -> None:
        raw = metadata.get("eagle")
        if raw is None:
            raise serializable.DecodeError("Missing 'eagle' state.")
        try:
            state = json_utils.loads(raw)
            xs = np.asarray(state["xs"], dtype=np.float64)
            cats = np.asarray(state["cats"], dtype=np.int32)
            self._pool = {
                int(fid): _Fly(
                    x=xs[i],
                    cat=cats[i],
                    reward=float(state["rewards"][i]),
                    perturbation=float(state["perturbations"][i]),
                )
                for i, fid in enumerate(state["ids"])
            }
            self._next_id = int(state["next_id"])
            self._move_order = []
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise serializable.DecodeError(f"Bad eagle state: {e}")
