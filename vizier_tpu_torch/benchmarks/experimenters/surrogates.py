"""Surrogate-based benchmark experimenters (HPO-B, NASBench, COMBO).

Parity in role with the reference's data-backed experimenters
(``hpob/handler.py``, ``nasbench101/201``, ``combo``): those require large
external datasets, which the repository does not ship. This module ships the
handler structure plus a generic ``TabularSurrogateExperimenter`` that serves
any (configs, objectives) table — load HPO-B/NASBench dumps into it when the
data is available; construction without data raises a clear error.

Copy of the JAX package's ``benchmarks/experimenters/surrogates.py``, on the
port's data model; the tabular snaps encode with the port's
``converters.core.SearchSpaceEncoder`` (float64 numpy, as the JAX
package's). ``PredictorExperimenter`` serves any Predictor's mean, the
port's GP designers on their device included.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


class TabularSurrogateExperimenter(base.Experimenter):
    """Nearest-neighbor lookup over a finite table of evaluated configs.

    ``rows``: list of {param_name: value}; ``objectives``: [N] values.
    Evaluation snaps a suggestion to the nearest tabulated config: exact
    match REQUIRED for categoricals (no tabulated row with the suggested
    categorical combination ⇒ infeasible), nearest scaled L2 for numerics —
    the standard way NAS/HPO tabular benchmarks are served.
    """

    def __init__(
        self,
        problem: base_study_config.ProblemStatement,
        rows: Sequence[Dict],
        objectives: Sequence[float],
        *,
        metric_name: Optional[str] = None,
    ):
        if len(rows) != len(objectives):
            raise ValueError("rows and objectives must align.")
        if not rows:
            raise ValueError("Empty surrogate table.")
        self._problem = problem
        self._metric = metric_name or problem.metric_information.item().name
        self._objectives = np.asarray(objectives, dtype=np.float64)
        from vizier_tpu_torch.converters import core as converters

        self._enc = converters.SearchSpaceEncoder(problem.search_space)
        table_trials = [trial_.Trial(id=i + 1, parameters=r) for i, r in enumerate(rows)]
        self._table_cont, self._table_cat = self._enc.encode(table_trials)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        if not suggestions:
            return
        cont, cat = self._enc.encode(suggestions)
        # Continuous distance via the |a|²-2ab+|b|² expansion (no [M,N,D]
        # intermediate); categorical mismatches are disqualifying.
        a2 = np.sum(cont**2, axis=1, keepdims=True)
        b2 = np.sum(self._table_cont**2, axis=1, keepdims=True).T
        d = np.maximum(a2 + b2 - 2.0 * cont @ self._table_cont.T, 0.0)
        if self._enc.num_categorical:
            mismatch = (cat[:, None, :] != self._table_cat[None, :, :]).any(axis=-1)
            d = np.where(mismatch, np.inf, d)
        nearest = d.argmin(axis=1)
        for t, idx, row in zip(suggestions, nearest, d):
            if not np.isfinite(row[idx]):
                t.complete(
                    infeasibility_reason="No tabulated config with this "
                    "categorical combination."
                )
                continue
            t.complete(
                trial_.Measurement(
                    metrics={self._metric: float(self._objectives[idx])}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem


def _require_file(path: Optional[str], what: str) -> str:
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} data not found at {path!r}. Download the dataset and pass "
            "its path; the repository ships no benchmark data."
        )
    return path


class HPOBHandler:
    """HPO-B v3 benchmark handler (parity with ``hpob/handler.py:35``).

    Reads the real HPO-B layout — ``meta-train-dataset.json`` (plus the
    ``-augmented`` variant), ``meta-validation-dataset.json``,
    ``meta-test-dataset.json``, and ``bo-initializations.json`` under one
    root — with the reference's mode semantics:

    - ``v3-test``: only the meta-test split (the evaluation protocol split).
    - ``v3-train-augmented``: all splits, augmented meta-train.
    - ``v1`` / ``v2`` / ``v3``: all splits; v1 uses the augmented train
      dump; v1/v2 merge every split into one table per search space.

    ``evaluate`` runs the benchmark's own discrete protocol: 5 tabulated
    initial points chosen by the published ``bo-initializations`` ids, then
    ``n_trials`` rounds of the method's ``observe_and_suggest(X_obs, y_obs,
    X_pen) -> index`` over the remaining tabulated candidates, returning
    the normalized incumbent trace. ``evaluate_continuous`` (reference
    ``handler.py:232``) runs the full continuous protocol — published init
    ids, stats-normalized labels, surrogate-scored free suggestions — with
    only the XGBoost model serving gated on the library (inject
    ``predictor=`` to run without it). Loading is lazy so constructing a
    handler without data is cheap; the first data access raises
    ``FileNotFoundError``.
    """

    SEEDS = ("test0", "test1", "test2", "test3", "test4")
    MODES = ("v1", "v2", "v3", "v3-test", "v3-train-augmented")
    N_INITIAL_EVALUATIONS = 5

    def __init__(
        self,
        root_dir: Optional[str] = None,
        mode: str = "v3-test",
        surrogates_dir: Optional[str] = None,
    ):
        """``surrogates_dir`` holds the continuous protocol's saved
        surrogate dumps plus ``summary-stats.json`` (y_min/y_max per
        surrogate); only :meth:`surrogate_predictor`'s XGBoost call needs
        the library itself."""
        if mode not in self.MODES:
            raise ValueError(
                f"Unknown HPO-B mode {mode!r}; choices: {list(self.MODES)}"
            )
        self.root_dir = root_dir
        self.mode = mode
        self.surrogates_dir = surrogates_dir
        self.seeds = list(self.SEEDS)
        self._loaded = False
        self.meta_train_data: Dict = {}
        self.meta_validation_data: Dict = {}
        self.meta_test_data: Dict = {}
        self.bo_initializations: Dict = {}

    # -- data loading -------------------------------------------------------

    def _read(self, filename: str) -> Dict:
        path = _require_file(
            self.root_dir and os.path.join(self.root_dir, filename), "HPO-B"
        )
        with open(path) as f:
            return json.load(f)

    def load_data(
        self,
        rootdir: Optional[str] = None,
        version: str = "v3",
        only_test: bool = True,
        augmented_train: bool = False,
    ) -> None:
        """Loads the dumps with the reference's exact split semantics."""
        if rootdir is not None:
            self.root_dir = rootdir
        self.meta_test_data = self._read("meta-test-dataset.json")
        self.bo_initializations = self._read("bo-initializations.json")
        self.meta_train_data = {}
        self.meta_validation_data = {}
        if not only_test:
            train_file = (
                "meta-train-dataset-augmented.json"
                if (augmented_train or version == "v1")
                else "meta-train-dataset.json"
            )
            self.meta_train_data = self._read(train_file)
            self.meta_validation_data = self._read(
                "meta-validation-dataset.json"
            )
        if version in ("v1", "v2"):
            # Older versions evaluate on the union of all splits.
            merged: Dict = {}
            for ss, datasets in self.meta_train_data.items():
                merged[ss] = dict(datasets)
                if ss in self.meta_test_data:
                    merged[ss].update(self.meta_test_data[ss])
                    merged[ss].update(self.meta_validation_data.get(ss, {}))
            self.meta_test_data = merged
        self._loaded = True

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        if self.mode == "v3-test":
            self.load_data(only_test=True)
        elif self.mode == "v3-train-augmented":
            self.load_data(only_test=False, augmented_train=True)
        else:  # v1 | v2 | v3
            self.load_data(version=self.mode, only_test=False)

    # -- protocol -----------------------------------------------------------

    def get_seeds(self) -> List[str]:
        return list(self.seeds)

    @staticmethod
    def normalize(y, y_min=None, y_max=None):
        y = np.asarray(y, dtype=np.float64)
        if y_min is None:
            y_min, y_max = np.min(y), np.max(y)
        span = y_max - y_min
        if span == 0:
            # Constant-y dataset (or single row): a 0/0 here would poison
            # every incumbent trace with NaN; all-zeros is the only value
            # consistent with "distance above the minimum".
            return np.zeros_like(y)
        return (y - y_min) / span

    def evaluate(
        self,
        bo_method=None,
        search_space_id: Optional[str] = None,
        dataset_id: Optional[str] = None,
        seed: Optional[str] = None,
        n_trials: int = 10,
    ) -> List[float]:
        """Discrete protocol: incumbent trace over tabulated candidates."""
        if bo_method is None or not hasattr(bo_method, "observe_and_suggest"):
            raise ValueError(
                "bo_method must define observe_and_suggest(X_obs, y_obs, "
                "X_pen) -> pending index."
            )
        if search_space_id is None or dataset_id is None or seed is None:
            raise ValueError("search_space_id, dataset_id and seed are required.")
        self._ensure_loaded()
        entry = self.meta_test_data[search_space_id][dataset_id]
        xs = np.asarray(entry["X"], dtype=np.float64)
        ys = self.normalize(np.asarray(entry["y"], dtype=np.float64).reshape(-1))
        pending = list(range(len(xs)))
        current: List[int] = []
        init_ids = self.bo_initializations[search_space_id][dataset_id][seed]
        for i in range(self.N_INITIAL_EVALUATIONS):
            idx = init_ids[i]
            pending.remove(idx)
            current.append(idx)
        history = [float(np.max(ys[current]))]
        for _ in range(n_trials):
            pick = bo_method.observe_and_suggest(
                xs[current], ys[current], xs[pending]
            )
            idx = pending[int(pick)]
            pending.remove(idx)
            current.append(idx)
            history.append(float(np.max(ys[current])))
        return history

    def surrogates_stats(self) -> Dict:
        """Parses ``summary-stats.json`` from ``surrogates_dir`` (the
        published y_min/y_max per surrogate; reference ``handler.py:131``)."""
        if self.surrogates_dir is None:
            raise ValueError(
                "surrogates_dir is required for the continuous protocol "
                "(it holds summary-stats.json and the surrogate dumps)."
            )
        path = _require_file(
            os.path.join(self.surrogates_dir, "summary-stats.json"), "HPO-B"
        )
        with open(path) as f:
            return json.load(f)

    def surrogate_predictor(self, search_space_id: str, dataset_id: str):
        """``[N, dim] -> [N]`` callable serving the saved XGBoost surrogate.

        The only xgboost-gated piece of the continuous protocol: loads
        ``surrogate-<ss>-<ds>.json`` from ``surrogates_dir`` into a Booster
        (reference ``handler.py:265-267``). Everything around it —
        stats parsing, init ids, normalize/clip, the suggest loop — is
        plain code; tests inject a fake predictor instead.
        """
        if self.surrogates_dir is None:
            raise ValueError(
                "surrogates_dir is required to serve saved surrogates "
                "(pass predictor= to evaluate_continuous to go without)."
            )
        try:
            import xgboost as xgb
        except ImportError as e:
            raise ImportError(
                "Serving the published HPO-B surrogates needs the xgboost "
                "package (not installed); pass predictor= to "
                "evaluate_continuous instead."
            ) from e
        model_path = _require_file(
            os.path.join(
                self.surrogates_dir,
                f"surrogate-{search_space_id}-{dataset_id}.json",
            ),
            "HPO-B",
        )
        booster = xgb.Booster()
        booster.load_model(model_path)
        return lambda x: np.asarray(booster.predict(xgb.DMatrix(x))).reshape(-1)

    def evaluate_continuous(
        self,
        bo_method=None,
        search_space_id: Optional[str] = None,
        dataset_id: Optional[str] = None,
        seed: Optional[str] = None,
        n_trials: int = 10,
        predictor=None,
    ) -> List[float]:
        """Continuous protocol against the published surrogates.

        Parity with reference ``handler.py:232-306``: seed the 5 published
        initial points, then ``n_trials`` rounds of ``observe_and_suggest
        (X_obs, y_obs_normalized) -> new_x`` where ``new_x`` is any point
        in the unit cube, scored by the saved surrogate and appended to the
        observations. Labels are min-max normalized with the surrogate's
        published ``y_min``/``y_max`` and clipped to [0, 1]; the returned
        trace is the incumbent before each suggest plus one final entry
        (which here includes the last suggested point — the reference
        re-appends the pre-suggest incumbent).

        ``predictor`` is a ``[N, dim] -> [N]`` callable; defaults to the
        xgboost-served surrogate from :meth:`surrogate_predictor`.
        """
        if bo_method is None or not hasattr(bo_method, "observe_and_suggest"):
            raise ValueError(
                "bo_method must define observe_and_suggest(X_obs, y_obs) "
                "-> new continuous point."
            )
        if search_space_id is None or dataset_id is None or seed is None:
            raise ValueError("search_space_id, dataset_id and seed are required.")
        self._ensure_loaded()
        if predictor is None:
            predictor = self.surrogate_predictor(search_space_id, dataset_id)
        stats = self.surrogates_stats()
        stats_key = f"surrogate-{search_space_id}-{dataset_id}"
        if stats_key not in stats:
            raise KeyError(
                f"{stats_key!r} missing from summary-stats.json; cannot "
                "normalize surrogate outputs."
            )
        y_min = stats[stats_key]["y_min"]
        y_max = stats[stats_key]["y_max"]

        entry = self.meta_test_data[search_space_id][dataset_id]
        xs = np.asarray(entry["X"], dtype=np.float64)
        ys = np.asarray(entry["y"], dtype=np.float64).reshape(-1)
        dim = xs.shape[1]
        init_ids = self.bo_initializations[search_space_id][dataset_id][seed]
        observed_x = xs[init_ids[: self.N_INITIAL_EVALUATIONS]]
        observed_y = ys[init_ids[: self.N_INITIAL_EVALUATIONS]]

        history: List[float] = []
        for _ in range(n_trials):
            y_tf = np.clip(self.normalize(observed_y, y_min, y_max), 0.0, 1.0)
            history.append(float(np.max(y_tf)))
            new_x = np.asarray(
                bo_method.observe_and_suggest(observed_x, y_tf), dtype=np.float64
            ).reshape(-1, dim)
            new_y = predictor(new_x)
            observed_x = np.concatenate([observed_x, new_x], axis=0)
            observed_y = np.append(observed_y, new_y)
        y_tf = np.clip(self.normalize(observed_y, y_min, y_max), 0.0, 1.0)
        history.append(float(np.max(y_tf)))
        return history

    # -- experimenter bridge ------------------------------------------------

    def make_experimenter(
        self, search_space_id: str, dataset_id: str
    ) -> base.Experimenter:
        """Serves one (search space, dataset) table as an Experimenter."""
        self._ensure_loaded()
        entry = self.meta_test_data[search_space_id][dataset_id]
        xs = np.asarray(entry["X"], dtype=np.float64)
        ys = np.asarray(entry["y"], dtype=np.float64).reshape(-1)
        problem = base_study_config.ProblemStatement()
        for j in range(xs.shape[1]):
            problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name="objective", goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE
            )
        )
        rows = [{f"x{j}": float(v) for j, v in enumerate(row)} for row in xs]
        return TabularSurrogateExperimenter(problem, rows, ys)


@dataclasses.dataclass
class NASBench201Handler:
    """NASBench-201 handler: 6 categorical ops cells → accuracy table."""

    OPS = ("none", "skip_connect", "nor_conv_1x1", "nor_conv_3x3", "avg_pool_3x3")

    data_path: Optional[str] = None

    def problem_statement(self) -> base_study_config.ProblemStatement:
        problem = base_study_config.ProblemStatement()
        for i in range(6):
            problem.search_space.root.add_categorical_param(f"op{i}", list(self.OPS))
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name="accuracy", goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE
            )
        )
        return problem

    def make_experimenter(self) -> base.Experimenter:
        path = _require_file(self.data_path, "NASBench-201")
        with open(path) as f:
            table = json.load(f)  # [{"op0": ..., ..., "accuracy": ...}, ...]
        rows = [{k: v for k, v in row.items() if k != "accuracy"} for row in table]
        ys = [row["accuracy"] for row in table]
        return TabularSurrogateExperimenter(
            self.problem_statement(), rows, ys, metric_name="accuracy"
        )

    def make_synthetic_experimenter(
        self, *, num_rows: Optional[int] = None, seed: int = 0
    ) -> base.Experimenter:
        """NASBench-201-STYLE surrogate over a synthetic accuracy table.

        Not real NASBench data (none ships with the repository): a
        deterministic structured objective over the same 6-op categorical
        cell space — op quality + pairwise interactions — so the full
        tabular-benchmark pipeline (suggest → snap-to-table → accuracy)
        runs end to end without the dataset.

        Like the real NASBench-201, EVERY architecture is tabulated (all
        5^6 = 15625 cells) by default, so no suggestion can fall outside
        the table; ``num_rows`` subsamples for cheap tests (off-table
        suggestions then complete infeasible, the exact-match contract).
        """
        rng = np.random.default_rng(seed)
        n_ops = len(self.OPS)
        quality = rng.normal(size=(6, n_ops))
        pair = rng.normal(scale=0.3, size=(6, 6, n_ops, n_ops))
        all_idx = np.stack(
            np.meshgrid(*[np.arange(n_ops)] * 6, indexing="ij"), axis=-1
        ).reshape(-1, 6)  # [5^6, 6]
        score = quality[np.arange(6)[None, :], all_idx].sum(axis=1)
        for i in range(6):
            for j in range(i + 1, 6):
                score = score + pair[i, j, all_idx[:, i], all_idx[:, j]]
        accs = 100.0 / (1.0 + np.exp(-score / 4.0))  # accuracy-like range
        if num_rows is not None and num_rows < len(all_idx):
            keep = rng.choice(len(all_idx), size=num_rows, replace=False)
            all_idx, accs = all_idx[keep], accs[keep]
        rows: List[Dict] = [
            {f"op{i}": self.OPS[idx[i]] for i in range(6)} for idx in all_idx
        ]
        return TabularSurrogateExperimenter(
            self.problem_statement(), rows, [float(a) for a in accs],
            metric_name="accuracy",
        )


ATARI100K_AGENTS = ("DER", "DrQ", "DrQ_eps", "OTRainbow")


def atari100k_search_space() -> pc.SearchSpace:
    """The published Rainbow/Atari-100k tuning space (reference
    ``atari100k_experimenter.py`` ``default_search_space``): gin-bindable
    agent hyperparameters, names included."""
    ss = pc.SearchSpace()
    root = ss.root
    root.add_float_param(
        "JaxDQNAgent.gamma", 0.7, 0.999999,
        scale_type=pc.ScaleType.REVERSE_LOG,
    )
    root.add_int_param("JaxDQNAgent.update_horizon", 1, 20)
    root.add_int_param("JaxDQNAgent.update_period", 1, 10)
    root.add_int_param("JaxDQNAgent.target_update_period", 1, 10000)
    root.add_int_param("JaxDQNAgent.min_replay_history", 100, 100000)
    root.add_float_param(
        "JaxDQNAgent.epsilon_train", 1e-7, 1.0, scale_type=pc.ScaleType.LOG
    )
    root.add_int_param("JaxDQNAgent.epsilon_decay_period", 1000, 10000)
    root.add_bool_param("JaxFullRainbowAgent.noisy")
    root.add_bool_param("JaxFullRainbowAgent.dueling")
    root.add_bool_param("JaxFullRainbowAgent.double_dqn")
    root.add_int_param("JaxFullRainbowAgent.num_atoms", 1, 100)
    root.add_bool_param("Atari100kRainbowAgent.data_augmentation")
    root.add_float_param(
        "create_optimizer.learning_rate", 1e-7, 1.0,
        scale_type=pc.ScaleType.LOG,
    )
    root.add_float_param(
        "create_optimizer.eps", 1e-7, 1.0, scale_type=pc.ScaleType.LOG
    )
    return ss


def _atari100k_problem() -> base_study_config.ProblemStatement:
    problem = base_study_config.ProblemStatement(
        search_space=atari100k_search_space()
    )
    problem.metric_information.append(
        base_study_config.MetricInformation(
            name="eval_average_return",
            goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
        )
    )
    return problem


def _gin_native_value(name: str, value):
    """Trial parameter → the python value gin must see.

    Bool params travel as the strings "True"/"False" (categorical
    encoding); binding those into gin would make every ``if noisy:`` check
    truthy, so BOOLEAN-typed parameters convert back to real bools here.
    """
    cfg = _ATARI100K_PARAMS.get(name)
    if cfg is not None and cfg.external_type == pc.ExternalType.BOOLEAN:
        return str(value) == "True"
    return value


_ATARI100K_PARAMS = {p.name: p for p in atari100k_search_space().parameters}


class Atari100kExperimenter(base.Experimenter):
    """Live Atari-100k Rainbow tuning (reference ``Atari100kExperimenter``).

    Each trial's parameters are gin bindings applied over the chosen agent
    base config (DER / DrQ / DrQ_eps / OTRainbow); evaluation runs real
    dopamine training + eval with ``eval_average_return`` as the
    objective. The dopamine/gin stack is an optional dependency, so
    ``evaluate`` is import-gated; the problem surface (the published
    14-parameter space) works everywhere. ``gin_config_dir`` must point at
    the published agent configs (e.g. dopamine's or the reference's
    ``atari100k_configs/`` directory — they are data, not shipped here).
    """

    def __init__(
        self,
        game_name: str = "Pong",
        agent_name: str = "DER",
        initial_gin_bindings: Optional[Dict] = None,
        gin_config_dir: Optional[str] = None,
    ):
        if agent_name not in ATARI100K_AGENTS:
            raise ValueError(
                f"agent_name must be one of {ATARI100K_AGENTS}, got {agent_name!r}."
            )
        self._game_name = game_name
        self._agent_name = agent_name
        self._initial_gin_bindings = dict(initial_gin_bindings or {})
        self._gin_config_dir = gin_config_dir

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return _atari100k_problem()

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        try:
            import gin  # noqa: F401
            from dopamine.labs.atari_100k import (  # noqa: F401
                eval_run_experiment,
            )
        except ImportError as e:
            raise ImportError(
                "Atari100kExperimenter.evaluate needs the dopamine-rl + gin "
                "stack (not installed) to run real Rainbow "
                "training; use Atari100kHandler for offline tabular dumps."
            ) from e
        if not self._gin_config_dir:
            raise ValueError(
                "Pass gin_config_dir= pointing at the published Atari-100k "
                "agent .gin configs (DER/DrQ/DrQ_eps/OTRainbow) to run live."
            )
        gin_file = os.path.join(
            self._gin_config_dir, f"{self._agent_name}.gin"
        )
        _require_file(gin_file, "Atari100k gin config")
        for t in suggestions:
            with gin.unlock_config():
                gin.parse_config_file(gin_file)
                gin.bind_parameter(
                    "atari_lib.create_atari_environment.game_name",
                    self._game_name,
                )
                for name, value in self._initial_gin_bindings.items():
                    gin.bind_parameter(name, value)
                for name in t.parameters:
                    gin.bind_parameter(
                        name,
                        _gin_native_value(name, t.parameters.get_value(name)),
                    )
            runner = eval_run_experiment.MaxEpisodeEvalRunner(base_dir="/tmp/")
            statistics = runner.run_experiment()
            final = trial_.Measurement(
                metrics={
                    "eval_average_return": float(
                        statistics.data_lists["eval_average_return"][-1]
                    )
                }
            )
            t.complete(final)


@dataclasses.dataclass
class Atari100kHandler:
    """Atari-100k offline tabular handler over the REAL tuning space.

    Expects a json table of records keyed by the published gin-parameter
    names (``atari100k_search_space``) plus an ``eval_average_return``
    metric column (the metric column — only — may also use the legacy name
    ``score``); data is not bundled — pass the dump's path.

    With ``data_path`` set, ``problem_statement()`` reflects the table's
    columns — the (sub)space the dump actually swept — and matches
    ``make_experimenter().problem_statement()`` exactly; without data it
    returns the full published 14-parameter space.
    """

    data_path: Optional[str] = None

    _VALUE_COLS = ("eval_average_return", "score")

    def problem_statement(self) -> base_study_config.ProblemStatement:
        if self.data_path and os.path.exists(self.data_path):
            rows, _ = self._load_table()
            return self._table_problem(rows)
        return _atari100k_problem()

    def _load_table(self):
        path = _require_file(self.data_path, "Atari100k")
        with open(path) as f:
            table = json.load(f)
        if not table:
            raise ValueError(f"Empty Atari100k table at {path!r}.")
        full = set(_ATARI100K_PARAMS)
        expected_keys = None
        ys = []
        rows = []
        for i, row in enumerate(table):
            param_keys = frozenset(k for k in row if k not in self._VALUE_COLS)
            unknown = param_keys - full
            if unknown:
                raise ValueError(
                    f"Unknown Atari100k column {sorted(unknown)[0]!r} in row "
                    f"{i}; expected gin parameter names from "
                    "atari100k_search_space()."
                )
            if expected_keys is None:
                expected_keys = param_keys
            elif param_keys != expected_keys:
                raise ValueError(
                    f"Row {i} columns {sorted(param_keys)} differ from row "
                    f"0's {sorted(expected_keys)}; every row must sweep the "
                    "same parameters."
                )
            for col in self._VALUE_COLS:
                if col in row:
                    ys.append(row[col])
                    break
            else:
                raise ValueError(
                    f"Row {i} needs an 'eval_average_return' (or legacy "
                    "'score') metric column."
                )
            rows.append({k: row[k] for k in param_keys})
        return rows, ys

    def _table_problem(self, rows) -> base_study_config.ProblemStatement:
        problem = base_study_config.ProblemStatement()
        for name in sorted(rows[0]):
            problem.search_space.root.add(_ATARI100K_PARAMS[name])
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name="eval_average_return",
                goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
            )
        )
        return problem

    def make_experimenter(self) -> base.Experimenter:
        rows, ys = self._load_table()
        return TabularSurrogateExperimenter(
            self._table_problem(rows), rows, ys,
            metric_name="eval_average_return",
        )


class PredictorExperimenter(base.Experimenter):
    """Serves a trained ``Predictor``'s posterior mean as the objective.

    Parity with the reference ``PredictorExperimenter``
    (``surrogate_experimenter.py:26``): any designer implementing the
    Predictor mixin (e.g. a GP bandit fit on real measurements) becomes a
    cheap stand-in objective for benchmarking other algorithms.
    """

    def __init__(
        self,
        predictor,
        problem_statement: base_study_config.ProblemStatement,
        seed: int = 0,
    ):
        name = problem_statement.single_objective_metric_name
        if name is None:
            raise ValueError(
                "PredictorExperimenter needs a single-objective problem."
            )
        self._predictor = predictor
        self._problem = copy.deepcopy(problem_statement)
        self._objective_name = name
        self._rng = np.random.default_rng(seed)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        if not suggestions:
            return
        as_suggestions = [
            trial_.TrialSuggestion(parameters=t.parameters)
            for t in suggestions
        ]
        prediction = self._predictor.predict(as_suggestions, self._rng)
        means = np.asarray(prediction.mean).reshape(len(suggestions), -1)
        for t, mean in zip(suggestions, means):
            t.complete(
                trial_.Measurement(
                    metrics={self._objective_name: float(mean[0])}
                )
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)
