"""Ray Tune integration: ``VizierSearch`` searcher.

Parity with ``vizier/_src/raytune/vizier_search.py:32`` and
``converters.py``: a ``ray.tune.search.Searcher`` backed by the port's
study service. The whole behavioral contract (suggest / result / complete /
save / restore / late property binding) is ray-free and tested against the
in-process service; ray is only needed as the base class when plugging into
a real ``tune.Tuner``.

Copy of the JAX package's ``raytune/vizier_search.py``. The service client
(``service/clients.py``, which needs gRPC and protobuf) is imported when a
study is created or restored, so this module imports without them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from vizier_tpu_torch import pyvizier as vz

try:  # pragma: no cover - exercised only where ray is installed.
    from ray.tune.search import Searcher as _RaySearcher

    _RAY_AVAILABLE = True
except ImportError:  # pragma: no cover
    _RaySearcher = object
    _RAY_AVAILABLE = False


class SearchSpaceConverter:
    """Ray Tune param_space dict → vizier SearchSpace."""

    @staticmethod
    def to_vizier(param_space: Dict[str, Any]) -> vz.SearchSpace:
        space = vz.SearchSpace()
        root = space.root
        for name, domain in param_space.items():
            if isinstance(domain, dict):  # plain-dict mini-language
                kind = domain.get("type")
                if kind == "uniform":
                    root.add_float_param(name, domain["min"], domain["max"])
                elif kind == "loguniform":
                    root.add_float_param(
                        name, domain["min"], domain["max"], scale_type=vz.ScaleType.LOG
                    )
                elif kind == "randint":
                    root.add_int_param(name, domain["min"], domain["max"])
                elif kind == "choice":
                    values = domain["values"]
                    if all(isinstance(v, str) for v in values):
                        root.add_categorical_param(name, values)
                    else:
                        root.add_discrete_param(name, values)
                else:
                    raise ValueError(f"Unknown domain type {kind!r} for {name!r}.")
                continue
            # Ray Domain objects (duck-typed to avoid a hard ray dependency).
            cls = type(domain).__name__
            if cls == "Float":
                sampler = type(getattr(domain, "sampler", None)).__name__
                scale = vz.ScaleType.LOG if "LogUniform" in sampler else vz.ScaleType.LINEAR
                root.add_float_param(name, domain.lower, domain.upper, scale_type=scale)
            elif cls == "Integer":
                root.add_int_param(name, domain.lower, domain.upper - 1)
            elif cls == "Categorical":
                values = list(domain.categories)
                if all(isinstance(v, str) for v in values):
                    root.add_categorical_param(name, values)
                else:
                    root.add_discrete_param(name, values)
            else:
                raise ValueError(f"Unsupported ray domain {cls!r} for {name!r}.")
        return space


class VizierSearch(_RaySearcher):
    """ray.tune Searcher delegating suggestions to a study of the port's service.

    The full ``Searcher`` behavioral contract — ``suggest`` /
    ``on_trial_result`` / ``on_trial_complete`` / ``save`` / ``restore`` /
    late ``set_search_properties`` binding — is implemented without any ray
    dependency (and covered by tests against the in-process service); with
    ray installed the class plugs straight into ``tune.Tuner`` as its base
    class becomes ``ray.tune.search.Searcher``.
    """

    def __init__(
        self,
        param_space: Optional[Dict[str, Any]] = None,
        *,
        metric: Optional[str] = None,
        mode: str = "max",
        algorithm: str = "DEFAULT",
        owner: str = "raytune",
        study_id: Optional[str] = None,
        **kwargs,
    ):
        if _RAY_AVAILABLE:
            super().__init__(metric=metric, mode=mode, **kwargs)
        self._metric = metric
        self._mode = mode
        self._algorithm = algorithm
        self._owner = owner
        self._study_id = study_id
        self._study = None
        self._ray_to_vizier: Dict[str, int] = {}
        if param_space is not None and metric is not None:
            self._create_study(param_space)

    def _create_study(self, param_space: Dict[str, Any]) -> None:
        goal = (
            vz.ObjectiveMetricGoal.MAXIMIZE
            if self._mode == "max"
            else vz.ObjectiveMetricGoal.MINIMIZE
        )
        config = vz.StudyConfig(algorithm=self._algorithm)
        config.search_space = SearchSpaceConverter.to_vizier(param_space)
        config.metric_information.append(
            vz.MetricInformation(name=self._metric, goal=goal)
        )
        from vizier_tpu_torch.service import clients

        self._study = clients.Study.from_study_config(
            config, owner=self._owner, study_id=self._study_id
        )

    def set_search_properties(
        self, metric: Optional[str], mode: Optional[str], config: Dict, **spec
    ) -> bool:
        """Late binding: ray calls this when the Tuner supplies the space."""
        if self._study is not None:
            return False
        if metric:
            self._metric = metric
        if mode:
            self._mode = mode
        if self._metric is None or not config:
            return False
        self._create_study(config)
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._study is None:
            return None  # ray contract: None = not ready / finished
        trials = self._study.suggest(count=1, client_id=trial_id)
        if not trials:  # exhausted finite space: signal completion, not crash
            return None
        (trial,) = trials
        self._ray_to_vizier[trial_id] = trial.id
        return dict(trial.parameters)

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict] = None, error: bool = False
    ) -> None:
        uid = self._ray_to_vizier.pop(trial_id, None)
        if uid is None or self._study is None:
            return
        trial = self._study.get_trial(uid)
        if error or result is None or self._metric not in result:
            trial.complete(infeasible_reason="ray trial errored")
        else:
            trial.complete(
                vz.Measurement(metrics={self._metric: float(result[self._metric])})
            )

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        uid = self._ray_to_vizier.get(trial_id)
        if uid is not None and self._study is not None and self._metric in result:
            self._study.get_trial(uid).add_measurement(
                vz.Measurement(
                    metrics={self._metric: float(result[self._metric])},
                    steps=float(result.get("training_iteration", 0)),
                )
            )

    # -- checkpointing (ray Searcher save/restore contract) -----------------

    def save(self, checkpoint_path: str) -> None:
        """Persists the ray↔vizier trial map + study pointer; study state
        itself lives in the vizier service (restart-transparent)."""
        import json

        state = {
            "ray_to_vizier": self._ray_to_vizier,
            "study_resource_name": (
                self._study.resource_name if self._study is not None else None
            ),
            "metric": self._metric,
            "mode": self._mode,
        }
        with open(checkpoint_path, "w") as f:
            json.dump(state, f)

    def restore(self, checkpoint_path: str) -> None:
        import json

        with open(checkpoint_path) as f:
            state = json.load(f)
        self._ray_to_vizier = {k: int(v) for k, v in state["ray_to_vizier"].items()}
        self._metric = state["metric"]
        self._mode = state["mode"]
        if state["study_resource_name"]:
            from vizier_tpu_torch.service import clients

            self._study = clients.Study.from_resource_name(
                state["study_resource_name"]
            )
