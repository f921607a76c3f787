"""Helpers for running Ray Tune over this framework's experimenters.

Parity with ``vizier/_src/raytune/run_tune.py:33,54,87``
(``run_tune_distributed``, ``run_tune_bbob``, ``run_tune_from_factory``).
The experimenter→(param_space, objective) plumbing is ray-free and tested;
the ``tune.Tuner`` drive itself is gated on ray, an optional dependency.

Copy of the JAX package's ``raytune/run_tune.py``, over the port's
experimenters and ``experimenter_factory``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base as experimenters_base
from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

try:  # pragma: no cover - exercised only where ray is installed.
    from ray import air, data, tune

    _RAY_AVAILABLE = True
except ImportError:  # pragma: no cover
    air = data = tune = None
    _RAY_AVAILABLE = False


def experimenter_param_space(
    experimenter: experimenters_base.Experimenter,
) -> Dict[str, Any]:
    """Search space as the plain-dict mini-language ``SearchSpaceConverter`` maps.

    (Ray's own ``tune.uniform`` etc. objects require ray; the dict form is
    accepted by both this module and ``raytune.vizier_search``.)
    """
    from vizier_tpu_torch.pyvizier import parameter_config as pc

    out: Dict[str, Any] = {}
    for config in experimenter.problem_statement().search_space.parameters:
        if config.type == pc.ParameterType.DOUBLE:
            lo, hi = config.bounds
            kind = (
                "loguniform" if config.scale_type == pc.ScaleType.LOG else "uniform"
            )
            out[config.name] = {"type": kind, "min": lo, "max": hi}
        elif config.type == pc.ParameterType.INTEGER:
            lo, hi = config.bounds
            out[config.name] = {"type": "randint", "min": int(lo), "max": int(hi)}
        else:
            out[config.name] = {
                "type": "choice",
                "values": list(config.feasible_values),
            }
    return out


def experimenter_objective(
    experimenter: experimenters_base.Experimenter,
) -> Callable[[Dict[str, Any]], Dict[str, float]]:
    """config-dict → {metric: value} callable over one experimenter evaluate."""
    problem = experimenter.problem_statement()

    def objective(config: Dict[str, Any]) -> Dict[str, float]:
        t = trial_.Trial(id=1, parameters=dict(config))
        experimenter.evaluate([t])
        if t.final_measurement is None:
            return {m.name: float("nan") for m in problem.metric_information}
        return {
            name: metric.value
            for name, metric in t.final_measurement.metrics.items()
        }

    return objective


def run_tune_from_factory(
    factory: Callable[[], experimenters_base.Experimenter],
    tune_config=None,
    run_config=None,
):
    """Fits a ``tune.Tuner`` on the factory's experimenter (requires ray)."""
    if not _RAY_AVAILABLE:  # pragma: no cover
        raise ImportError("ray is not installed; run_tune_from_factory needs it.")
    experimenter = factory()
    problem = experimenter.problem_statement()
    param_space = experimenter_param_space(experimenter)
    objective = experimenter_objective(experimenter)

    metric_info = problem.metric_information.item()
    if tune_config is None:
        tune_config = tune.TuneConfig()
    tune_config.metric = metric_info.name
    tune_config.mode = (
        "min"
        if metric_info.goal == base_study_config.ObjectiveMetricGoal.MINIMIZE
        else "max"
    )

    def objective_fn(config):  # pragma: no cover - needs ray workers
        from ray.air import session

        for _ in range(tune_config.num_samples):
            session.report(objective(config))

    tuner = tune.Tuner(
        objective_fn,
        param_space=param_space,
        run_config=run_config,
        tune_config=tune_config,
    )
    return tuner.fit()


def run_tune_bbob(
    function_name: str,
    dimension: int,
    shift: Optional[np.ndarray] = None,
    tune_config=None,
    run_config=None,
):
    """Fits a Ray tuner on a (optionally shifted) BBOB function (requires ray)."""
    factory = experimenter_factory.SingleObjectiveExperimenterFactory(
        name=function_name, dim=dimension, shift=shift
    )
    return run_tune_from_factory(factory, tune_config, run_config)


def run_tune_distributed(
    run_tune_args_list: List[Tuple[Any, ...]],
    run_tune: Callable[..., Any],
) -> Sequence[Any]:
    """Maps run_tune over arg tuples via the Ray datasets API (requires ray)."""
    if not _RAY_AVAILABLE:  # pragma: no cover
        raise ImportError("ray is not installed; run_tune_distributed needs it.")
    ds = data.from_items([{"args_tuple": args} for args in run_tune_args_list])
    ds = ds.map(lambda x: {"result": run_tune(*x["args_tuple"])})
    return ds.take_all()
