"""Canonical search spaces and metric configs shared by tests.

The port's copy of the JAX package's ``testing/test_studies.py``.
"""

from __future__ import annotations

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc

MetricInformation = base_study_config.MetricInformation
ObjectiveMetricGoal = base_study_config.ObjectiveMetricGoal


def flat_space_with_all_types() -> pc.SearchSpace:
    """One of each parameter type, mixed scalings."""
    space = pc.SearchSpace()
    root = space.root
    root.add_float_param("lineardouble", -1.0, 2.0)
    root.add_float_param("logdouble", 1e-4, 1e2, scale_type=pc.ScaleType.LOG)
    root.add_int_param("integer", -2, 2)
    root.add_categorical_param("categorical", ["a", "aa", "aaa"])
    root.add_bool_param("boolean")
    root.add_discrete_param("discrete_double", [-0.5, 1.0, 1.2])
    root.add_discrete_param("discrete_logdouble", [1e-5, 1e-2, 1e-1])
    root.add_discrete_param("discrete_int", [-1, 1, 2])
    return space


def flat_continuous_space_with_scaling() -> pc.SearchSpace:
    space = pc.SearchSpace()
    root = space.root
    root.add_float_param("double", -1.0, 2.0)
    root.add_float_param("logdouble", 1e-4, 1e2, scale_type=pc.ScaleType.LOG)
    root.add_float_param("reverselogdouble", 0.1, 1.0, scale_type=pc.ScaleType.REVERSE_LOG)
    return space


def conditional_automl_space() -> pc.SearchSpace:
    """The classic conditional AutoML space: model type gates child params."""
    space = pc.SearchSpace()
    root = space.root
    model = root.add_categorical_param("model_type", ["linear", "dnn"])
    dnn = model.select_values(["dnn"])
    dnn.add_float_param("learning_rate", 0.0001, 1.0, scale_type=pc.ScaleType.LOG)
    linear = space.select("model_type").select_values(["linear"])
    linear.add_float_param("l2_reg", 1e-6, 1.0, scale_type=pc.ScaleType.LOG)
    return space


def metrics_objective_maximize() -> base_study_config.MetricsConfig:
    return base_study_config.MetricsConfig(
        [MetricInformation(name="objective", goal=ObjectiveMetricGoal.MAXIMIZE)]
    )


def metrics_multiobjective() -> base_study_config.MetricsConfig:
    return base_study_config.MetricsConfig(
        [
            MetricInformation(name="obj1", goal=ObjectiveMetricGoal.MAXIMIZE),
            MetricInformation(name="obj2", goal=ObjectiveMetricGoal.MINIMIZE),
        ]
    )


def metrics_with_safety() -> base_study_config.MetricsConfig:
    return base_study_config.MetricsConfig(
        [
            MetricInformation(name="objective", goal=ObjectiveMetricGoal.MAXIMIZE),
            MetricInformation(
                name="safety", goal=ObjectiveMetricGoal.MAXIMIZE, safety_threshold=0.2
            ),
        ]
    )
