"""PyVizier facade of the port: the data model the designers use.

Copies of the JAX package's JAX-free ``pyvizier`` modules, so that the port
imports nothing of the JAX package.
"""

from vizier_tpu_torch.pyvizier.base_study_config import (
    MetricInformation,
    MetricsConfig,
    MetricType,
    ObjectiveMetricGoal,
    ProblemStatement,
)
from vizier_tpu_torch.pyvizier.common import Metadata, MetadataValue, Namespace
from vizier_tpu_torch.pyvizier.parameter_config import (
    ExternalType,
    InvalidParameterError,
    ParameterConfig,
    ParameterType,
    ParameterValueTypes,
    ScaleType,
    SearchSpace,
    SearchSpaceSelector,
)
from vizier_tpu_torch.pyvizier.trial import (
    ActiveTrials,
    CompletedTrials,
    Measurement,
    Metric,
    ParameterDict,
    ParameterValue,
    Trial,
    TrialStatus,
    TrialSuggestion,
)

__all__ = [
    "ActiveTrials",
    "CompletedTrials",
    "ExternalType",
    "InvalidParameterError",
    "Measurement",
    "Metadata",
    "MetadataValue",
    "Metric",
    "MetricInformation",
    "MetricType",
    "MetricsConfig",
    "Namespace",
    "ObjectiveMetricGoal",
    "ParameterConfig",
    "ParameterDict",
    "ParameterType",
    "ParameterValue",
    "ParameterValueTypes",
    "ProblemStatement",
    "ScaleType",
    "SearchSpace",
    "SearchSpaceSelector",
    "Trial",
    "TrialStatus",
    "TrialSuggestion",
]
