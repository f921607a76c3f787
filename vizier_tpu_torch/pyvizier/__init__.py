"""PyVizier facade of the port: the shared data model.

Copies of the JAX package's JAX-free ``pyvizier`` modules, so that the port
imports nothing of the JAX package; the facade exports what the JAX
package's does.
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
    FidelityConfig,
    InvalidParameterError,
    ParameterConfig,
    ParameterType,
    ParameterValueTypes,
    ScaleType,
    SearchSpace,
    SearchSpaceSelector,
)
from vizier_tpu_torch.pyvizier.context import Context
from vizier_tpu_torch.pyvizier.study import (
    ProblemAndTrials,
    StudyDescriptor,
    StudyState,
    StudyStateInfo,
)
from vizier_tpu_torch.pyvizier.study_config import (
    Algorithm,
    AutomatedStoppingConfig,
    ObservationNoise,
    StudyConfig,
)
from vizier_tpu_torch.pyvizier.trial import (
    ActiveTrials,
    CompletedTrials,
    Measurement,
    MetadataDelta,
    Metric,
    ParameterDict,
    ParameterValue,
    Trial,
    TrialFilter,
    TrialStatus,
    TrialSuggestion,
)

__all__ = [
    "ActiveTrials",
    "Algorithm",
    "AutomatedStoppingConfig",
    "CompletedTrials",
    "ExternalType",
    "FidelityConfig",
    "InvalidParameterError",
    "Measurement",
    "Metadata",
    "MetadataDelta",
    "MetadataValue",
    "Metric",
    "MetricInformation",
    "MetricType",
    "MetricsConfig",
    "Namespace",
    "ObjectiveMetricGoal",
    "ObservationNoise",
    "ParameterConfig",
    "ParameterDict",
    "ParameterType",
    "ParameterValue",
    "ParameterValueTypes",
    "ProblemStatement",
    "ScaleType",
    "SearchSpace",
    "SearchSpaceSelector",
    "StudyConfig",
    "StudyDescriptor",
    "StudyState",
    "StudyStateInfo",
    "Trial",
    "TrialFilter",
    "TrialStatus",
    "TrialSuggestion",
]
