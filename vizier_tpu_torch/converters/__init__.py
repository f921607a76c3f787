"""Trial ⇄ array converters and padding schedules."""

from vizier_tpu_torch.converters.core import (
    MetricsEncoder,
    ParameterSpec,
    SearchSpaceEncoder,
    SpecType,
    TrialToArrayConverter,
    TrialToModelInputConverter,
)
from vizier_tpu_torch.converters.padding import DEFAULT_PADDING, PaddingSchedule, PaddingType

__all__ = [
    "DEFAULT_PADDING",
    "MetricsEncoder",
    "PaddingSchedule",
    "PaddingType",
    "ParameterSpec",
    "SearchSpaceEncoder",
    "SpecType",
    "TrialToArrayConverter",
    "TrialToModelInputConverter",
]
