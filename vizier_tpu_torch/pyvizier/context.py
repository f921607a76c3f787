"""Context: side information attached to a study (e.g. contextual bandits).

Copy of the JAX package's ``pyvizier/context.py``: a description, a
parameter assignment for the context variables, metadata and related links.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class Context:
    """Side-channel parameter assignment plus metadata for a study."""

    description: Optional[str] = None
    parameters: Dict[str, trial_.ParameterValue] = dataclasses.field(
        default_factory=dict
    )
    metadata: common.Metadata = dataclasses.field(default_factory=common.Metadata)
    related_links: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.description is not None and not isinstance(self.description, str):
            raise TypeError(f"description must be str, got {self.description!r}")
        for k, v in self.parameters.items():
            if not isinstance(k, str):
                raise TypeError(f"parameter keys must be str, got {k!r}")
            if not isinstance(v, trial_.ParameterValue):
                raise TypeError(
                    f"parameter values must be ParameterValue, got {v!r}"
                )
        for k, v in self.related_links.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(f"related_links must be str->str, got {k!r}: {v!r}")
