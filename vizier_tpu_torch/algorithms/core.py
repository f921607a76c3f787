"""Designer and Predictor abstractions.

Parity with ``vizier/_src/algorithms/core/abstractions.py:31-216``:
a ``Designer`` is the suggest/update unit algorithms implement; serializable
variants checkpoint state through metadata; a ``Predictor`` exposes posterior
predictions (mean/stddev) for model-based designers.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Protocol, Sequence

import numpy as np

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import serializable

CompletedTrials = trial_.CompletedTrials
ActiveTrials = trial_.ActiveTrials


class Designer(abc.ABC):
    """A suggestion algorithm.

    ``update`` delivers *newly* completed trials exactly once each, plus the
    full set of currently-active trials; ``suggest`` returns up to ``count``
    suggestions (returning fewer — or none — is allowed and signals that the
    designer is done or needs more data).
    """

    @abc.abstractmethod
    def update(
        self, completed: CompletedTrials, all_active: ActiveTrials = ActiveTrials()
    ) -> None:
        ...

    @abc.abstractmethod
    def suggest(self, count: Optional[int] = None) -> Sequence[trial_.TrialSuggestion]:
        ...


class PartiallySerializableDesigner(Designer, serializable.PartiallySerializable):
    """Designer whose state loads into a freshly-constructed instance."""


class SerializableDesigner(Designer, serializable.Serializable):
    """Designer fully recoverable from dumped metadata."""


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Posterior prediction at a batch of points."""

    mean: np.ndarray
    stddev: np.ndarray

    def __post_init__(self):
        if np.asarray(self.mean).shape != np.asarray(self.stddev).shape:
            raise ValueError(
                f"mean shape {np.asarray(self.mean).shape} != "
                f"stddev shape {np.asarray(self.stddev).shape}"
            )


class Predictor(abc.ABC):
    """Mixin for designers that can predict unobserved points."""

    @abc.abstractmethod
    def predict(
        self,
        suggestions: Sequence[trial_.TrialSuggestion],
        rng: Optional[np.random.Generator] = None,
        num_samples: Optional[int] = None,
    ) -> Prediction:
        ...

    def sample(
        self,
        suggestions: Sequence[trial_.TrialSuggestion],
        rng: Optional[np.random.Generator] = None,
        num_samples: int = 1,
    ) -> np.ndarray:
        """Posterior samples [num_samples, len(suggestions)]; default via normal."""
        rng = rng or np.random.default_rng(0)
        pred = self.predict(suggestions)
        return rng.normal(
            pred.mean[None, :], pred.stddev[None, :], size=(num_samples, len(pred.mean))
        )


class DesignerFactory(Protocol):
    """problem (+kwargs, e.g. seed) → Designer."""

    def __call__(self, problem: base_study_config.ProblemStatement, **kwargs) -> Designer:
        ...
