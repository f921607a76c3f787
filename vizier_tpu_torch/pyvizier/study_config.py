"""StudyConfig: a ProblemStatement plus service-level algorithm settings.

A copy of the JAX package's ``pyvizier/study_config.py``, so that the port imports nothing
of the JAX package: algorithm selection, observation-noise hint, automated (early) stopping
config, and an optional dedicated Pythia endpoint. Serialization for the
service layer is handled by the service's proto converters rather than
proto classes here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


class Algorithm(str, enum.Enum):
    """Well-known algorithm names accepted by the default policy factory.

    The service accepts arbitrary strings; these are the built-ins
    (``service/policy_factory.py``).
    """

    ALGORITHM_UNSPECIFIED = "ALGORITHM_UNSPECIFIED"
    DEFAULT = "DEFAULT"
    GP_UCB_PE = "GP_UCB_PE"
    GAUSSIAN_PROCESS_BANDIT = "GAUSSIAN_PROCESS_BANDIT"
    RANDOM_SEARCH = "RANDOM_SEARCH"
    QUASI_RANDOM_SEARCH = "QUASI_RANDOM_SEARCH"
    GRID_SEARCH = "GRID_SEARCH"
    SHUFFLED_GRID_SEARCH = "SHUFFLED_GRID_SEARCH"
    NSGA2 = "NSGA2"
    EAGLE_STRATEGY = "EAGLE_STRATEGY"
    CMA_ES = "CMA_ES"
    BOCS = "BOCS"
    HARMONICA = "HARMONICA"

    def __str__(self) -> str:
        return self.value


class ObservationNoise(enum.Enum):
    OBSERVATION_NOISE_UNSPECIFIED = "OBSERVATION_NOISE_UNSPECIFIED"
    LOW = "LOW"
    HIGH = "HIGH"


@dataclasses.dataclass(frozen=True)
class AutomatedStoppingConfig:
    """Early-stopping configuration attached to a study.

    ``use_steps=True`` compares trials by step count, else by elapsed secs
    (mirrors Vizier's ``DefaultEarlyStoppingSpec``).
    """

    use_steps: bool = True
    min_num_trials: int = 5
    # "median": median curve rule. "regression": gradient-boosted
    # final-objective prediction from partial curves (algorithms/regression).
    rule: str = "median"

    def __post_init__(self):
        if self.rule not in ("median", "regression"):
            raise ValueError(
                f"Unknown early-stopping rule {self.rule!r}; "
                "choices: 'median' | 'regression'."
            )

    @classmethod
    def default_stopping_spec(cls, *, use_steps: bool = True, min_num_trials: int = 5):
        return cls(use_steps=use_steps, min_num_trials=min_num_trials)

    @classmethod
    def regression_stopping_spec(
        cls, *, use_steps: bool = True, min_num_trials: int = 10
    ):
        return cls(
            use_steps=use_steps, min_num_trials=min_num_trials, rule="regression"
        )


@dataclasses.dataclass
class StudyConfig(base_study_config.ProblemStatement):
    """ProblemStatement + algorithm + service-level knobs."""

    algorithm: str = Algorithm.DEFAULT.value
    observation_noise: ObservationNoise = ObservationNoise.OBSERVATION_NOISE_UNSPECIFIED
    automated_stopping_config: Optional[AutomatedStoppingConfig] = None
    pythia_endpoint: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.algorithm, Algorithm):
            self.algorithm = self.algorithm.value

    @classmethod
    def from_problem(
        cls, problem: base_study_config.ProblemStatement, algorithm: str = Algorithm.DEFAULT.value
    ) -> "StudyConfig":
        return cls(
            search_space=problem.search_space,
            metric_information=problem.metric_information,
            metadata=problem.metadata,
            algorithm=str(algorithm),
        )

    def to_problem(self) -> base_study_config.ProblemStatement:
        return base_study_config.ProblemStatement(
            search_space=self.search_space,
            metric_information=self.metric_information,
            metadata=self.metadata,
        )

    # -- user-facing value mapping ----------------------------------------

    def trial_parameters(self, trial: trial_.Trial) -> Dict[str, Any]:
        """Trial parameters mapped through each config's external type.

        E.g. a bool parameter (stored as CATEGORICAL 'True'/'False') comes
        back as a python bool; an INTEGER-external DISCRETE comes back as int.
        """
        out: Dict[str, Any] = {}
        for name, pv in trial.parameters.items():
            try:
                config = self.search_space.get(name)
            except KeyError:
                out[name] = pv.value
                continue
            ext = config.external_type
            if ext == pc.ExternalType.BOOLEAN:
                out[name] = pv.as_bool
            elif ext == pc.ExternalType.INTEGER:
                out[name] = pv.as_int
            elif ext == pc.ExternalType.FLOAT:
                out[name] = pv.as_float
            else:
                out[name] = pv.cast_as_internal(config.type)
        return out
