"""PolicyFactory protocol: algorithm string -> Policy.

Copy of the JAX package's ``pythia/policy_factory.py``. The default concrete
factory lives in ``vizier_tpu_torch.service.policy_factory``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter
from vizier_tpu_torch.pyvizier import base_study_config


@runtime_checkable
class PolicyFactory(Protocol):
    """Creates a Policy for (problem, algorithm, supporter, study_name)."""

    def __call__(
        self,
        problem_statement: base_study_config.ProblemStatement,
        algorithm: str,
        policy_supporter: policy_supporter.PolicySupporter,
        study_name: str,
    ) -> policy_lib.Policy:
        ...
