"""Benchmark state: an experimenter + an algorithm playing a study.

Parity with
``vizier/_src/benchmarks/runners/benchmark_state.py:42-154``.

Copy of the JAX package's ``benchmarks/runners/benchmark_state.py``, on the port's pythia and designer policies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.algorithms import designer_policy
from vizier_tpu_torch.benchmarks.experimenters import base as experimenter_base
from vizier_tpu_torch.pythia import local_policy_supporters
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import study_config as sc
from vizier_tpu_torch.pyvizier import trial as trial_


class PolicySuggester:
    """A policy bound to an in-RAM supporter (the benchmark 'algorithm')."""

    def __init__(
        self,
        policy: policy_lib.Policy,
        supporter: local_policy_supporters.InRamPolicySupporter,
    ):
        self._policy = policy
        self._supporter = supporter

    @classmethod
    def from_designer_factory(
        cls,
        problem: base_study_config.ProblemStatement,
        designer_factory: core_lib.DesignerFactory,
        *,
        seed: Optional[int] = None,
    ) -> "PolicySuggester":
        config = sc.StudyConfig.from_problem(problem)
        supporter = local_policy_supporters.InRamPolicySupporter(config)
        factory = (
            (lambda p: designer_factory(p, seed=seed)) if seed is not None else designer_factory
        )
        policy = designer_policy.InRamDesignerPolicy(supporter, factory, problem=problem)
        return cls(policy, supporter)

    @property
    def supporter(self) -> local_policy_supporters.InRamPolicySupporter:
        return self._supporter

    @property
    def policy(self) -> policy_lib.Policy:
        return self._policy

    def suggest(self, batch_size: int) -> List[trial_.Trial]:
        return self._supporter.SuggestTrials(self._policy, batch_size)


@dataclasses.dataclass
class BenchmarkState:
    experimenter: experimenter_base.Experimenter
    algorithm: PolicySuggester

    @classmethod
    def from_designer_factory(
        cls,
        experimenter: experimenter_base.Experimenter,
        designer_factory: core_lib.DesignerFactory,
        *,
        seed: Optional[int] = None,
    ) -> "BenchmarkState":
        return cls(
            experimenter=experimenter,
            algorithm=PolicySuggester.from_designer_factory(
                experimenter.problem_statement(), designer_factory, seed=seed
            ),
        )
