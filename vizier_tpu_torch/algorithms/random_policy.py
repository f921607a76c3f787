"""Example pure-Pythia policy: random suggestions + random early stopping.

Copy of the JAX package's ``algorithms/random_policy.py`` on the port's
``pythia/``: the same draws as the JAX package's from one seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vizier_tpu_torch.designers import random as random_designer
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter as supporter_lib
from vizier_tpu_torch.pyvizier import trial as trial_


class RandomPolicy(policy_lib.Policy):
    def __init__(
        self,
        policy_supporter: supporter_lib.PolicySupporter,
        *,
        seed: Optional[int] = None,
    ):
        self._supporter = policy_supporter
        self._rng = np.random.default_rng(seed)

    @property
    def should_be_cached(self) -> bool:
        # Stateless apart from the RNG (which only needs a stream, not a
        # fresh seed per request); rebuilding per suggest costs a PCG64
        # entropy init on the serving hot path for nothing.
        return True

    def suggest(self, request: policy_lib.SuggestRequest) -> policy_lib.SuggestDecision:
        space = request.study_config.search_space
        suggestions = [
            trial_.TrialSuggestion(
                parameters=random_designer.sample_point(space, self._rng)
            )
            for _ in range(request.count)
        ]
        return policy_lib.SuggestDecision(suggestions=suggestions)

    def early_stop(self, request: policy_lib.EarlyStopRequest) -> policy_lib.EarlyStopDecisions:
        """Stops one random trial among the candidates."""
        ids = sorted(request.trial_ids)
        decisions = []
        if ids:
            chosen = int(self._rng.choice(ids))
            for tid in ids:
                decisions.append(
                    policy_lib.EarlyStopDecision(
                        id=tid,
                        reason="random early stopping",
                        should_stop=(tid == chosen),
                    )
                )
        return policy_lib.EarlyStopDecisions(decisions=decisions)
