"""Graceful degradation: seeded quasi-random suggestions on designer failure.

A copy of the JAX package's ``reliability/fallback.py``: the same Halton
stream, seeded per study, gives the same points in both packages.

The production Vizier service keeps issuing suggestions under algorithm
failure by degrading to simpler samplers instead of erroring studies
(arxiv 2408.11527), and quasi-random fill-in preserves parallel GP-bandit
regret guarantees (arxiv 1206.6402) — so this is principled degradation,
not a hack. Every fallback suggestion is stamped with
``ns "reliability": fallback=quasi_random`` in trial metadata so degraded
trials stay auditable after the fact.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

_logger = logging.getLogger(__name__)

FALLBACK_NAMESPACE = "reliability"
FALLBACK_KEY = "fallback"
FALLBACK_VALUE = "quasi_random"
FALLBACK_REASON_KEY = "fallback_reason"


def _study_seed(study_name: str) -> int:
    """A stable per-study seed (deterministic across processes/restarts)."""
    digest = hashlib.sha256(study_name.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "big")


def is_fallback_suggestion(metadata) -> bool:
    """True when trial/suggestion metadata carries the fallback marker."""
    return metadata.ns(FALLBACK_NAMESPACE).get(FALLBACK_KEY) == FALLBACK_VALUE


def suggest_fallback(
    problem: base_study_config.ProblemStatement,
    count: int,
    *,
    study_name: str,
    max_trial_id: int,
    reason: str,
) -> List[trial_.TrialSuggestion]:
    """``count`` seeded quasi-random suggestions, stamped as fallbacks.

    The Halton stream is seeded per study and fast-forwarded by
    ``max_trial_id``, so consecutive fallbacks on a moving study advance
    through the sequence instead of replaying the same points, while two
    fallbacks at the same frontier (e.g. coalesced peers) are identical.
    Conditional search spaces (which Halton cannot flatten) degrade one
    step further, to seeded uniform random.
    """
    from vizier_tpu_torch.designers import quasi_random, random as random_designer

    seed = _study_seed(study_name)
    try:
        designer = quasi_random.QuasiRandomDesigner(
            problem.search_space, seed=seed
        )
        designer._halton.fast_forward(max_trial_id)
    except ValueError:
        _logger.warning(
            "Quasi-random fallback unavailable for %s (conditional space); "
            "degrading to seeded uniform random.",
            study_name,
        )
        designer = random_designer.RandomDesigner(
            problem.search_space, seed=seed + max_trial_id
        )
    suggestions = list(designer.suggest(count))
    for s in suggestions:
        ns = s.metadata.ns(FALLBACK_NAMESPACE)
        ns[FALLBACK_KEY] = FALLBACK_VALUE
        ns[FALLBACK_REASON_KEY] = reason
    return suggestions
