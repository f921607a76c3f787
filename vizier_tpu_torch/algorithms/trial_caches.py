"""Trial-id deduplicating loader.

A copy of the JAX package's ``algorithms/trial_caches.py``, so that the port imports nothing
of the JAX package.

(``IdDeduplicatingTrialLoader``): tracks which completed trials a designer
has already incorporated and fetches only the new ones; serializable so the
cache survives process restarts.
"""

from __future__ import annotations

import json
from typing import List, Set

from vizier_tpu_torch.pythia import policy_supporter as supporter_lib
from vizier_tpu_torch.pyvizier import common
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.utils import serializable


def encode_trial_ids(ids) -> str:
    """The ONE wire format for persisted incorporated-trial-id caches.

    Shared with ``designer_policy``'s study-metadata cache so the two
    persistence paths cannot drift.
    """
    return json.dumps(sorted(int(i) for i in ids))


def decode_trial_ids(raw: str) -> Set[int]:
    try:
        ids = json.loads(raw)
        return set(int(i) for i in ids)
    except (ValueError, TypeError) as e:
        raise serializable.DecodeError(str(e))


class IdDeduplicatingTrialLoader(serializable.PartiallySerializable):
    def __init__(self, supporter: supporter_lib.PolicySupporter):
        self._supporter = supporter
        self._incorporated: Set[int] = set()

    def new_completed_trials(self) -> List[trial_.Trial]:
        """Completed trials not yet delivered by this loader."""
        completed = self._supporter.GetTrials(
            status_matches=trial_.TrialStatus.COMPLETED
        )
        fresh = [t for t in completed if t.id not in self._incorporated]
        self._incorporated.update(t.id for t in fresh)
        return fresh

    def active_trials(self) -> List[trial_.Trial]:
        return self._supporter.GetTrials(status_matches=trial_.TrialStatus.ACTIVE)

    @property
    def num_incorporated(self) -> int:
        return len(self._incorporated)

    def dump(self) -> common.Metadata:
        md = common.Metadata()
        md["incorporated_trial_ids"] = encode_trial_ids(self._incorporated)
        return md

    def load(self, metadata: common.Metadata) -> None:
        raw = metadata.get("incorporated_trial_ids")
        if raw is None:
            raise serializable.DecodeError("Missing 'incorporated_trial_ids'.")
        self._incorporated = decode_trial_ids(raw)
