"""``ShardedDataStore``: study-partitioned composite over per-shard stores.

Implements the ``DataStore`` ABC by routing every call to the shard that
owns the study — the same rendezvous placement the service-level
``StudyRouter`` computes, so a client-side router and a server-side
sharded store independently agree about where a study lives. Study-scoped
operations stay single-shard (the per-shard stores keep their constant-
time open/undone/max indexes and their own locking); only the owner-scoped
``list_studies`` fans out across shards. A copy of the JAX package's
``distributed/sharded_datastore.py``.

Stateless by construction: no lock of its own, no shared mutable state —
the composite adds no lock of its own on top of its shards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.service import datastore as datastore_lib
from vizier_tpu_torch.service import resources


class ShardedDataStore(datastore_lib.DataStore):
    """Partitions studies across ``shards`` by rendezvous hashing."""

    def __init__(
        self,
        shards: Sequence[datastore_lib.DataStore],
        *,
        shard_ids: Optional[Sequence[str]] = None,
        router: Optional[routing.StudyRouter] = None,
    ):
        if not shards:
            raise ValueError("ShardedDataStore needs at least one shard.")
        self._shards = list(shards)
        ids = list(shard_ids or (f"shard-{i}" for i in range(len(shards))))
        if len(ids) != len(self._shards):
            raise ValueError(
                f"{len(ids)} shard ids for {len(self._shards)} shards."
            )
        self._by_id = dict(zip(ids, self._shards))
        self._router = router or routing.StudyRouter(ids)

    @property
    def router(self) -> routing.StudyRouter:
        return self._router

    @property
    def shards(self) -> List[datastore_lib.DataStore]:
        return list(self._shards)

    def shard_for(self, study_name: str) -> datastore_lib.DataStore:
        return self._by_id[self._router.replica_for(study_name)]

    def _shard_of_trial(self, trial_name: str) -> datastore_lib.DataStore:
        r = resources.TrialResource.from_name(trial_name)
        return self.shard_for(r.study_resource.name)

    def _shard_of_operation(self, operation_name: str) -> datastore_lib.DataStore:
        r = resources.SuggestionOperationResource.from_name(operation_name)
        return self.shard_for(resources.StudyResource(r.owner_id, r.study_id).name)

    def _shard_of_es_operation(
        self, operation_name: str
    ) -> datastore_lib.DataStore:
        r = resources.EarlyStoppingOperationResource.from_name(operation_name)
        return self.shard_for(resources.StudyResource(r.owner_id, r.study_id).name)

    # -- studies -----------------------------------------------------------

    def create_study(self, study):
        return self.shard_for(study.name).create_study(study)

    def load_study(self, study_name):
        return self.shard_for(study_name).load_study(study_name)

    def update_study(self, study):
        return self.shard_for(study.name).update_study(study)

    def delete_study(self, study_name):
        return self.shard_for(study_name).delete_study(study_name)

    def list_studies(self, owner_name):
        out = []
        for shard in self._shards:
            out.extend(shard.list_studies(owner_name))
        return out

    # -- trials ------------------------------------------------------------

    def create_trial(self, trial):
        return self._shard_of_trial(trial.name).create_trial(trial)

    def get_trial(self, trial_name):
        return self._shard_of_trial(trial_name).get_trial(trial_name)

    def update_trial(self, trial):
        return self._shard_of_trial(trial.name).update_trial(trial)

    def delete_trial(self, trial_name):
        return self._shard_of_trial(trial_name).delete_trial(trial_name)

    def list_trials(self, study_name, *, states=None):
        return self.shard_for(study_name).list_trials(study_name, states=states)

    def max_trial_id(self, study_name):
        return self.shard_for(study_name).max_trial_id(study_name)

    # -- suggestion operations --------------------------------------------

    def create_suggestion_operation(self, operation):
        return self._shard_of_operation(operation.name).create_suggestion_operation(
            operation
        )

    def get_suggestion_operation(self, operation_name):
        return self._shard_of_operation(operation_name).get_suggestion_operation(
            operation_name
        )

    def update_suggestion_operation(self, operation):
        return self._shard_of_operation(operation.name).update_suggestion_operation(
            operation
        )

    def list_suggestion_operations(
        self, study_name, client_id, filter_fn=None, *, done=None
    ):
        return self.shard_for(study_name).list_suggestion_operations(
            study_name, client_id, filter_fn, done=done
        )

    def max_suggestion_operation_number(self, study_name, client_id):
        return self.shard_for(study_name).max_suggestion_operation_number(
            study_name, client_id
        )

    # -- early stopping operations ----------------------------------------

    def create_early_stopping_operation(self, operation):
        return self._shard_of_es_operation(
            operation.name
        ).create_early_stopping_operation(operation)

    def get_early_stopping_operation(self, operation_name):
        return self._shard_of_es_operation(
            operation_name
        ).get_early_stopping_operation(operation_name)

    def update_early_stopping_operation(self, operation):
        return self._shard_of_es_operation(
            operation.name
        ).update_early_stopping_operation(operation)

    # -- metadata ----------------------------------------------------------

    def update_metadata(self, study_name, study_metadata, trial_metadata):
        return self.shard_for(study_name).update_metadata(
            study_name, study_metadata, trial_metadata
        )
