"""In-RAM datastore: nested dicts, single lock, pass-by-value.

A copy of the JAX package's ``service/ram_datastore.py``.
Protos are copied on the way in and out so callers can never mutate stored
state behind the lock.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterable, List, Optional

from vizier_tpu_torch.service import datastore
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import key_value_pb2, study_pb2, vizier_service_pb2


def _copy(proto):
    out = type(proto)()
    out.CopyFrom(proto)
    return out


# Trial states the suggest hot path scans for. The open/undone indexes
# below exist because even a filter-before-copy listing still iterates a
# study's whole history per call — measured as the residual O(n) after the
# copy cost was removed (suggest 0.4 -> 2.9 ms/round from 0 to 5k trials).
_OPEN_TRIAL_STATES = frozenset(
    (study_pb2.Trial.ACTIVE, study_pb2.Trial.REQUESTED)
)


class _StudyNode:
    def __init__(self, study: study_pb2.Study):
        self.study = study
        self.trials: Dict[int, study_pb2.Trial] = {}
        # ids of trials currently in an open (ACTIVE/REQUESTED) state —
        # kept in sync by every trial write under the datastore lock.
        self.open_trial_ids: set = set()
        # client_id -> {operation_number -> Operation}
        self.suggestion_ops: Dict[str, Dict[int, vizier_service_pb2.Operation]] = (
            collections.defaultdict(dict)
        )
        # client_id -> op numbers with done == False, same sync contract.
        self.undone_op_numbers: Dict[str, set] = collections.defaultdict(set)
        # Tracked maxima (the per-suggest id-allocation reads): updated on
        # create, recomputed only when the current max is deleted.
        self.max_trial: int = 0
        self.max_op_number: Dict[str, int] = collections.defaultdict(int)
        # trial_id -> EarlyStoppingOperation
        self.early_stopping_ops: Dict[str, vizier_service_pb2.EarlyStoppingOperation] = {}


class NestedDictRAMDataStore(datastore.DataStore):
    def __init__(self):
        self._lock = threading.Lock()
        # owner_id -> study_id -> _StudyNode
        self._owners: Dict[str, Dict[str, _StudyNode]] = collections.defaultdict(dict)

    # -- internal helpers (caller holds the lock) -------------------------

    def _node(self, study_name: str) -> _StudyNode:
        r = resources.StudyResource.from_name(study_name)
        try:
            return self._owners[r.owner_id][r.study_id]
        except KeyError:
            raise datastore.NotFoundError(f"No such study: {study_name}")

    # -- studies -----------------------------------------------------------

    def create_study(self, study: study_pb2.Study) -> str:
        r = resources.StudyResource.from_name(study.name)
        with self._lock:
            if r.study_id in self._owners[r.owner_id]:
                raise datastore.AlreadyExistsError(f"Study exists: {study.name}")
            self._owners[r.owner_id][r.study_id] = _StudyNode(_copy(study))
        return study.name

    def load_study(self, study_name: str) -> study_pb2.Study:
        with self._lock:
            return _copy(self._node(study_name).study)

    def update_study(self, study: study_pb2.Study) -> str:
        with self._lock:
            node = self._node(study.name)
            node.study = _copy(study)
        return study.name

    def delete_study(self, study_name: str) -> None:
        r = resources.StudyResource.from_name(study_name)
        with self._lock:
            if r.study_id not in self._owners.get(r.owner_id, {}):
                raise datastore.NotFoundError(f"No such study: {study_name}")
            del self._owners[r.owner_id][r.study_id]

    def list_studies(self, owner_name: str) -> List[study_pb2.Study]:
        r = resources.OwnerResource.from_name(owner_name)
        with self._lock:
            return [_copy(n.study) for n in self._owners.get(r.owner_id, {}).values()]

    # -- trials ------------------------------------------------------------

    def create_trial(self, trial: study_pb2.Trial) -> str:
        r = resources.TrialResource.from_name(trial.name)
        with self._lock:
            node = self._node(r.study_resource.name)
            if r.trial_id in node.trials:
                raise datastore.AlreadyExistsError(f"Trial exists: {trial.name}")
            node.trials[r.trial_id] = _copy(trial)
            if trial.state in _OPEN_TRIAL_STATES:
                node.open_trial_ids.add(r.trial_id)
            node.max_trial = max(node.max_trial, r.trial_id)
        return trial.name

    def get_trial(self, trial_name: str) -> study_pb2.Trial:
        r = resources.TrialResource.from_name(trial_name)
        with self._lock:
            node = self._node(r.study_resource.name)
            if r.trial_id not in node.trials:
                raise datastore.NotFoundError(f"No such trial: {trial_name}")
            return _copy(node.trials[r.trial_id])

    def update_trial(self, trial: study_pb2.Trial) -> str:
        r = resources.TrialResource.from_name(trial.name)
        with self._lock:
            node = self._node(r.study_resource.name)
            if r.trial_id not in node.trials:
                raise datastore.NotFoundError(f"No such trial: {trial.name}")
            node.trials[r.trial_id] = _copy(trial)
            if trial.state in _OPEN_TRIAL_STATES:
                node.open_trial_ids.add(r.trial_id)
            else:
                node.open_trial_ids.discard(r.trial_id)
        return trial.name

    def delete_trial(self, trial_name: str) -> None:
        r = resources.TrialResource.from_name(trial_name)
        with self._lock:
            node = self._node(r.study_resource.name)
            if r.trial_id not in node.trials:
                raise datastore.NotFoundError(f"No such trial: {trial_name}")
            del node.trials[r.trial_id]
            node.open_trial_ids.discard(r.trial_id)
            if r.trial_id == node.max_trial:
                node.max_trial = max(node.trials.keys(), default=0)

    def trial_states(self, study_name: str) -> List[tuple]:
        """Copy-free ``(id, state)`` scan — the speculative fingerprint read
        stays O(n) integer pairs even when trials carry long measurement
        histories."""
        with self._lock:
            node = self._node(study_name)
            return [(tid, t.state) for tid, t in sorted(node.trials.items())]

    def list_trials(
        self, study_name: str, *, states: Optional[tuple] = None
    ) -> List[study_pb2.Trial]:
        with self._lock:
            node = self._node(study_name)
            if states is not None and _OPEN_TRIAL_STATES.issuperset(states):
                # Hot path (suggest): walk only the open index — O(open),
                # not O(history).
                return [
                    _copy(node.trials[tid])
                    for tid in sorted(node.open_trial_ids)
                    if node.trials[tid].state in states
                ]
            # General listings filter before the copy (completed history
            # dominates a long study).
            return [
                _copy(t)
                for _, t in sorted(node.trials.items())
                if states is None or t.state in states
            ]

    def max_trial_id(self, study_name: str) -> int:
        with self._lock:
            return self._node(study_name).max_trial

    # -- suggestion operations --------------------------------------------

    def create_suggestion_operation(
        self, operation: vizier_service_pb2.Operation
    ) -> str:
        r = resources.SuggestionOperationResource.from_name(operation.name)
        with self._lock:
            node = self._node(
                resources.StudyResource(r.owner_id, r.study_id).name
            )
            ops = node.suggestion_ops[r.client_id]
            if r.operation_number in ops:
                raise datastore.AlreadyExistsError(f"Operation exists: {operation.name}")
            ops[r.operation_number] = _copy(operation)
            if not operation.done:
                node.undone_op_numbers[r.client_id].add(r.operation_number)
            node.max_op_number[r.client_id] = max(
                node.max_op_number[r.client_id], r.operation_number
            )
        return operation.name

    def get_suggestion_operation(
        self, operation_name: str
    ) -> vizier_service_pb2.Operation:
        r = resources.SuggestionOperationResource.from_name(operation_name)
        with self._lock:
            node = self._node(resources.StudyResource(r.owner_id, r.study_id).name)
            ops = node.suggestion_ops.get(r.client_id, {})
            if r.operation_number not in ops:
                raise datastore.NotFoundError(f"No such operation: {operation_name}")
            return _copy(ops[r.operation_number])

    def update_suggestion_operation(
        self, operation: vizier_service_pb2.Operation
    ) -> str:
        r = resources.SuggestionOperationResource.from_name(operation.name)
        with self._lock:
            node = self._node(resources.StudyResource(r.owner_id, r.study_id).name)
            ops = node.suggestion_ops.get(r.client_id, {})
            if r.operation_number not in ops:
                raise datastore.NotFoundError(f"No such operation: {operation.name}")
            ops[r.operation_number] = _copy(operation)
            if operation.done:
                node.undone_op_numbers[r.client_id].discard(r.operation_number)
            else:
                node.undone_op_numbers[r.client_id].add(r.operation_number)
        return operation.name

    def list_suggestion_operations(
        self,
        study_name: str,
        client_id: str,
        filter_fn: Optional[Callable[[vizier_service_pb2.Operation], bool]] = None,
        *,
        done: Optional[bool] = None,
    ) -> List[vizier_service_pb2.Operation]:
        with self._lock:
            node = self._node(study_name)
            client_ops = node.suggestion_ops.get(client_id, {})
            if done is False:
                # Hot path (suggest dedup): walk only the undone index —
                # O(undone), not O(session history).
                candidates = [
                    client_ops[num]
                    for num in sorted(node.undone_op_numbers.get(client_id, ()))
                ]
            else:
                candidates = [op for _, op in sorted(client_ops.items())]
            # Filter BEFORE copying: op protos embed their suggested trials,
            # so copy-then-filter makes every SuggestTrials dedup check
            # deep-copy the study's entire operation history (O(n) copies
            # per suggest, O(n^2) for a session — measured 2.3x throughput
            # loss at 200 trials). filter_fn runs on the live proto under
            # the NON-REENTRANT datastore lock: it must not mutate its
            # argument and must not call back into this datastore (all
            # in-tree callers are pure predicates like `not op.done`).
            ops = [
                _copy(op)
                for op in candidates
                if (done is None or op.done == done)
                and (filter_fn is None or filter_fn(op))
            ]
        return ops

    def max_suggestion_operation_number(self, study_name: str, client_id: str) -> int:
        with self._lock:
            node = self._node(study_name)
            return node.max_op_number.get(client_id, 0)

    # -- early stopping operations ----------------------------------------

    def create_early_stopping_operation(
        self, operation: vizier_service_pb2.EarlyStoppingOperation
    ) -> str:
        r = resources.EarlyStoppingOperationResource.from_name(operation.name)
        with self._lock:
            node = self._node(resources.StudyResource(r.owner_id, r.study_id).name)
            node.early_stopping_ops[operation.name] = _copy(operation)
        return operation.name

    def get_early_stopping_operation(
        self, operation_name: str
    ) -> vizier_service_pb2.EarlyStoppingOperation:
        r = resources.EarlyStoppingOperationResource.from_name(operation_name)
        with self._lock:
            node = self._node(resources.StudyResource(r.owner_id, r.study_id).name)
            if operation_name not in node.early_stopping_ops:
                raise datastore.NotFoundError(f"No such operation: {operation_name}")
            return _copy(node.early_stopping_ops[operation_name])

    def update_early_stopping_operation(
        self, operation: vizier_service_pb2.EarlyStoppingOperation
    ) -> str:
        r = resources.EarlyStoppingOperationResource.from_name(operation.name)
        with self._lock:
            node = self._node(resources.StudyResource(r.owner_id, r.study_id).name)
            if operation.name not in node.early_stopping_ops:
                raise datastore.NotFoundError(f"No such operation: {operation.name}")
            node.early_stopping_ops[operation.name] = _copy(operation)
        return operation.name

    # -- snapshot export ---------------------------------------------------

    def export_protos(self):
        """Copies of every stored proto: (studies, trials, ops, es_ops).

        One consistent cut under the lock, in deterministic (sorted) order —
        the snapshot/replication layers (``vizier_tpu_torch.distributed.wal``)
        serialize these into compacted WAL records. Suggestion ops are
        ordered (client_id, op_number) within a study; trials by id.
        """
        studies, trials, ops, es_ops = [], [], [], []
        with self._lock:
            for owner_id in sorted(self._owners):
                for study_id in sorted(self._owners[owner_id]):
                    node = self._owners[owner_id][study_id]
                    studies.append(_copy(node.study))
                    trials.extend(
                        _copy(t) for _, t in sorted(node.trials.items())
                    )
                    for client_id in sorted(node.suggestion_ops):
                        ops.extend(
                            _copy(op)
                            for _, op in sorted(
                                node.suggestion_ops[client_id].items()
                            )
                        )
                    es_ops.extend(
                        _copy(op)
                        for _, op in sorted(node.early_stopping_ops.items())
                    )
        return studies, trials, ops, es_ops

    # -- metadata ----------------------------------------------------------

    def update_metadata(
        self,
        study_name: str,
        study_metadata: Iterable[key_value_pb2.KeyValue],
        trial_metadata: Iterable,
    ) -> None:
        with self._lock:
            node = self._node(study_name)
            merge_key_values(node.study.study_spec.metadata, study_metadata)
            r = resources.StudyResource.from_name(study_name)
            for trial_id, kv in trial_metadata:
                if trial_id not in node.trials:
                    raise datastore.NotFoundError(
                        f"No such trial {trial_id} in {study_name}"
                    )
                merge_key_values(node.trials[trial_id].metadata, [kv])


def merge_key_values(existing_field, new_kvs) -> None:
    """Merges KeyValues into a repeated field ((ns, key) unique)."""
    for kv in new_kvs:
        for old in existing_field:
            if old.ns == kv.ns and old.key == kv.key:
                old.CopyFrom(kv)
                break
        else:
            existing_field.add().CopyFrom(kv)
