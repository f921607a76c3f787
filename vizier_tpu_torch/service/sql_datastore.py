"""SQLite datastore: the same contract over stdlib sqlite3.

A copy of the JAX package's ``service/sql_datastore.py``: the same table
schema and the same proto-blob encoding (the port's messages serialize to
the JAX package's bytes), so either package reads the other's database. Supports
``sqlite:///:memory:`` and ``sqlite:////path/to.db`` URLs. Thread-safe via one connection guarded by a lock (the service layer
serializes per-study writes anyway).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Callable, Iterable, List, Optional

from vizier_tpu_torch.service import datastore
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import key_value_pb2, study_pb2, vizier_service_pb2

SQL_MEMORY_URL = "sqlite:///:memory:"


def _path_from_url(url: str) -> str:
    if not url.startswith("sqlite:///"):
        raise ValueError(f"Only sqlite:/// URLs are supported, got {url!r}")
    return url[len("sqlite:///") :]


_SCHEMA = """
CREATE TABLE IF NOT EXISTS studies (
  name TEXT PRIMARY KEY,
  owner TEXT NOT NULL,
  blob BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS trials (
  name TEXT PRIMARY KEY,
  study TEXT NOT NULL,
  trial_id INTEGER NOT NULL,
  state INTEGER NOT NULL DEFAULT 0,
  blob BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS trials_by_study ON trials (study, trial_id);
CREATE TABLE IF NOT EXISTS suggestion_ops (
  name TEXT PRIMARY KEY,
  study TEXT NOT NULL,
  client_id TEXT NOT NULL,
  op_number INTEGER NOT NULL,
  done INTEGER NOT NULL DEFAULT 0,
  blob BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS ops_by_client ON suggestion_ops (study, client_id, op_number);
CREATE TABLE IF NOT EXISTS early_stopping_ops (
  name TEXT PRIMARY KEY,
  study TEXT NOT NULL,
  blob BLOB NOT NULL
);
"""


class SQLDataStore(datastore.DataStore):
    def __init__(self, url: str = SQL_MEMORY_URL):
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(_path_from_url(url), check_same_thread=False)
        with self._lock:
            self._conn.executescript(_SCHEMA)
            # Migration for databases created before the `done` column.
            # Completion is tracked by PRAGMA user_version (>= 1), NOT by
            # column presence: the ALTER autocommits immediately in the
            # sqlite3 module, so a crash mid-backfill would otherwise leave
            # the column present with every flag stuck at 0 — and done=True
            # ops misread as orphans. The backfill is idempotent, and
            # user_version flips inside the same transaction as its last
            # UPDATE, so an interrupted run simply re-runs.
            cols = {
                row[1]
                for row in self._conn.execute(
                    "PRAGMA table_info(suggestion_ops)"
                )
            }
            if "done" not in cols:
                self._conn.execute(
                    "ALTER TABLE suggestion_ops ADD COLUMN done INTEGER NOT NULL DEFAULT 0"
                )
            trial_cols = {
                row[1]
                for row in self._conn.execute("PRAGMA table_info(trials)")
            }
            if "state" not in trial_cols:
                self._conn.execute(
                    "ALTER TABLE trials ADD COLUMN state INTEGER NOT NULL DEFAULT 0"
                )
            version = self._conn.execute("PRAGMA user_version").fetchone()[0]
            if version < 1:
                for name, blob in self._conn.execute(
                    "SELECT name, blob FROM suggestion_ops"
                ).fetchall():
                    op = vizier_service_pb2.Operation.FromString(blob)
                    if op.done:
                        self._conn.execute(
                            "UPDATE suggestion_ops SET done = 1 WHERE name = ?",
                            (name,),
                        )
            if version < 2:
                for name, blob in self._conn.execute(
                    "SELECT name, blob FROM trials"
                ).fetchall():
                    t = study_pb2.Trial.FromString(blob)
                    self._conn.execute(
                        "UPDATE trials SET state = ? WHERE name = ?",
                        (int(t.state), name),
                    )
                self._conn.execute("PRAGMA user_version = 2")
            # After the column is guaranteed (fresh schema or migration).
            # Covers the dedup query's filter AND its op_number ordering.
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS ops_by_done"
                " ON suggestion_ops (study, client_id, done, op_number)"
            )
            self._conn.commit()

    # -- studies -----------------------------------------------------------

    def create_study(self, study: study_pb2.Study) -> str:
        r = resources.StudyResource.from_name(study.name)
        with self._lock:
            try:
                self._conn.execute(
                    "INSERT INTO studies (name, owner, blob) VALUES (?, ?, ?)",
                    (study.name, r.owner_id, study.SerializeToString()),
                )
                self._conn.commit()
            except sqlite3.IntegrityError:
                raise datastore.AlreadyExistsError(f"Study exists: {study.name}")
        return study.name

    def load_study(self, study_name: str) -> study_pb2.Study:
        with self._lock:
            row = self._conn.execute(
                "SELECT blob FROM studies WHERE name = ?", (study_name,)
            ).fetchone()
        if row is None:
            raise datastore.NotFoundError(f"No such study: {study_name}")
        return study_pb2.Study.FromString(row[0])

    def update_study(self, study: study_pb2.Study) -> str:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE studies SET blob = ? WHERE name = ?",
                (study.SerializeToString(), study.name),
            )
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such study: {study.name}")
        return study.name

    def delete_study(self, study_name: str) -> None:
        with self._lock:
            cur = self._conn.execute("DELETE FROM studies WHERE name = ?", (study_name,))
            self._conn.execute("DELETE FROM trials WHERE study = ?", (study_name,))
            self._conn.execute(
                "DELETE FROM suggestion_ops WHERE study = ?", (study_name,)
            )
            self._conn.execute(
                "DELETE FROM early_stopping_ops WHERE study = ?", (study_name,)
            )
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such study: {study_name}")

    def list_studies(self, owner_name: str) -> List[study_pb2.Study]:
        r = resources.OwnerResource.from_name(owner_name)
        with self._lock:
            rows = self._conn.execute(
                "SELECT blob FROM studies WHERE owner = ? ORDER BY name", (r.owner_id,)
            ).fetchall()
        return [study_pb2.Study.FromString(b) for (b,) in rows]

    def _require_study(self, study_name: str) -> None:
        row = self._conn.execute(
            "SELECT 1 FROM studies WHERE name = ?", (study_name,)
        ).fetchone()
        if row is None:
            raise datastore.NotFoundError(f"No such study: {study_name}")

    # -- trials ------------------------------------------------------------

    def create_trial(self, trial: study_pb2.Trial) -> str:
        r = resources.TrialResource.from_name(trial.name)
        with self._lock:
            self._require_study(r.study_resource.name)
            try:
                self._conn.execute(
                    "INSERT INTO trials (name, study, trial_id, state, blob)"
                    " VALUES (?, ?, ?, ?, ?)",
                    (
                        trial.name,
                        r.study_resource.name,
                        r.trial_id,
                        int(trial.state),
                        trial.SerializeToString(),
                    ),
                )
                self._conn.commit()
            except sqlite3.IntegrityError:
                raise datastore.AlreadyExistsError(f"Trial exists: {trial.name}")
        return trial.name

    def get_trial(self, trial_name: str) -> study_pb2.Trial:
        with self._lock:
            row = self._conn.execute(
                "SELECT blob FROM trials WHERE name = ?", (trial_name,)
            ).fetchone()
        if row is None:
            raise datastore.NotFoundError(f"No such trial: {trial_name}")
        return study_pb2.Trial.FromString(row[0])

    def update_trial(self, trial: study_pb2.Trial) -> str:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE trials SET blob = ?, state = ? WHERE name = ?",
                (trial.SerializeToString(), int(trial.state), trial.name),
            )
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such trial: {trial.name}")
        return trial.name

    def delete_trial(self, trial_name: str) -> None:
        with self._lock:
            cur = self._conn.execute("DELETE FROM trials WHERE name = ?", (trial_name,))
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such trial: {trial_name}")

    def list_trials(
        self, study_name: str, *, states: Optional[tuple] = None
    ) -> List[study_pb2.Trial]:
        query = "SELECT blob FROM trials WHERE study = ?"
        params: tuple = (study_name,)
        if states is not None:
            # Storage-level state filter (see datastore.DataStore contract):
            # the suggest path must not deserialize completed history.
            placeholders = ",".join("?" * len(states))
            query += f" AND state IN ({placeholders})"
            params += tuple(int(s) for s in states)
        with self._lock:
            self._require_study(study_name)
            rows = self._conn.execute(
                query + " ORDER BY trial_id", params
            ).fetchall()
        return [study_pb2.Trial.FromString(b) for (b,) in rows]

    def max_trial_id(self, study_name: str) -> int:
        with self._lock:
            self._require_study(study_name)
            row = self._conn.execute(
                "SELECT MAX(trial_id) FROM trials WHERE study = ?", (study_name,)
            ).fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    # -- suggestion operations --------------------------------------------

    def create_suggestion_operation(
        self, operation: vizier_service_pb2.Operation
    ) -> str:
        r = resources.SuggestionOperationResource.from_name(operation.name)
        study_name = resources.StudyResource(r.owner_id, r.study_id).name
        with self._lock:
            self._require_study(study_name)
            try:
                self._conn.execute(
                    "INSERT INTO suggestion_ops"
                    " (name, study, client_id, op_number, done, blob)"
                    " VALUES (?, ?, ?, ?, ?, ?)",
                    (
                        operation.name,
                        study_name,
                        r.client_id,
                        r.operation_number,
                        int(operation.done),
                        operation.SerializeToString(),
                    ),
                )
                self._conn.commit()
            except sqlite3.IntegrityError:
                raise datastore.AlreadyExistsError(f"Operation exists: {operation.name}")
        return operation.name

    def get_suggestion_operation(
        self, operation_name: str
    ) -> vizier_service_pb2.Operation:
        with self._lock:
            row = self._conn.execute(
                "SELECT blob FROM suggestion_ops WHERE name = ?", (operation_name,)
            ).fetchone()
        if row is None:
            raise datastore.NotFoundError(f"No such operation: {operation_name}")
        return vizier_service_pb2.Operation.FromString(row[0])

    def update_suggestion_operation(
        self, operation: vizier_service_pb2.Operation
    ) -> str:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE suggestion_ops SET blob = ?, done = ? WHERE name = ?",
                (
                    operation.SerializeToString(),
                    int(operation.done),
                    operation.name,
                ),
            )
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such operation: {operation.name}")
        return operation.name

    def list_suggestion_operations(
        self,
        study_name: str,
        client_id: str,
        filter_fn: Optional[Callable[[vizier_service_pb2.Operation], bool]] = None,
        *,
        done: Optional[bool] = None,
    ) -> List[vizier_service_pb2.Operation]:
        # The `done` pre-filter runs in SQL over the indexed column so the
        # hot dedup check never deserializes a session's full op history.
        query = (
            "SELECT blob FROM suggestion_ops WHERE study = ? AND client_id = ?"
        )
        params: tuple = (study_name, client_id)
        if done is not None:
            query += " AND done = ?"
            params += (int(done),)
        with self._lock:
            self._require_study(study_name)
            rows = self._conn.execute(
                query + " ORDER BY op_number", params
            ).fetchall()
        ops = [vizier_service_pb2.Operation.FromString(b) for (b,) in rows]
        if filter_fn is not None:
            ops = [op for op in ops if filter_fn(op)]
        return ops

    def max_suggestion_operation_number(self, study_name: str, client_id: str) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(op_number) FROM suggestion_ops WHERE study = ? AND client_id = ?",
                (study_name, client_id),
            ).fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    # -- early stopping operations ----------------------------------------

    def create_early_stopping_operation(
        self, operation: vizier_service_pb2.EarlyStoppingOperation
    ) -> str:
        r = resources.EarlyStoppingOperationResource.from_name(operation.name)
        study_name = resources.StudyResource(r.owner_id, r.study_id).name
        with self._lock:
            self._require_study(study_name)
            self._conn.execute(
                "INSERT OR REPLACE INTO early_stopping_ops (name, study, blob)"
                " VALUES (?, ?, ?)",
                (operation.name, study_name, operation.SerializeToString()),
            )
            self._conn.commit()
        return operation.name

    def get_early_stopping_operation(
        self, operation_name: str
    ) -> vizier_service_pb2.EarlyStoppingOperation:
        with self._lock:
            row = self._conn.execute(
                "SELECT blob FROM early_stopping_ops WHERE name = ?", (operation_name,)
            ).fetchone()
        if row is None:
            raise datastore.NotFoundError(f"No such operation: {operation_name}")
        return vizier_service_pb2.EarlyStoppingOperation.FromString(row[0])

    def update_early_stopping_operation(
        self, operation: vizier_service_pb2.EarlyStoppingOperation
    ) -> str:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE early_stopping_ops SET blob = ? WHERE name = ?",
                (operation.SerializeToString(), operation.name),
            )
            self._conn.commit()
        if cur.rowcount == 0:
            raise datastore.NotFoundError(f"No such operation: {operation.name}")
        return operation.name

    # -- metadata ----------------------------------------------------------

    def update_metadata(
        self,
        study_name: str,
        study_metadata: Iterable[key_value_pb2.KeyValue],
        trial_metadata: Iterable,
    ) -> None:
        with self._lock:
            row = self._conn.execute(
                "SELECT blob FROM studies WHERE name = ?", (study_name,)
            ).fetchone()
            if row is None:
                raise datastore.NotFoundError(f"No such study: {study_name}")
            study = study_pb2.Study.FromString(row[0])
            ram_datastore.merge_key_values(study.study_spec.metadata, study_metadata)
            self._conn.execute(
                "UPDATE studies SET blob = ? WHERE name = ?",
                (study.SerializeToString(), study_name),
            )
            r = resources.StudyResource.from_name(study_name)
            for trial_id, kv in trial_metadata:
                trial_name = r.trial_resource(trial_id).name
                trow = self._conn.execute(
                    "SELECT blob FROM trials WHERE name = ?", (trial_name,)
                ).fetchone()
                if trow is None:
                    raise datastore.NotFoundError(
                        f"No such trial {trial_id} in {study_name}"
                    )
                trial = study_pb2.Trial.FromString(trow[0])
                ram_datastore.merge_key_values(trial.metadata, [kv])
                self._conn.execute(
                    "UPDATE trials SET blob = ? WHERE name = ?",
                    (trial.SerializeToString(), trial_name),
                )
            self._conn.commit()
