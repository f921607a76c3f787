"""Snapshot + write-ahead-log persistence for the RAM datastore.

``PersistentDataStore`` wraps a ``NestedDictRAMDataStore``: reads hit RAM
directly; every mutation is applied to RAM first and then appended to a
per-shard WAL as a proto-serialized record, so a replica restarted over
the same directory replays itself back to the exact pre-crash state
("restart warm"). Every ``snapshot_interval`` mutations the log is
compacted: the full store state is written as a *snapshot* — itself just a
compacted WAL whose records recreate the state — and the live log is
truncated.

Durability protocol (one writer per directory):

- ``wal.log``      — active log: ``[u32 length][u32 crc32][payload]``
  records, appended + flushed per mutation. A flush hands the record to
  the OS, so by default an acknowledged mutation survives a PROCESS
  crash only — an OS crash / power loss may still drop flushed-but-
  unsynced tail records. ``VIZIER_TORCH_DISTRIBUTED_WAL_FSYNC=1`` (or
  ``fsync=True``) adds an fsync per append, extending the guarantee to
  OS crashes at a per-mutation disk-sync cost.
- ``snapshot.bin`` — last compaction, same record framing. Written to
  ``snapshot.bin.tmp`` + fsync + atomic rename, THEN the log is truncated
  (snapshots are always fsynced, in both modes).

Crash windows:

- mid-append: the torn tail record fails its length/CRC check and is
  dropped on replay (the mutation was never acknowledged);
- corrupt record mid-log (bit rot, injected corruption): replay recovers
  the longest valid prefix, and reopening the log **quarantines** the
  invalid suffix into a ``wal.log.corrupt`` sidecar before appending —
  without the quarantine, records appended after the damage would be
  acknowledged and then silently lost on the next replay (the reader
  stops at the first bad record). The lost suffix is recoverable from a
  replication standby log (``distributed/replication.py``) when one is
  longer — failover compares sources by mutation *sequence number*,
  which snapshots record in a leading ``SNAPSHOT_META`` record;
- mid-snapshot-write: the tmp file is ignored; old snapshot + full log
  still replay;
- after the snapshot rename but before the log truncate: replay applies
  log records already folded into the snapshot — replay is *tolerant*
  (create-of-existing applies as an update, delete-of-missing is skipped),
  and re-applying a record sequence in order is state-idempotent, so the
  double apply converges to the same state.

Lock order: ``PersistentDataStore._lock`` serializes mutate+append so the
log order equals the apply order; it nests OVER the inner RAM store's lock
and the WAL's file lock, and nothing below ever calls back up (leaf-ward
only).

A copy of the JAX package's ``distributed/wal.py``: the same framing and
record vocabulary, so a directory written by either package replays in the
other (the port's protos are byte-compatible with the JAX package's).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from vizier_tpu_torch.distributed.replication import AppendSink

from vizier_tpu_torch.service import datastore as datastore_lib
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import study_pb2, vizier_service_pb2

# -- record vocabulary -----------------------------------------------------

CREATE_STUDY = 1
UPDATE_STUDY = 2
DELETE_STUDY = 3
CREATE_TRIAL = 4
UPDATE_TRIAL = 5
DELETE_TRIAL = 6
CREATE_SUGGESTION_OP = 7
UPDATE_SUGGESTION_OP = 8
CREATE_EARLY_STOPPING_OP = 9
UPDATE_EARLY_STOPPING_OP = 10
UPDATE_METADATA = 11
# A snapshot's first record: its payload is the origin's mutation sequence
# number at compaction time (u64). Pure bookkeeping — replay skips it; it
# is what lets a failover compare a local WAL against a replication
# standby log by *sequence number* rather than by incomparable record
# counts (a snapshot compacts history, so its record count is not its
# mutation count).
SNAPSHOT_META = 12

_OPCODES = frozenset(range(CREATE_STUDY, SNAPSHOT_META + 1))
DATA_OPCODES = frozenset(range(CREATE_STUDY, UPDATE_METADATA + 1))

_HEADER = struct.Struct("<II")  # payload length, crc32(opcode byte + payload)
_SEQ = struct.Struct("<Q")

SNAPSHOT_FILE = "snapshot.bin"
LOG_FILE = "wal.log"
CORRUPT_SUFFIX = ".corrupt"


def study_key_of(opcode: int, payload: bytes) -> str:
    """The owning study resource name of a record (failover re-placement)."""
    if opcode in (CREATE_STUDY, UPDATE_STUDY):
        study = study_pb2.Study.FromString(payload)
        return study.name
    if opcode == DELETE_STUDY:
        return payload.decode("utf-8")
    if opcode in (CREATE_TRIAL, UPDATE_TRIAL):
        trial = study_pb2.Trial.FromString(payload)
        return resources.TrialResource.from_name(trial.name).study_resource.name
    if opcode == DELETE_TRIAL:
        name = payload.decode("utf-8")
        return resources.TrialResource.from_name(name).study_resource.name
    if opcode in (CREATE_SUGGESTION_OP, UPDATE_SUGGESTION_OP):
        op = vizier_service_pb2.Operation.FromString(payload)
        r = resources.SuggestionOperationResource.from_name(op.name)
        return resources.StudyResource(r.owner_id, r.study_id).name
    if opcode in (CREATE_EARLY_STOPPING_OP, UPDATE_EARLY_STOPPING_OP):
        op = vizier_service_pb2.EarlyStoppingOperation.FromString(payload)
        r = resources.EarlyStoppingOperationResource.from_name(op.name)
        return resources.StudyResource(r.owner_id, r.study_id).name
    if opcode == UPDATE_METADATA:
        req = vizier_service_pb2.UpdateMetadataRequest.FromString(payload)
        return req.name
    raise ValueError(f"Unknown WAL opcode: {opcode}")


def split_meta(records: List[Tuple[int, bytes]]) -> Tuple[int, List[Tuple[int, bytes]]]:
    """``(base_seq, data_records)`` of a snapshot record sequence.

    A snapshot written by this version starts with a :data:`SNAPSHOT_META`
    record carrying the mutation sequence the compaction folded up to.
    Older snapshots have no meta record; their record count stands in as
    the base (each compacted record was at least one mutation) — an
    approximation that only matters for standby-vs-local comparisons, and
    pre-replication directories have no standby logs to compare against.
    """
    if records and records[0][0] == SNAPSHOT_META:
        return int(_SEQ.unpack(records[0][1])[0]), records[1:]
    return len(records), list(records)


class WriteAheadLog:
    """Append-only mutation log with atomic snapshot compaction."""

    def __init__(self, directory: str, *, fsync: bool = False):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()  # file handle + counters only
        self._fsync = fsync
        self._log_path = os.path.join(directory, LOG_FILE)
        self._snapshot_path = os.path.join(directory, SNAPSHOT_FILE)
        # Quarantine BEFORE opening for append: a log with a corrupt or
        # torn record mid-file must not be appended past it — replay stops
        # at the first bad record, so anything written after the damage
        # would be acknowledged and then silently lost on the next replay.
        # The invalid suffix moves to a ``wal.log.corrupt`` sidecar (kept
        # for forensics) and the live log truncates to its longest valid
        # prefix.
        self.quarantined_bytes = self._quarantine_invalid_suffix(
            self._log_path
        )
        self._log = open(self._log_path, "ab")
        self._appended = 0

    # -- framing -----------------------------------------------------------

    @staticmethod
    def _frame(opcode: int, payload: bytes) -> bytes:
        if opcode not in _OPCODES:
            raise ValueError(f"Unknown WAL opcode: {opcode}")
        body = bytes((opcode,)) + payload
        return _HEADER.pack(len(body), zlib.crc32(body)) + body

    @staticmethod
    def _valid_prefix_end(data: bytes) -> int:
        """Byte offset where the valid record prefix of ``data`` ends."""
        offset = 0
        while offset < len(data):
            if offset + _HEADER.size > len(data):
                return offset
            length, crc = _HEADER.unpack_from(data, offset)
            start = offset + _HEADER.size
            end = start + length
            if length < 1 or end > len(data):
                return offset
            if zlib.crc32(data[start:end]) != crc:
                return offset
            offset = end
        return offset

    @classmethod
    def _quarantine_invalid_suffix(cls, path: str) -> int:
        """Moves everything past the longest valid record prefix of
        ``path`` into ``path + '.corrupt'``; returns the bytes moved."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return 0
        end = cls._valid_prefix_end(data)
        if end >= len(data):
            return 0
        suffix = data[end:]
        with open(path + CORRUPT_SUFFIX, "ab") as sidecar:
            sidecar.write(suffix)
            sidecar.flush()
            os.fsync(sidecar.fileno())
        with open(path, "r+b") as f:
            f.truncate(end)
            f.flush()
            os.fsync(f.fileno())
        return len(suffix)

    @staticmethod
    def _read_records(path: str) -> Tuple[List[Tuple[int, bytes]], bool]:
        """Records of one file; second element is True when a torn/corrupt
        suffix was dropped. Reading stops at the first bad record: with one
        appender flushing sequentially damage is normally a tail, and a
        mid-log corruption (bit rot, an injected ``wal_corrupt`` chaos
        event) makes everything after it unreadable — the longest valid
        prefix is what this returns, and :meth:`_quarantine_invalid_suffix`
        is what keeps a reopened log from appending past the damage."""
        records: List[Tuple[int, bytes]] = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return records, False
        offset = 0
        while offset < len(data):
            if offset + _HEADER.size > len(data):
                return records, True  # torn header
            length, crc = _HEADER.unpack_from(data, offset)
            start = offset + _HEADER.size
            end = start + length
            if length < 1 or end > len(data):
                return records, True  # torn payload
            body = data[start:end]
            if zlib.crc32(body) != crc:
                return records, True  # corrupt tail
            records.append((body[0], body[1:]))
            offset = end
        return records, False

    # -- API ---------------------------------------------------------------

    def append(self, opcode: int, payload: bytes) -> None:
        frame = self._frame(opcode, payload)
        with self._lock:
            self._log.write(frame)
            self._log.flush()
            if self._fsync:
                os.fsync(self._log.fileno())
            self._appended += 1

    @property
    def appended_since_snapshot(self) -> int:
        with self._lock:
            return self._appended

    def load(self) -> Tuple[List[Tuple[int, bytes]], bool]:
        """Snapshot records + live log records, in apply order.

        Second element reports whether a torn/corrupt log tail was dropped
        (a crash mid-append, or — without per-append fsync — an OS crash
        that lost flushed-but-unsynced tail records).
        """
        records, torn, _seq = self.load_with_seq()
        return records, torn

    def load_with_seq(self) -> Tuple[List[Tuple[int, bytes]], bool, int]:
        """Like :meth:`load`, plus the mutation sequence number the loaded
        state corresponds to (snapshot meta base + live log records)."""
        snapshot_records, snapshot_torn = self._read_records(self._snapshot_path)
        if snapshot_torn:
            # A torn snapshot can only be a crashed *tmp* promoted by an
            # outside force; never trust it over replaying nothing.
            snapshot_records = []
        base_seq, snapshot_records = split_meta(snapshot_records)
        log_records, log_torn = self._read_records(self._log_path)
        log_records = [r for r in log_records if r[0] != SNAPSHOT_META]
        return (
            snapshot_records + log_records,
            log_torn or snapshot_torn,
            base_seq + len(log_records),
        )

    def compact(
        self,
        records: Iterable[Tuple[int, bytes]],
        *,
        seq: Optional[int] = None,
    ) -> None:
        """Atomically replaces the snapshot with ``records``, truncates the log.

        ``seq`` (the store's mutation sequence at compaction time) is
        recorded as the snapshot's leading :data:`SNAPSHOT_META` record so
        a later reader can place the snapshot on the origin's sequence
        axis. The caller must hold whatever lock serializes its mutations
        (the compaction must see a quiescent state and no append may
        interleave with the truncate).
        """
        tmp_path = self._snapshot_path + ".tmp"
        with self._lock:
            with open(tmp_path, "wb") as f:
                if seq is not None:
                    f.write(self._frame(SNAPSHOT_META, _SEQ.pack(int(seq))))
                for opcode, payload in records:
                    f.write(self._frame(opcode, payload))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp_path, self._snapshot_path)
            # Crash between replace and truncate double-applies the log
            # over the snapshot — tolerated by replay (module docstring).
            self._log.close()
            self._log = open(self._log_path, "wb")
            self._appended = 0

    def close(self) -> None:
        with self._lock:
            try:
                self._log.close()
            except Exception:
                pass


class StoreDivergedError(RuntimeError):
    """The RAM state and the WAL no longer agree (a log write failed after
    its mutation was applied); the store fail-stops rather than serve
    state a restart would silently revert."""


class PersistentDataStore(datastore_lib.DataStore):
    """RAM datastore + snapshot/WAL durability (one writer per directory)."""

    def __init__(
        self,
        directory: str,
        *,
        snapshot_interval: Optional[int] = None,
        fsync: Optional[bool] = None,
        inner: Optional[ram_datastore.NestedDictRAMDataStore] = None,
        on_append: Optional["AppendSink"] = None,
    ):
        from vizier_tpu_torch.distributed import config as config_lib

        env = config_lib.DistributedConfig.from_env()
        self._inner = inner or ram_datastore.NestedDictRAMDataStore()
        self._wal = WriteAheadLog(
            directory, fsync=env.wal_fsync if fsync is None else fsync
        )
        self._snapshot_interval = (
            snapshot_interval
            if snapshot_interval is not None
            else env.snapshot_interval
        )
        # Serializes apply+append so log order == apply order; nests over
        # the inner store's lock and the WAL file lock only.
        self._lock = threading.Lock()
        self._diverged: Optional[str] = None
        # Post-append observer (the WAL replication streamer): its
        # ``submit(seq, opcode, payload)`` runs AFTER the record is
        # durably appended, still under ``self._lock`` so the observed
        # order equals the log order. Must be non-blocking and never
        # raise usefully — failures are swallowed (replication is
        # redundancy, not the write path).
        self._on_append: Optional["AppendSink"] = on_append
        records, loaded_torn, self._seq = self._wal.load_with_seq()
        # Torn/corrupt damage now surfaces as quarantined bytes (the WAL
        # moved the invalid suffix aside before this load), but the flag
        # keeps meaning "the directory carried damage we dropped".
        self.recovered_quarantined_bytes = self._wal.quarantined_bytes
        self.recovered_torn_tail = (
            loaded_torn or self._wal.quarantined_bytes > 0
        )
        self.recovered_records = len(records)
        for opcode, payload in records:
            apply_record(self._inner, opcode, payload)

    # -- plumbing ----------------------------------------------------------

    @property
    def wal(self) -> WriteAheadLog:
        return self._wal

    @property
    def seq(self) -> int:
        """The store's monotonic mutation sequence number (replication
        stream positions and failover source comparisons key off it)."""
        with self._lock:
            return self._seq

    def export_with_seq(self) -> Tuple[int, List[Tuple[int, bytes]]]:
        """An atomic ``(seq, compacted records)`` snapshot of the store —
        the replication baseline: a successor that applies the records and
        remembers the seq holds exactly the state at that sequence."""
        with self._lock:
            self._check_converged()
            return self._seq, export_records(self._inner)

    def _check_converged(self) -> None:
        if self._diverged is not None:
            raise StoreDivergedError(self._diverged)

    def _mutate(self, fn, opcode: int, payload: bytes):
        """Applies ``fn`` to the inner store, then logs it (apply-then-log:
        a rejected mutation — duplicate create, missing target — raises
        before anything reaches the log).

        A FAILED log write after the apply is a fail-stop: the RAM state
        now holds a mutation the WAL lost, so instead of serving state a
        restart would silently revert, the store poisons itself and every
        subsequent operation raises :class:`StoreDivergedError`.
        """
        with self._lock:
            self._check_converged()
            result = fn()
            try:
                self._wal.append(opcode, payload)
                self._seq += 1
                if self._wal.appended_since_snapshot >= self._snapshot_interval:
                    self._wal.compact(
                        export_records(self._inner), seq=self._seq
                    )
            except BaseException as e:
                self._diverged = (
                    f"WAL write failed after the mutation was applied "
                    f"({type(e).__name__}: {e}); RAM and log have diverged "
                    f"— restart the replica to recover to the logged state."
                )
                raise
            if self._on_append is not None:
                try:
                    self._on_append.submit(self._seq, opcode, payload)
                except Exception:  # replication is redundancy, not the
                    pass  # write path: a streamer fault must not fail RPCs
        return result

    def compact_now(self) -> None:
        """Forces a snapshot compaction (tests, graceful shutdown)."""
        with self._lock:
            self._check_converged()
            self._wal.compact(export_records(self._inner), seq=self._seq)

    def set_append_sink(self, sink: Optional["AppendSink"]) -> None:
        """Attaches (or replaces) the post-append replication observer —
        subprocess replicas build the datastore first (the WAL replay must
        not re-stream history) and hook the streamer in afterwards."""
        with self._lock:
            self._on_append = sink

    def close(self) -> None:
        self._wal.close()

    # -- studies -----------------------------------------------------------

    def create_study(self, study):
        return self._mutate(
            lambda: self._inner.create_study(study),
            CREATE_STUDY,
            study.SerializeToString(),
        )

    def load_study(self, study_name):
        self._check_converged()
        return self._inner.load_study(study_name)

    def update_study(self, study):
        return self._mutate(
            lambda: self._inner.update_study(study),
            UPDATE_STUDY,
            study.SerializeToString(),
        )

    def delete_study(self, study_name):
        return self._mutate(
            lambda: self._inner.delete_study(study_name),
            DELETE_STUDY,
            study_name.encode("utf-8"),
        )

    def list_studies(self, owner_name):
        self._check_converged()
        return self._inner.list_studies(owner_name)

    # -- trials ------------------------------------------------------------

    def create_trial(self, trial):
        return self._mutate(
            lambda: self._inner.create_trial(trial),
            CREATE_TRIAL,
            trial.SerializeToString(),
        )

    def get_trial(self, trial_name):
        self._check_converged()
        return self._inner.get_trial(trial_name)

    def update_trial(self, trial):
        return self._mutate(
            lambda: self._inner.update_trial(trial),
            UPDATE_TRIAL,
            trial.SerializeToString(),
        )

    def delete_trial(self, trial_name):
        return self._mutate(
            lambda: self._inner.delete_trial(trial_name),
            DELETE_TRIAL,
            trial_name.encode("utf-8"),
        )

    def list_trials(self, study_name, *, states=None):
        self._check_converged()
        return self._inner.list_trials(study_name, states=states)

    def max_trial_id(self, study_name):
        self._check_converged()
        return self._inner.max_trial_id(study_name)

    # -- suggestion operations --------------------------------------------

    def create_suggestion_operation(self, operation):
        return self._mutate(
            lambda: self._inner.create_suggestion_operation(operation),
            CREATE_SUGGESTION_OP,
            operation.SerializeToString(),
        )

    def get_suggestion_operation(self, operation_name):
        self._check_converged()
        return self._inner.get_suggestion_operation(operation_name)

    def update_suggestion_operation(self, operation):
        return self._mutate(
            lambda: self._inner.update_suggestion_operation(operation),
            UPDATE_SUGGESTION_OP,
            operation.SerializeToString(),
        )

    def list_suggestion_operations(
        self, study_name, client_id, filter_fn=None, *, done=None
    ):
        self._check_converged()
        return self._inner.list_suggestion_operations(
            study_name, client_id, filter_fn, done=done
        )

    def max_suggestion_operation_number(self, study_name, client_id):
        self._check_converged()
        return self._inner.max_suggestion_operation_number(study_name, client_id)

    # -- early stopping operations ----------------------------------------

    def create_early_stopping_operation(self, operation):
        return self._mutate(
            lambda: self._inner.create_early_stopping_operation(operation),
            CREATE_EARLY_STOPPING_OP,
            operation.SerializeToString(),
        )

    def get_early_stopping_operation(self, operation_name):
        self._check_converged()
        return self._inner.get_early_stopping_operation(operation_name)

    def update_early_stopping_operation(self, operation):
        return self._mutate(
            lambda: self._inner.update_early_stopping_operation(operation),
            UPDATE_EARLY_STOPPING_OP,
            operation.SerializeToString(),
        )

    # -- metadata ----------------------------------------------------------

    def update_metadata(self, study_name, study_metadata, trial_metadata):
        # Materialize the iterables once: they are consumed both by the
        # store apply and the wire record.
        study_kvs = list(study_metadata)
        trial_kvs = [(int(tid), kv) for tid, kv in trial_metadata]
        request = vizier_service_pb2.UpdateMetadataRequest(name=study_name)
        for kv in study_kvs:
            unit = request.deltas.add()
            unit.trial_id = 0
            unit.key_value.CopyFrom(kv)
        for trial_id, kv in trial_kvs:
            unit = request.deltas.add()
            unit.trial_id = trial_id
            unit.key_value.CopyFrom(kv)
        return self._mutate(
            lambda: self._inner.update_metadata(study_name, study_kvs, trial_kvs),
            UPDATE_METADATA,
            request.SerializeToString(),
        )


# -- replay / snapshot helpers ---------------------------------------------


def export_records(
    store: ram_datastore.NestedDictRAMDataStore,
) -> List[Tuple[int, bytes]]:
    """The store's full state as a compacted record sequence.

    Replaying these records into an empty store recreates the state —
    a snapshot IS a compacted WAL, so there is exactly one on-disk format
    and one replay path.
    """
    studies, trials, ops, es_ops = store.export_protos()
    records: List[Tuple[int, bytes]] = []
    for study in studies:
        records.append((CREATE_STUDY, study.SerializeToString()))
    for trial in trials:
        records.append((CREATE_TRIAL, trial.SerializeToString()))
    for op in ops:
        records.append((CREATE_SUGGESTION_OP, op.SerializeToString()))
    for op in es_ops:
        records.append((CREATE_EARLY_STOPPING_OP, op.SerializeToString()))
    return records


def apply_record(
    store: datastore_lib.DataStore, opcode: int, payload: bytes
) -> None:
    """Applies one record to ``store``, tolerantly.

    Tolerant replay is what makes the crash windows safe: a create of an
    existing resource applies as an update (double-applied log over a
    fresh snapshot), a delete/update of a missing resource is skipped
    (the delete already happened / its study was deleted later in the
    log). Applying a record SEQUENCE in order therefore always converges
    to the state the sequence describes.
    """
    if opcode in (CREATE_STUDY, UPDATE_STUDY):
        study = study_pb2.Study.FromString(payload)
        try:
            store.create_study(study)
        except datastore_lib.AlreadyExistsError:
            store.update_study(study)
    elif opcode == DELETE_STUDY:
        try:
            store.delete_study(payload.decode("utf-8"))
        except datastore_lib.NotFoundError:
            pass
    elif opcode in (CREATE_TRIAL, UPDATE_TRIAL):
        trial = study_pb2.Trial.FromString(payload)
        try:
            try:
                store.create_trial(trial)
            except datastore_lib.AlreadyExistsError:
                store.update_trial(trial)
        except datastore_lib.NotFoundError:
            pass  # study deleted later in the log
    elif opcode == DELETE_TRIAL:
        try:
            store.delete_trial(payload.decode("utf-8"))
        except datastore_lib.NotFoundError:
            pass
    elif opcode in (CREATE_SUGGESTION_OP, UPDATE_SUGGESTION_OP):
        op = vizier_service_pb2.Operation.FromString(payload)
        try:
            try:
                store.create_suggestion_operation(op)
            except datastore_lib.AlreadyExistsError:
                store.update_suggestion_operation(op)
        except datastore_lib.NotFoundError:
            pass
    elif opcode in (CREATE_EARLY_STOPPING_OP, UPDATE_EARLY_STOPPING_OP):
        op = vizier_service_pb2.EarlyStoppingOperation.FromString(payload)
        try:
            # create doubles as upsert for early-stopping ops in the RAM
            # store, but go through update for missing-create symmetry.
            store.create_early_stopping_operation(op)
        except datastore_lib.NotFoundError:
            pass
    elif opcode == UPDATE_METADATA:
        request = vizier_service_pb2.UpdateMetadataRequest.FromString(payload)
        study_kvs = [d.key_value for d in request.deltas if d.trial_id == 0]
        trial_kvs = [
            (int(d.trial_id), d.key_value)
            for d in request.deltas
            if d.trial_id != 0
        ]
        try:
            store.update_metadata(request.name, study_kvs, trial_kvs)
        except datastore_lib.NotFoundError:
            pass
    elif opcode == SNAPSHOT_META:
        pass  # bookkeeping record: carries a sequence number, no state
    else:
        raise ValueError(f"Unknown WAL opcode: {opcode}")


def read_directory(
    directory: str,
) -> Tuple[List[Tuple[int, bytes]], bool]:
    """Snapshot+log records of a (possibly dead) replica's WAL directory.

    Read-only: used by failover to lift a dead replica's studies into
    their successor replicas without opening the directory for append.
    """
    records, torn = read_directory_with_seqs(directory)
    return [(opcode, payload) for _seq, opcode, payload in records], torn


def read_directory_with_seqs(
    directory: str,
) -> Tuple[List[Tuple[int, int, bytes]], bool]:
    """Like :func:`read_directory`, with each record's mutation sequence.

    Snapshot records all carry the snapshot's base sequence (they are a
    compaction of everything up to it); live log record *i* carries
    ``base + 1 + i``. Read-only and damage-tolerant: a corrupt or torn
    suffix in either file is excluded (the longest valid prefix is what a
    failover can trust), reported via the second element.
    """
    snapshot, snapshot_torn = WriteAheadLog._read_records(
        os.path.join(directory, SNAPSHOT_FILE)
    )
    if snapshot_torn:
        snapshot = []
    base_seq, snapshot = split_meta(snapshot)
    log, log_torn = WriteAheadLog._read_records(
        os.path.join(directory, LOG_FILE)
    )
    records = [(base_seq, opcode, payload) for opcode, payload in snapshot]
    offset = 0
    for opcode, payload in log:
        if opcode == SNAPSHOT_META:
            continue
        offset += 1
        records.append((base_seq + offset, opcode, payload))
    return records, log_torn or snapshot_torn


def group_by_study(
    records: Iterable[Tuple[int, int, bytes]],
) -> Dict[str, List[Tuple[int, int, bytes]]]:
    """``study -> [(seq, opcode, payload)]`` in record order (recovery
    source selection compares and replays per study)."""
    out: Dict[str, List[Tuple[int, int, bytes]]] = {}
    for seq, opcode, payload in records:
        if opcode == SNAPSHOT_META:
            continue
        out.setdefault(study_key_of(opcode, payload), []).append(
            (seq, opcode, payload)
        )
    return out
