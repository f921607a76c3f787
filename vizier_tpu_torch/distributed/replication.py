"""Shared-nothing WAL replication: streamed standby logs + recovery plans.

A copy of the JAX package's ``distributed/replication.py``. A failover that
replays a dead replica's WAL *files* into its successors silently assumes
every replica can read every other replica's disk. A real multi-host fleet
has no shared filesystem, so this module makes durability shared-nothing:
every ``PersistentDataStore`` append is **asynchronously streamed** to the
owning study's K rendezvous successors, which keep **per-origin standby
logs**; failover replays from the standby logs and falls back to the
origin's local WAL only when that WAL is present *and longer*
(longest-valid-prefix wins, compared by the mutation sequence numbers
``wal.py`` assigns).

Pieces, origin side → successor side:

- :class:`ReplicationStreamer` — one per live replica. The store's
  ``on_append`` hook drops ``(seq, opcode, payload)`` into a bounded
  queue (non-blocking: the write path never waits on replication); a
  worker thread drains in batches, routes each record to the study's
  successors (``StudyRouter.successors`` — liveness-blind, so the sets
  are stable), and delivers with ack tracking. A successor whose ack
  does not match what was sent (it restarted, its disk was wiped, the
  queue overflowed) is **resynced** with a *baseline*: an atomic
  ``(seq, compacted records)`` export of the origin store filtered to
  the studies that successor stands by for, which replaces its standby
  log for this origin.
- :class:`StandbyStore` — one per replica, holding the standby logs of
  every origin it is a successor for, disk-backed under
  ``<wal_dir>/standby/<origin>/`` (same crash tolerance as the WAL:
  framed records, longest-valid-prefix reads) or in-memory when the
  tier runs without persistence. Appends are **epoch-fenced**: a revive
  bumps the origin's epoch and fences all standby stores, so a stale
  streamer (an RPC that outlived its own replica's revive) cannot
  scribble over the handed-back state.
- :func:`plan_recovery` — the pure recovery-source selector: given the
  origin's local WAL records (possibly truncated by corruption
  quarantine, possibly missing entirely) and every live standby log,
  choose per study the source whose records reach the highest sequence
  number. Local wins only when strictly longer; ties go to the standby
  (the shared-nothing posture: prefer the source that exists on a live
  host).

Lock order: the streamer's queue condition is a leaf under
``PersistentDataStore._lock`` (the ``on_append`` hook only appends to a
deque and notifies); the worker thread never holds it while delivering or
exporting a baseline. ``StandbyStore._lock`` is a leaf guarding its maps
and file handles. Nothing here calls back into router/replica locks while
holding either.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib

_logger = logging.getLogger(__name__)

# Standby record framing: [u32 payload len][u32 crc][u64 seq][u8 opcode]
# [payload]; crc covers seq+opcode+payload. Opcode 0 is the epoch marker
# (seq field = epoch, empty payload) written as the first record of each
# standby log generation; data records use the wal.py opcodes (1..11).
_HEADER = struct.Struct("<IIQB")
EPOCH_MARKER = 0

STANDBY_DIR = "standby"
STANDBY_LOG = "standby.log"

Record = Tuple[int, int, bytes]  # (seq, opcode, payload)


def _frame(seq: int, opcode: int, payload: bytes) -> bytes:
    body = _HEADER.pack(
        len(payload),
        zlib.crc32(struct.pack("<QB", seq, opcode) + payload),
        seq,
        opcode,
    )
    return body + payload


def _read_standby_file(path: str) -> List[Record]:
    """Valid-prefix read of one standby log (damage drops the suffix —
    standby logs are redundancy; a shorter one just loses the seq race)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return []
    records: List[Record] = []
    offset = 0
    while offset + _HEADER.size <= len(data):
        length, crc, seq, opcode = _HEADER.unpack_from(data, offset)
        start = offset + _HEADER.size
        end = start + length
        if end > len(data):
            break
        payload = data[start:end]
        if zlib.crc32(struct.pack("<QB", seq, opcode) + payload) != crc:
            break
        records.append((seq, opcode, payload))
        offset = end
    return records


class _OriginStandby:
    """One origin's standby log at one successor."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.epoch = 0
        self.records: List[Record] = []
        self.last_seq = 0
        # The seq of the last baseline this log was reset to. A baseline
        # is a statement about the origin's WHOLE (successor-filtered)
        # state: a study ABSENT from this log with baseline_seq > its
        # seq elsewhere was absent from the origin at that point — which
        # is how a stale local WAL prefix (e.g. one whose handback
        # tombstone fell into a quarantined corrupt suffix) loses to the
        # standby's authoritative absence.
        self.baseline_seq = 0
        self._file = None
        if path is not None and os.path.exists(path):
            loaded = _read_standby_file(path)
            for seq, opcode, payload in loaded:
                if opcode == EPOCH_MARKER:
                    self.epoch = seq
                    if len(payload) == 8:
                        self.baseline_seq = int(
                            struct.unpack("<Q", payload)[0]
                        )
                else:
                    self.records.append((seq, opcode, payload))
                    self.last_seq = max(self.last_seq, seq)

    def _open(self, truncate: bool):
        if self.path is None:
            return None
        if self._file is None or truncate:
            if self._file is not None:
                self._file.close()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._file = open(self.path, "wb" if truncate else "ab")
        return self._file

    def reset(self, epoch: int, baseline_seq: int = 0) -> None:
        self.epoch = epoch
        self.records = []
        self.last_seq = baseline_seq
        self.baseline_seq = baseline_seq
        f = self._open(truncate=True)
        if f is not None:
            f.write(
                _frame(
                    epoch, EPOCH_MARKER, struct.pack("<Q", baseline_seq)
                )
            )
            f.flush()

    def append(self, records: Sequence[Record]) -> None:
        f = self._open(truncate=False)
        for seq, opcode, payload in records:
            self.records.append((seq, opcode, payload))
            self.last_seq = max(self.last_seq, seq)
            if f is not None:
                f.write(_frame(seq, opcode, payload))
        if f is not None:
            f.flush()

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except Exception:
                pass
            self._file = None


class StandbyStore:
    """A replica's receiver side: per-origin, epoch-fenced standby logs."""

    def __init__(self, directory: Optional[str] = None):
        self._directory = (
            os.path.join(directory, STANDBY_DIR) if directory else None
        )
        self._lock = threading.Lock()  # leaf: maps + file handles only
        self._origins: Dict[str, _OriginStandby] = {}
        if self._directory is not None and os.path.isdir(self._directory):
            for origin in sorted(os.listdir(self._directory)):
                path = os.path.join(self._directory, origin, STANDBY_LOG)
                if os.path.exists(path):
                    self._origins[origin] = _OriginStandby(path)

    def _origin(self, origin: str) -> _OriginStandby:
        standby = self._origins.get(origin)
        if standby is None:
            path = None
            if self._directory is not None:
                path = os.path.join(self._directory, origin, STANDBY_LOG)
            standby = self._origins[origin] = _OriginStandby(path)
        return standby

    def append_batch(
        self,
        origin: str,
        epoch: int,
        records: Sequence[Record],
        *,
        reset: bool = False,
        baseline_seq: int = 0,
    ) -> Tuple[bool, int]:
        """Appends one delivered batch; ``reset=True`` replaces the log
        (a baseline taken at ``baseline_seq``). Returns ``(accepted,
        value)`` — on acceptance the value is the log's last sequence
        number (the ack the streamer verifies); on a stale-epoch
        rejection it is the fenced epoch.
        """
        with self._lock:
            standby = self._origin(origin)
            if epoch < standby.epoch:
                return False, standby.epoch  # fenced: stale origin epoch
            if epoch > standby.epoch and not reset:
                # A new epoch must introduce itself with a baseline; a
                # bare append across an epoch boundary means this store
                # missed the handoff.
                return False, standby.epoch
            if reset:
                standby.reset(epoch, baseline_seq)
            else:
                # Replay applies records in log order, so a record OLDER
                # than what the log already holds must never be appended
                # behind it (it would regress state on replay). Baselines
                # are exempt: all their records share the baseline seq.
                records = [r for r in records if r[0] > standby.last_seq]
            standby.append(records)
            return True, standby.last_seq

    def fence(self, origin: str, epoch: int) -> None:
        """Raises the origin's known epoch WITHOUT data (revive cutover):
        deliveries from streamers of earlier epochs are rejected from now
        on, even before the new streamer's first baseline arrives."""
        with self._lock:
            standby = self._origin(origin)
            if epoch > standby.epoch:
                standby.epoch = epoch

    def last_seq(self, origin: str) -> int:
        with self._lock:
            standby = self._origins.get(origin)
            return standby.last_seq if standby is not None else 0

    def epoch(self, origin: str) -> int:
        with self._lock:
            standby = self._origins.get(origin)
            return standby.epoch if standby is not None else 0

    def records_for(self, origin: str) -> List[Record]:
        with self._lock:
            standby = self._origins.get(origin)
            return list(standby.records) if standby is not None else []

    def view_for(self, origin: str) -> Optional["StandbyView"]:
        """The recovery-plan input: records plus the baseline seq (the
        'absent studies were absent as of here' claim)."""
        with self._lock:
            standby = self._origins.get(origin)
            if standby is None:
                return None
            return StandbyView(
                baseline_seq=standby.baseline_seq,
                records=list(standby.records),
            )

    def depths(self) -> Dict[str, int]:
        """origin -> standby record count (the standby-depth gauge)."""
        with self._lock:
            return {
                origin: len(standby.records)
                for origin, standby in sorted(self._origins.items())
            }

    def close(self) -> None:
        with self._lock:
            for standby in self._origins.values():
                standby.close()


# -- origin-side streaming ---------------------------------------------------


@dataclasses.dataclass
class StandbyView:
    """One holder's standby log for an origin, as recovery-plan input.

    ``baseline_seq`` is the log's absence claim: a study with no records
    here was absent from the origin's (successor-filtered) state at that
    sequence number.
    """

    baseline_seq: int
    records: List[Record]


@dataclasses.dataclass
class _SuccessorState:
    """Worker-thread-private per-successor tracking (no lock needed: only
    the worker reads or writes it)."""

    synced: bool = False
    acked_seq: int = 0
    # Why the NEXT resync of this successor is needed — kept alongside the
    # unsynced flag so the ``vizier_replication_resyncs{reason}`` counter
    # attributes each baseline to what actually broke the stream:
    # "initial" (first contact), "overflow" (queue drop), "transport"
    # (delivery failed / link died), "epoch_behind" (receiver restarted
    # with an old epoch), "ack_regressed" (standby log wiped underneath
    # us), "requested" (a revive's proactive re-baseline).
    reason: str = "initial"

    def desync(self, reason: str) -> None:
        self.synced = False
        self.reason = reason


class StreamerFencedError(RuntimeError):
    """A successor rejected this streamer's epoch: a newer generation of
    the origin exists; this streamer must stop streaming."""


class ReplicationStreamer:
    """Streams one origin's WAL appends to per-study rendezvous successors.

    ``submit`` is the store's ``on_append`` hook: non-blocking, called
    under the store lock so the queue order equals the log order. On
    queue overflow records are DROPPED and every successor is marked
    unsynced — the next drain re-baselines them from the store itself, so
    overflow costs a resync, never correctness.
    """

    def __init__(
        self,
        origin: str,
        epoch: int,
        *,
        successors_fn: Callable[[str], Sequence[str]],
        deliver_fn: Callable[
            [str, str, int, Sequence[Record], bool, int],
            Optional[Tuple[bool, int]],
        ],
        baseline_fn: Callable[[str], Tuple[int, List[Record]]],
        queue_size: int = 4096,
        batch_max: int = 64,
        repair_interval_secs: float = 0.5,
        on_lag: Optional[Callable[[str, int], None]] = None,
        on_resync: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.origin = origin
        self.epoch = epoch
        self._successors_fn = successors_fn
        self._deliver_fn = deliver_fn
        self._baseline_fn = baseline_fn
        self._queue_size = max(1, queue_size)
        self._batch_max = max(1, batch_max)
        # Self-healing cadence: a successor left unsynced by a failed
        # delivery (the link died, the peer restarted) is re-baselined on
        # this throttle even with NO new traffic — quiet studies must not
        # stay unprotected until the next organic mutation.
        self._repair_interval = max(0.05, repair_interval_secs)
        self._next_repair = 0.0
        self._on_lag = on_lag
        # (origin, successor, reason) observer — the plane's labeled
        # ``vizier_replication_resyncs`` counter.
        self._on_resync = on_resync
        self._cond = threading.Condition()
        self._queue: "collections.deque[Record]" = collections.deque()
        # successor -> reason of the queued proactive resync.
        self._pending_resync: Dict[str, str] = {}
        self._overflowed = False
        self._closed = False
        self._fenced = False
        self._inflight = 0  # records drained but not yet delivered
        self._submitted_seq = 0
        self._states: Dict[str, _SuccessorState] = {}
        self.resyncs = 0
        self.dropped = 0
        self._thread = threading.Thread(
            target=self._run, name=f"vizier-wal-repl-{origin}", daemon=True
        )
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, seq: int, opcode: int, payload: bytes) -> None:
        """The store's post-append hook. Never blocks, never raises."""
        with self._cond:
            if self._closed or self._fenced:
                return
            self._submitted_seq = max(self._submitted_seq, seq)
            if len(self._queue) >= self._queue_size:
                # Dropping breaks per-successor continuity; the worker
                # re-baselines everyone on the next drain.
                self._overflowed = True
                self.dropped += 1
                return
            self._queue.append((seq, opcode, payload))
            self._cond.notify()

    def request_resync(self, successor: str, reason: str = "requested") -> None:
        """Queues a proactive baseline for ``successor`` (a revived
        replica's standby logs are stale until someone re-baselines them;
        waiting for the next organic record would leave a window where
        the origin's death loses the quiet studies)."""
        with self._cond:
            if self._closed or self._fenced:
                return
            self._pending_resync[successor] = reason
            self._cond.notify()

    def flush(self, timeout_secs: float = 10.0) -> bool:
        """Blocks until the queue has fully drained AND delivered (or the
        timeout passes). Failover calls this on the dead origin's streamer
        so everything its in-flight RPCs appended is on the successors
        before the standby logs are read."""
        deadline = time.monotonic() + timeout_secs
        with self._cond:
            self._cond.notify_all()
            while self._queue or self._inflight or self._pending_resync:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.05))
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    @property
    def fenced(self) -> bool:
        with self._cond:
            return self._fenced

    def lag(self) -> int:
        """Records submitted but not yet acked by the slowest successor."""
        with self._cond:
            submitted = self._submitted_seq
            states = [s for s in self._states.values() if s.synced]
        if not states:
            return 0
        return max(0, submitted - min(s.acked_seq for s in states))

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        # First action: baseline every successor that currently stands by
        # for one of the origin's studies, so a restart-warm replica is
        # protected before its first new mutation.
        try:
            self._initial_sync()
        except StreamerFencedError:
            with self._cond:
                self._fenced = True
                self._queue.clear()
                self._cond.notify_all()
            return
        except Exception as e:  # pragma: no cover - defensive
            _logger.warning("Initial replication sync failed: %s", e)
        while True:
            with self._cond:
                while (
                    not self._queue
                    and not self._pending_resync
                    and not self._closed
                ):
                    if (
                        self._has_unsynced()
                        and time.monotonic() >= self._next_repair
                    ):
                        break  # idle repair pass: re-baseline dead links
                    self._cond.wait(0.2)
                if self._closed and not self._queue:
                    return
                batch: List[Record] = []
                while self._queue and len(batch) < self._batch_max:
                    batch.append(self._queue.popleft())
                resyncs = sorted(self._pending_resync.items())
                self._pending_resync.clear()
                overflowed, self._overflowed = self._overflowed, False
                self._inflight = len(batch) + len(resyncs)
            try:
                for successor, reason in resyncs:
                    self._state(successor).desync(reason)
                    self._resync(successor)
                self._deliver_batch(batch, overflowed)
                self._repair_unsynced()
            except StreamerFencedError:
                with self._cond:
                    self._fenced = True
                    self._queue.clear()
                    self._inflight = 0
                    self._cond.notify_all()
                return
            except Exception as e:  # pragma: no cover - defensive
                _logger.warning(
                    "Replication delivery from %s failed: %s", self.origin, e
                )
            finally:
                with self._cond:
                    self._inflight = 0
                    self._cond.notify_all()

    def _initial_sync(self) -> None:
        _seq, records = self._baseline_all()
        targets: Dict[str, None] = {}
        for seq, opcode, payload in records:
            for successor in self._successors_fn(
                wal_lib.study_key_of(opcode, payload)
            ):
                targets[successor] = None
        for successor in targets:
            self._resync(successor)

    def _baseline_all(self) -> Tuple[int, List[Record]]:
        seq, flat = self._baseline_fn("")
        return seq, flat

    def _state(self, successor: str) -> _SuccessorState:
        state = self._states.get(successor)
        if state is None:
            state = self._states[successor] = _SuccessorState()
        return state

    def _has_unsynced(self) -> bool:
        """Worker-private: any known successor currently off-stream?"""
        return any(not state.synced for state in self._states.values())

    def _repair_unsynced(self) -> None:
        """Throttled self-healing: retry the baseline of every unsynced
        successor. Called from the worker after each cycle (and from the
        idle wakeup), so a healed link or restarted peer is re-protected
        within ``repair_interval`` even if no new mutation ever arrives.
        Failed attempts are cheap — the wire link's dead-peer cooldown
        short-circuits the connect wait."""
        if not self._has_unsynced():
            return
        now = time.monotonic()
        if now < self._next_repair:
            return
        self._next_repair = now + self._repair_interval
        for successor in sorted(self._states):
            if not self._states[successor].synced:
                self._resync(successor)

    def _resync(self, successor: str) -> bool:
        """Replaces a successor's standby log with a fresh baseline."""
        state = self._state(successor)
        reason = state.reason
        seq, records = self._baseline_fn(successor)
        response = self._deliver_fn(
            successor, self.origin, self.epoch, records, True, seq
        )
        if response is None:  # successor unreachable (dead): retry later
            state.desync("transport")
            return False
        accepted, value = response
        if not accepted:
            # A reset delivery is only refused when the standby store has
            # been fenced to a NEWER origin epoch: this streamer is a
            # stale generation and must stop.
            raise StreamerFencedError(
                f"standby epoch {value} fences out streamer epoch "
                f"{self.epoch} for {self.origin}"
            )
        state.synced = True
        state.acked_seq = value
        self.resyncs += 1
        if self._on_resync is not None:
            try:
                self._on_resync(self.origin, successor, reason)
            except Exception:  # accounting must not break the stream
                pass
        recorder_lib.get_recorder().record(
            None,
            "replication_resync",
            origin=self.origin,
            successor=successor,
            baseline_seq=seq,
            records=len(records),
            reason=reason,
        )
        return True

    def _deliver_batch(self, batch: List[Record], overflowed: bool) -> None:
        if overflowed:
            for state in self._states.values():
                state.desync("overflow")
        per_successor: Dict[str, List[Record]] = {}
        for seq, opcode, payload in batch:
            study_key = wal_lib.study_key_of(opcode, payload)
            for successor in self._successors_fn(study_key):
                per_successor.setdefault(successor, []).append(
                    (seq, opcode, payload)
                )
        for successor, records in sorted(per_successor.items()):
            state = self._state(successor)
            if not state.synced:
                if not self._resync(successor):
                    continue  # unreachable; baseline again when it returns
                # The baseline already contains this batch's records (it
                # exported the live store, which applied them before the
                # hook fired): skip them rather than append stale records
                # behind newer baseline state.
                continue
            # Never send records at-or-below the successor's ack: after a
            # resync, queued records older than the baseline are already
            # folded into it.
            records = [r for r in records if r[0] > state.acked_seq]
            if not records:
                continue
            response = self._deliver_fn(
                successor, self.origin, self.epoch, records, False, 0
            )
            if response is None:
                state.desync("transport")
                continue
            accepted, value = response
            if not accepted:
                if value > self.epoch:
                    # Fenced: a newer generation of this origin exists.
                    raise StreamerFencedError(
                        f"standby epoch {value} fences out streamer epoch "
                        f"{self.epoch} for {self.origin}"
                    )
                # The receiver is BEHIND (it restarted with an old epoch
                # on disk): a baseline introduces the current epoch.
                state.desync("epoch_behind")
                continue
            state.acked_seq = value
            expected = records[-1][0]
            if value < expected:
                # The standby log is behind what we just sent: it was
                # wiped/recreated underneath us. Re-baseline.
                state.desync("ack_regressed")
        if self._on_lag is not None:
            try:
                self._on_lag(self.origin, self.lag())
            except Exception:
                pass


# -- recovery-source selection -----------------------------------------------


@dataclasses.dataclass
class StudyRecovery:
    """One study's chosen recovery source in a failover plan."""

    study: str
    source: str  # "standby" | "local"
    seq: int
    records: List[Tuple[int, bytes]]  # (opcode, payload), replay order


@dataclasses.dataclass
class RecoveryPlan:
    origin: str
    studies: List[StudyRecovery]
    local_torn: bool
    max_seq: int

    def source_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.studies:
            out[s.source] = out.get(s.source, 0) + 1
        return out


def plan_recovery(
    origin: str,
    local_records: Sequence[Tuple[int, int, bytes]],
    local_torn: bool,
    standby_views: Iterable[StandbyView],
    *,
    min_seq: int = 0,
    successors_fn: Optional[Callable[[str], Sequence[str]]] = None,
    holders: Optional[Sequence[str]] = None,
) -> RecoveryPlan:
    """Chooses, per study, the longest-valid-prefix recovery source.

    ``local_records`` are the dead origin's own WAL records (with
    sequence numbers; empty when its disk is gone — the shared-nothing
    case). ``standby_views`` are every live replica's standby logs for
    the origin, each carrying its ``baseline_seq``. Per study, the
    source whose knowledge reaches the highest sequence number wins; the
    local WAL wins only when STRICTLY longer (ties go to the standby —
    prefer the copy that lives on a live host).

    Three kinds of standby knowledge compete with the local records:
    explicit records (replay them), a history ending in DELETE_STUDY
    (the study is gone), and **absence at the baseline** — a study with
    no records in a log whose ``baseline_seq`` is higher than the local
    seq was absent from the origin's state at that point, which outranks
    a stale local prefix. The absence case is what makes a quarantined
    local WAL safe: when a handback tombstone fell into the corrupt
    suffix, the local prefix still shows the moved-away study as live,
    and replaying it would clobber the real owner's current copy.
    Absence claims only count from holders in the study's successor set
    (``successors_fn`` + ``holders``, when provided): other holders
    never receive the study's records, so their logs say nothing about
    it.

    Net-deleted studies are skipped on a full replay: the origin has
    nothing live to contribute, and a genuine user deletion loses
    nothing (the origin owned the study when it was deleted, so no other
    replica holds a live copy). ``min_seq`` drops records at-or-below an
    already-replayed watermark (the late-write catch-up path), so only
    the tail is re-applied — catch-up tails keep their deletes, which
    are real client RPCs that raced the failover.
    """
    views = list(standby_views)
    holder_ids = list(holders) if holders is not None else [None] * len(views)
    local_by_study = wal_lib.group_by_study(local_records)
    standby_by_study: Dict[str, List[Tuple[int, int, bytes]]] = {}
    view_studies: List[set] = []
    for view in views:
        grouped = wal_lib.group_by_study(view.records)
        view_studies.append(set(grouped))
        for study, records in grouped.items():
            best = standby_by_study.get(study)
            if best is None or (
                records and (not best or records[-1][0] > best[-1][0])
            ):
                standby_by_study[study] = list(records)

    def absence_seq(study: str) -> int:
        """The highest baseline seq among holders that WOULD hold the
        study's records yet have none: the origin's state at that seq did
        not contain the study."""
        eligible = None
        if successors_fn is not None:
            eligible = set(successors_fn(study))
        best = 0
        for view, holder, present in zip(views, holder_ids, view_studies):
            if eligible is not None and holder is not None:
                if holder not in eligible:
                    continue
            if study in present:
                continue
            best = max(best, view.baseline_seq)
        return best

    studies: List[StudyRecovery] = []
    max_seq = 0
    for study in sorted(set(local_by_study) | set(standby_by_study)):
        local = local_by_study.get(study, [])
        standby = standby_by_study.get(study, [])
        local_seq = local[-1][0] if local else 0
        standby_seq = standby[-1][0] if standby else 0
        if local and local_seq > standby_seq:
            source, chosen, seq = "local", local, local_seq
        elif standby:
            source, chosen, seq = "standby", standby, standby_seq
        else:
            source, chosen, seq = "local", local, local_seq
        if min_seq == 0 and absence_seq(study) >= seq:
            # A baseline taken at-or-after the chosen source's horizon
            # did not contain the study: it is absent from the origin's
            # authoritative state (handed back or deleted), and replaying
            # the stale copy would clobber the live owner's data.
            max_seq = max(max_seq, absence_seq(study))
            continue
        if (
            min_seq == 0
            and chosen
            and chosen[-1][1] == wal_lib.DELETE_STUDY
        ):
            max_seq = max(max_seq, seq)
            continue  # net-deleted on the origin: nothing live to restore
        tail = [
            (opcode, payload)
            for rec_seq, opcode, payload in chosen
            if rec_seq > min_seq
        ]
        if min_seq > 0 and not tail:
            continue  # catch-up pass: nothing new for this study
        max_seq = max(max_seq, seq)
        studies.append(StudyRecovery(study, source, seq, tail))
    return RecoveryPlan(origin, studies, local_torn, max_seq)


# -- the fleet-facing plane --------------------------------------------------


class AppendSink:
    """The typed ``PersistentDataStore.on_append`` target: one origin's
    handle into the replication plane.

    A class (not a closure) on purpose: the store-lock → plane-lock →
    streamer-condition acquisition chain the hook creates is named by the
    ctor/attribute annotations.
    """

    def __init__(self, origin: str, plane: "ReplicationPlane"):
        self._origin = origin
        self._plane: "ReplicationPlane" = plane

    def submit(self, seq: int, opcode: int, payload: bytes) -> None:
        self._plane.submit(self._origin, seq, opcode, payload)


class ReplicationPlane:
    """Owns the streamers + standby stores of one in-process tier.

    The ``ReplicaManager`` calls in with replica-shaped accessors; this
    class keeps all replication state and policy in one place so the
    manager's failover/revive code reads as topology operations.
    """

    def __init__(
        self,
        *,
        factor: int,
        queue_size: int,
        batch_max: int,
        router,
        get_replica: Callable[[str], Optional[object]],
        registry=None,
    ):
        self.factor = max(1, factor)
        self._queue_size = queue_size
        self._batch_max = batch_max
        self._router = router
        self._get_replica = get_replica
        self._streamers: Dict[str, ReplicationStreamer] = {}
        self._epochs: Dict[str, int] = {}
        self._lock = threading.Lock()  # leaf: streamer/epoch maps only
        self._lag_gauge = None
        self._depth_gauge = None
        self._resync_counter = None
        if registry is not None:
            self._lag_gauge = registry.gauge(
                "vizier_replication_lag",
                help="Appended-but-unacked standby records per origin.",
            )
            self._depth_gauge = registry.gauge(
                "vizier_replication_standby_depth",
                help="Standby-log records held, per origin and holder.",
            )
            self._resync_counter = registry.counter(
                "vizier_replication_resyncs",
                help="Standby-log re-baselines, per origin and reason "
                "(initial/overflow/transport/epoch_behind/ack_regressed/"
                "requested).",
            )

    # -- hooks the manager wires --------------------------------------------

    def make_standby(self, wal_dir: Optional[str]) -> StandbyStore:
        return StandbyStore(wal_dir)

    def submit(self, origin: str, seq: int, opcode: int, payload: bytes) -> None:
        """The ``PersistentDataStore.on_append`` feed: resolves the
        origin's CURRENT streamer per call, so a revive's fresh streamer
        takes over without rebuilding the datastore hook. Non-blocking."""
        with self._lock:
            streamer = self._streamers.get(origin)
        if streamer is not None:
            streamer.submit(seq, opcode, payload)

    def successors_for(self, study_key: str, origin: str) -> List[str]:
        return self._router.successors(study_key, origin, self.factor)

    # -- streamer lifecycle --------------------------------------------------

    def start_streamer(self, origin: str) -> ReplicationStreamer:
        """Builds (or rebuilds, bumping the epoch) the origin's streamer."""
        with self._lock:
            epoch = self._epochs.get(origin, 0) + 1
            self._epochs[origin] = epoch
            old = self._streamers.pop(origin, None)
        if old is not None:
            old.close()
        streamer = ReplicationStreamer(
            origin,
            epoch,
            successors_fn=lambda key: self.successors_for(key, origin),
            deliver_fn=self._deliver,
            baseline_fn=lambda successor: self._baseline(origin, successor),
            queue_size=self._queue_size,
            batch_max=self._batch_max,
            on_lag=self._record_lag,
            on_resync=self._record_resync,
        )
        with self._lock:
            self._streamers[origin] = streamer
        return streamer

    def epoch_of(self, origin: str) -> int:
        with self._lock:
            return self._epochs.get(origin, 0)

    def flush_origin(self, origin: str, timeout_secs: float = 10.0) -> bool:
        with self._lock:
            streamer = self._streamers.get(origin)
        if streamer is None:
            return True
        return streamer.flush(timeout_secs)

    def resync_into(self, successor: str) -> None:
        """Asks every OTHER origin's streamer to re-baseline ``successor``
        (called after a revive: the returning replica's standby logs are
        stale for every origin that mutated while it was down — or gone
        entirely when its disk was lost)."""
        with self._lock:
            streamers = dict(self._streamers)
        for origin, streamer in streamers.items():
            if origin != successor:
                streamer.request_resync(successor)

    def close_origin(self, origin: str) -> None:
        with self._lock:
            streamer = self._streamers.pop(origin, None)
        if streamer is not None:
            streamer.close()

    def close(self) -> None:
        with self._lock:
            streamers = list(self._streamers.values())
            self._streamers.clear()
        for streamer in streamers:
            streamer.close()

    # -- internals -----------------------------------------------------------

    def _deliver(
        self,
        successor_id: str,
        origin: str,
        epoch: int,
        records: Sequence[Record],
        reset: bool,
        baseline_seq: int,
    ) -> Optional[Tuple[bool, int]]:
        replica = self._get_replica(successor_id)
        standby = getattr(replica, "standby", None)
        if replica is None or standby is None or not replica.alive:
            return None  # unreachable: the streamer resyncs on return
        return standby.append_batch(
            origin, epoch, records, reset=reset, baseline_seq=baseline_seq
        )

    def _baseline(
        self, origin: str, successor_id: str
    ) -> Tuple[int, List[Record]]:
        """An atomic baseline of the origin store: all records when
        ``successor_id`` is empty (the initial-sync probe), else filtered
        to the studies that successor stands by for."""
        replica = self._get_replica(origin)
        datastore = getattr(replica, "datastore", None)
        export = getattr(datastore, "export_with_seq", None)
        if export is None:
            return 0, []
        seq, records = export()
        out: List[Record] = []
        for opcode, payload in records:
            if successor_id and successor_id not in self.successors_for(
                wal_lib.study_key_of(opcode, payload), origin
            ):
                continue
            out.append((seq, opcode, payload))
        return seq, out

    def _record_lag(self, origin: str, lag: int) -> None:
        if self._lag_gauge is not None:
            self._lag_gauge.set(float(lag), origin=origin)

    def _record_resync(self, origin: str, successor: str, reason: str) -> None:
        del successor  # label cardinality: (origin, reason) is enough
        if self._resync_counter is not None:
            self._resync_counter.inc(origin=origin, reason=reason)

    def streamer_stats(self) -> Dict[str, Dict[str, int]]:
        """origin -> {epoch, lag, resyncs, dropped} (JSON-ready)."""
        with self._lock:
            streamers = dict(self._streamers)
        return {
            origin: {
                "epoch": streamer.epoch,
                "lag": streamer.lag(),
                "resyncs": streamer.resyncs,
                "dropped": streamer.dropped,
            }
            for origin, streamer in sorted(streamers.items())
        }

    def record_depths(self) -> Dict[str, Dict[str, int]]:
        """holder -> origin -> standby depth (also refreshes the gauge)."""
        out: Dict[str, Dict[str, int]] = {}
        for rid in self._router.replica_ids:
            replica = self._get_replica(rid)
            standby = getattr(replica, "standby", None)
            if standby is None:
                continue
            depths = standby.depths()
            if depths:
                out[rid] = depths
            if self._depth_gauge is not None:
                for origin, depth in depths.items():
                    self._depth_gauge.set(
                        float(depth), origin=origin, holder=rid
                    )
        return out
