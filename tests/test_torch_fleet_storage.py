"""The fleet's routing, WAL, standby logs and fault injection on the CPU, held
to the JAX package's.

- routing: ``rendezvous_weight`` and ``StudyRouter``'s owners, rankings,
  successors, ``mark_down`` and ``mark_up`` equal the JAX package's for the
  same replica ids over 240 study keys; the router's behaviours hold in both.
- WAL: the same operations give byte-identical ``wal.log`` and
  ``snapshot.bin`` files in both packages; a directory written by either
  package replays in the other's ``PersistentDataStore`` to the same
  ``export_protos`` bytes; the crash windows, fsync modes, fail-stop,
  corruption quarantine and sequence numbers hold in both.
- ``ShardedDataStore`` places studies on the same shards in both packages and
  leaves the same records as the JAX RAM store.
- standby logs: the same deliveries give byte-identical ``standby.log`` files
  and the same fencing answers; ``plan_recovery`` picks the same sources;
  the streamer's mechanics hold in both.
- ``NetChaos``: one seed strikes the same calls in both packages; the rules,
  partitions, stub wrapping and spec strings behave the same.

Each behaviour test runs against both packages (``pkg``): the port's copy is
held to do what the JAX package does, case for case.
"""

from __future__ import annotations

import os
import time
import types

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

import test_torch_datastores as ds_script
from vizier_tpu.distributed import config as jconfig
from vizier_tpu.distributed import replication as jrepl
from vizier_tpu.distributed import routing as jrouting
from vizier_tpu.distributed import sharded_datastore as jsharded
from vizier_tpu.distributed import wal as jwal
from vizier_tpu.reliability import errors as jerrors
from vizier_tpu.service import datastore as jdatastore
from vizier_tpu.service import ram_datastore as jram
from vizier_tpu.service import resources as jresources
from vizier_tpu.service.protos import key_value_pb2 as jkv
from vizier_tpu.service.protos import study_pb2 as jstudy
from vizier_tpu.service.protos import vizier_service_pb2 as jvs
from vizier_tpu.testing import chaos as jchaos
from vizier_tpu.testing import netchaos as jnetchaos
from vizier_tpu_torch.distributed import config
from vizier_tpu_torch.distributed import replication
from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.distributed import sharded_datastore
from vizier_tpu_torch.distributed import wal
from vizier_tpu_torch.reliability import errors
from vizier_tpu_torch.service import datastore
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service.protos import key_value_pb2
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2
from vizier_tpu_torch.testing import netchaos

JAX = types.SimpleNamespace(
    name="jax", routing=jrouting, wal=jwal, repl=jrepl, sharded=jsharded, config=jconfig,
    errors=jerrors, ds=jdatastore, ram=jram, resources=jresources, kv=jkv, study=jstudy,
    vs=jvs, netchaos=jnetchaos, prefix="VIZIER_")
PORT = types.SimpleNamespace(
    name="port", routing=routing, wal=wal, repl=replication, sharded=sharded_datastore,
    config=config, errors=errors, ds=datastore, ram=ram_datastore, resources=resources,
    kv=key_value_pb2, study=study_pb2, vs=vizier_service_pb2, netchaos=netchaos,
    prefix="VIZIER_TORCH_")
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
KEYS = [f"owners/o/studies/s{i}" for i in range(240)]
_ID_SETS = [[f"replica-{i}" for i in range(n)] for n in (1, 2, 3, 4, 6)] + [
    ["frontend-a", "frontend-b", "compute-0"]]


# -- routing --------------------------------------------------------------------


def _router(pkg, n=4, **kwargs):
    return pkg.routing.StudyRouter([f"replica-{i}" for i in range(n)], **kwargs)


@pytest.mark.parametrize("ids", _ID_SETS, ids=lambda ids: f"{len(ids)}-{ids[0]}")
def test_owners_rankings_and_weights_equal_the_jax_packages(ids):
    theirs, ours = jrouting.StudyRouter(ids), routing.StudyRouter(ids)
    for key in KEYS:
        assert [routing.rendezvous_weight(r, key) for r in ids] == [
            jrouting.rendezvous_weight(r, key) for r in ids]
        assert ours.ranking(key) == theirs.ranking(key)
        assert ours.replica_for(key) == theirs.replica_for(key)
    assert ours.assignments(KEYS) == theirs.assignments(KEYS)


@pytest.mark.parametrize("ids", _ID_SETS[1:], ids=lambda ids: f"{len(ids)}-{ids[0]}")
def test_successors_equal_the_jax_packages(ids):
    theirs, ours = jrouting.StudyRouter(ids), routing.StudyRouter(ids)
    for key in KEYS:
        for origin in ids:
            for count in range(len(ids) + 1):
                assert ours.successors(key, origin, count) == theirs.successors(
                    key, origin, count)


@pytest.mark.parametrize("ids", _ID_SETS[2:], ids=lambda ids: f"{len(ids)}-{ids[0]}")
def test_mark_down_and_mark_up_move_the_same_studies(ids):
    theirs, ours = jrouting.StudyRouter(ids), routing.StudyRouter(ids)
    before = {k: ours.replica_for(k) for k in KEYS}
    for victim in ids:
        assert ours.mark_down(victim) == theirs.mark_down(victim) is True
        after = {k: ours.replica_for(k) for k in KEYS}
        assert after == {k: theirs.replica_for(k) for k in KEYS}
        assert {k for k in KEYS if after[k] != before[k]} == {
            k for k in KEYS if before[k] == victim}
        assert ours.snapshot() == theirs.snapshot()
        assert ours.mark_up(victim) == theirs.mark_up(victim) is True
        assert {k: ours.replica_for(k) for k in KEYS} == before
    # Two down at once: every study on its best live choice, in both.
    for victim in ids[:2]:
        ours.mark_down(victim)
        theirs.mark_down(victim)
    assert {k: ours.replica_for(k) for k in KEYS} == {k: theirs.replica_for(k) for k in KEYS}
    assert ours.live_replicas() == theirs.live_replicas()


@PKGS
def test_placement_is_deterministic_and_shared(pkg):
    a, b = _router(pkg), _router(pkg)
    assert [a.replica_for(k) for k in KEYS] == [b.replica_for(k) for k in KEYS]
    for rid, studies in a.assignments(KEYS).items():
        assert 10 <= len(studies) <= 140, (rid, len(studies))
    assert sorted(a.ranking(KEYS[0])) == sorted(a.replica_ids)


@PKGS
def test_routing_off_pins_the_first_replica_and_bad_ids_are_refused(pkg):
    assert {_router(pkg, routing=False).replica_for(k) for k in KEYS} == {"replica-0"}
    with pytest.raises(ValueError):
        pkg.routing.StudyRouter([])
    with pytest.raises(ValueError):
        pkg.routing.StudyRouter(["a", "a"])
    with pytest.raises(KeyError):
        _router(pkg).mark_down("replica-99")


@PKGS
def test_liveness_transitions(pkg):
    router = _router(pkg)
    key = next(k for k in KEYS if router.replica_for(k) == "replica-1")
    ranking = router.ranking(key)
    assert router.mark_down("replica-1") and not router.mark_down("replica-1")
    assert router.replica_for(key) == ranking[1]
    assert router.last_route(key) == ranking[1]
    assert router.mark_up("replica-1") and not router.mark_up("replica-1")
    assert router.replica_for(key) == "replica-1"
    two = _router(pkg, 2)
    two.mark_down("replica-1")
    assert two.snapshot() == {"replica-0": "up", "replica-1": "down"}
    two.mark_down("replica-0")
    with pytest.raises(pkg.routing.NoLiveReplicaError):
        two.replica_for(KEYS[0])
    assert pkg.errors.is_transient_exception(pkg.routing.NoLiveReplicaError("x"))


@PKGS
def test_the_route_cache_is_a_bounded_lru(pkg, monkeypatch):
    router = _router(pkg, route_cache_size=16)
    for k in KEYS:
        router.replica_for(k)
    assert len(router._route_cache) == 16
    lru = _router(pkg, route_cache_size=4)
    for k in KEYS[:4]:
        lru.replica_for(k)
    lru.replica_for(KEYS[0])
    lru.replica_for(KEYS[4])
    assert KEYS[0] in lru._route_cache and KEYS[1] not in lru._route_cache
    small = _router(pkg, route_cache_size=2)
    want = {k: small.replica_for(k) for k in KEYS[:50]}
    assert {k: small.replica_for(k) for k in KEYS[:50]} == want
    assert _router(pkg)._route_cache_size == 65536
    monkeypatch.setenv(pkg.prefix + "DISTRIBUTED_ROUTE_CACHE_SIZE", "8")
    assert _router(pkg)._route_cache_size == 8
    with pytest.raises(ValueError):
        _router(pkg, route_cache_size=0)


# -- WAL --------------------------------------------------------------------------


def _study(pkg, sid, owner="o"):
    s = pkg.study.Study(name=f"owners/{owner}/studies/{sid}", display_name=sid,
                        creation_time_secs=12.5)
    s.study_spec.algorithm = "RANDOM_SEARCH"
    p = s.study_spec.parameters.add(name="x")
    p.double_range.min_value, p.double_range.max_value = 0.0, 1.0
    s.study_spec.metrics.add(name="obj")
    return s


def _trial(pkg, sid, tid=1):
    t = pkg.study.Trial(name=f"owners/o/studies/{sid}/trials/{tid}", id=tid,
                        state=pkg.study.Trial.ACTIVE, creation_time_secs=float(tid))
    t.parameters.add(name="x").value.double_value = tid / 10.0
    return t


def _populate(pkg, ds, *, studies=3, trials=4, ops=2):
    """The JAX WAL tests' mixed workload: every record type."""
    R, V, KV = pkg.resources, pkg.vs, pkg.kv
    for s in range(studies):
        ds.create_study(_study(pkg, f"s{s}"))
        name = f"owners/o/studies/s{s}"
        for t in range(1, trials + 1):
            trial = _trial(pkg, f"s{s}", t)
            ds.create_trial(trial)
            if t % 2 == 0:
                trial.state = pkg.study.Trial.SUCCEEDED
                ds.update_trial(trial)
        for n in range(1, ops + 1):
            ds.create_suggestion_operation(V.Operation(
                name=R.SuggestionOperationResource("o", f"s{s}", "c", n).name, done=(n == 1)))
        es = R.EarlyStoppingOperationResource("o", f"s{s}", 1).name
        ds.create_early_stopping_operation(V.EarlyStoppingOperation(name=es, should_stop=True))
        ds.update_metadata(name, [KV.KeyValue(key="k", ns=":m", string_value=f"v{s}")],
                           [(1, KV.KeyValue(key="tk", double_value=1.5))])


def _state(pkg, store) -> list:
    return list(pkg.wal.export_records(getattr(store, "_inner", store)))


def _protos_bytes(store) -> list:
    inner = getattr(store, "_inner", store)
    return [[p.SerializeToString(deterministic=True) for p in group]
            for group in inner.export_protos()]


def _files(directory) -> dict:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def test_wal_and_snapshot_files_are_byte_identical(tmp_path):
    files = []
    for pkg in (JAX, PORT):
        directory = str(tmp_path / pkg.name)
        store = pkg.wal.PersistentDataStore(directory, snapshot_interval=8, fsync=False)
        _populate(pkg, store)
        store.delete_trial("owners/o/studies/s0/trials/3")
        store.delete_study("owners/o/studies/s2")
        live = _files(directory)  # a snapshot and the log since it
        store.compact_now()
        compacted = _files(directory)
        store.close()
        files.append((live, compacted, store.seq))
    assert files[1] == files[0]
    assert set(files[1][0]) == {"snapshot.bin", "wal.log"} and files[1][0]["wal.log"]
    assert files[1][1]["wal.log"] == b""


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX), (PORT, PORT)],
                         ids=["jax_wal_replayed_by_port", "port_wal_replayed_by_jax",
                              "port_wal_replayed_by_port"])
def test_either_packages_wal_directory_replays_in_the_other(tmp_path, writer, reader):
    directory = str(tmp_path / "wal")
    store = writer.wal.PersistentDataStore(directory, snapshot_interval=9)
    _populate(writer, store, studies=4)
    store.delete_study("owners/o/studies/s1")
    written = _protos_bytes(store)
    seq = store.seq
    store.close()  # no compaction: the snapshot plus the log since it
    revived = reader.wal.PersistentDataStore(directory)
    assert _protos_bytes(revived) == written
    assert revived.seq == seq and not revived.recovered_torn_tail
    # The reader keeps appending to the other package's log, and the writer
    # replays that too.
    revived.create_study(_study(reader, "after"))
    after = _protos_bytes(revived)
    revived.close()
    assert _protos_bytes(writer.wal.PersistentDataStore(directory)) == after


@pytest.mark.parametrize("kind", ["persistent", "persistent_interval_1", "sharded",
                                  "sharded_over_persistent"])
def test_the_distributed_stores_leave_the_jax_ram_stores_records(tmp_path, kind):
    """The datastore contract over the fleet's backends: the same operations
    (every record type, deletes, metadata, operations) read back byte for
    byte as from the JAX package's RAM store."""
    if kind == "persistent":
        store = wal.PersistentDataStore(str(tmp_path / "p"))
    elif kind == "persistent_interval_1":
        store = wal.PersistentDataStore(str(tmp_path / "p1"), snapshot_interval=1)
    elif kind == "sharded":
        store = sharded_datastore.ShardedDataStore(
            [ram_datastore.NestedDictRAMDataStore() for _ in range(3)])
    else:
        store = sharded_datastore.ShardedDataStore(
            [wal.PersistentDataStore(str(tmp_path / f"shard-{i}")) for i in range(2)])
    theirs = ds_script._script(ds_script._JAX, jram.NestedDictRAMDataStore())
    assert ds_script._script(ds_script._PORT, store) == theirs


@PKGS
def test_restart_warm_equals_the_state_before_the_crash(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path / "a"), snapshot_interval=7)
    _populate(pkg, store)
    before = _state(pkg, store)
    store.close()
    revived = pkg.wal.PersistentDataStore(str(tmp_path / "a"))
    assert _state(pkg, revived) == before and not revived.recovered_torn_tail
    only = pkg.wal.PersistentDataStore(str(tmp_path / "b"))
    _populate(pkg, only, studies=2)
    before = _state(pkg, only)
    only.compact_now()
    only.close()
    assert os.path.getsize(tmp_path / "b" / pkg.wal.LOG_FILE) == 0
    assert _state(pkg, pkg.wal.PersistentDataStore(str(tmp_path / "b"))) == before
    fresh = pkg.wal.PersistentDataStore(str(tmp_path / "c"))
    assert fresh.recovered_records == 0 and fresh.list_studies("owners/o") == []


@PKGS
def test_a_deleted_study_stays_deleted_across_restarts_and_compaction(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    _populate(pkg, store, studies=2)
    store.delete_study("owners/o/studies/s0")
    store.close()
    revived = pkg.wal.PersistentDataStore(str(tmp_path))
    with pytest.raises(pkg.ds.NotFoundError):
        revived.load_study("owners/o/studies/s0")
    revived.compact_now()
    revived.close()
    again = pkg.wal.PersistentDataStore(str(tmp_path))
    with pytest.raises(pkg.ds.NotFoundError):
        again.load_study("owners/o/studies/s0")
    assert again.load_study("owners/o/studies/s1").name


@PKGS
def test_the_snapshot_interval_compacts_the_log(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path), snapshot_interval=5)
    _populate(pkg, store, studies=4)
    assert store.wal.appended_since_snapshot < 5
    assert os.path.getsize(tmp_path / pkg.wal.SNAPSHOT_FILE) > 0


@PKGS
@pytest.mark.parametrize("damage", ["truncated", "crc"])
def test_a_torn_or_corrupt_tail_is_dropped(pkg, damage, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    _populate(pkg, store, studies=1, trials=2, ops=1)
    before = _state(pkg, store)
    last = _trial(pkg, "s0", 99)
    store.create_trial(last)
    store.close()
    log = tmp_path / pkg.wal.LOG_FILE
    data = bytearray(log.read_bytes())
    if damage == "truncated":
        data = data[:-3]
    else:
        data[-1] ^= 0xFF
    log.write_bytes(bytes(data))
    revived = pkg.wal.PersistentDataStore(str(tmp_path))
    assert revived.recovered_torn_tail
    assert _state(pkg, revived) == before
    with pytest.raises(pkg.ds.NotFoundError):
        revived.get_trial(last.name)


@PKGS
def test_a_crash_between_snapshot_and_truncate_converges(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    _populate(pkg, store, studies=2)
    before = _state(pkg, store)
    store.close()
    inner = pkg.ram.NestedDictRAMDataStore()
    for opcode, payload in pkg.wal.read_directory(str(tmp_path))[0]:
        pkg.wal.apply_record(inner, opcode, payload)
    with open(tmp_path / pkg.wal.SNAPSHOT_FILE, "wb") as f:
        for opcode, payload in pkg.wal.export_records(inner):
            f.write(pkg.wal.WriteAheadLog._frame(opcode, payload))
    assert _state(pkg, pkg.wal.PersistentDataStore(str(tmp_path))) == before


@PKGS
def test_appends_flush_and_snapshots_fsync_unless_fsync_is_asked(pkg, tmp_path, monkeypatch):
    real_fsync, synced = os.fsync, []

    def counting_fsync(fd):
        synced.append(fd)
        real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    flushed = pkg.wal.PersistentDataStore(str(tmp_path / "a"), fsync=False)
    flushed.create_study(_study(pkg, "s0"))
    assert not synced
    flushed.compact_now()
    assert len(synced) == 1
    synced.clear()
    durable = pkg.wal.PersistentDataStore(str(tmp_path / "b"), fsync=True)
    durable.create_study(_study(pkg, "s0"))
    durable.create_study(_study(pkg, "s1"))
    assert len(synced) == 2
    durable.close()
    assert len(pkg.wal.PersistentDataStore(str(tmp_path / "b")).list_studies("owners/o")) == 2


@PKGS
def test_the_switches_feed_the_config(pkg, monkeypatch):
    for name in ("DISTRIBUTED", "DISTRIBUTED_WAL_FSYNC", "DISTRIBUTED_REPLICATION",
                 "DISTRIBUTED_REPLICAS", "DISTRIBUTED_WAL_DIR"):
        monkeypatch.delenv(pkg.prefix + name, raising=False)
    default = pkg.config.DistributedConfig.from_env()
    assert default == pkg.config.DistributedConfig()
    assert not default.wal_fsync and default.replication and default.routing
    monkeypatch.setenv(pkg.prefix + "DISTRIBUTED_WAL_FSYNC", "1")
    monkeypatch.setenv(pkg.prefix + "DISTRIBUTED_REPLICATION", "0")
    monkeypatch.setenv(pkg.prefix + "DISTRIBUTED_REPLICAS", "7")
    monkeypatch.setenv(pkg.prefix + "DISTRIBUTED_WAL_DIR", "/tmp/w")
    env = pkg.config.DistributedConfig.from_env()
    assert (env.wal_fsync, env.replication, env.num_replicas, env.wal_root) == (
        True, False, 7, "/tmp/w")


def test_the_port_reads_only_its_own_switches(monkeypatch):
    monkeypatch.setenv("VIZIER_DISTRIBUTED_REPLICAS", "9")
    monkeypatch.delenv("VIZIER_TORCH_DISTRIBUTED_REPLICAS", raising=False)
    assert config.DistributedConfig.from_env().num_replicas == config.DEFAULT_REPLICAS
    assert jconfig.DistributedConfig.from_env().num_replicas == 9
    assert config.DistributedConfig().as_dict() == jconfig.DistributedConfig().as_dict()


@PKGS
def test_a_failed_append_poisons_the_store(pkg, tmp_path, monkeypatch):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    store.create_study(_study(pkg, "s0"))

    def full_disk(opcode, payload):
        raise OSError("No space left on device")

    monkeypatch.setattr(store.wal, "append", full_disk)
    with pytest.raises(OSError):
        store.create_study(_study(pkg, "s1"))
    for call in (lambda: store.load_study("owners/o/studies/s1"),
                 lambda: store.list_studies("owners/o"),
                 lambda: store.create_study(_study(pkg, "s2")), store.compact_now):
        with pytest.raises(pkg.wal.StoreDivergedError):
            call()
    store.close()
    revived = pkg.wal.PersistentDataStore(str(tmp_path))
    assert [s.name for s in revived.list_studies("owners/o")] == ["owners/o/studies/s0"]


def _corrupt_midpoint(path):
    data = bytearray(path.read_bytes())
    midpoint = len(data) // 2
    data[midpoint:midpoint + 16] = b"\xff" * 16
    path.write_bytes(bytes(data))


@PKGS
def test_mid_log_corruption_is_quarantined_and_later_appends_survive(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    _populate(pkg, store, studies=3)
    store.close()
    log = tmp_path / pkg.wal.LOG_FILE
    _corrupt_midpoint(log)
    corrupted = log.read_bytes()
    revived = pkg.wal.PersistentDataStore(str(tmp_path))
    assert revived.recovered_torn_tail and revived.recovered_quarantined_bytes > 0
    sidecar = tmp_path / (pkg.wal.LOG_FILE + pkg.wal.CORRUPT_SUFFIX)
    assert log.read_bytes() + sidecar.read_bytes() == corrupted
    records, torn = pkg.wal.WriteAheadLog._read_records(str(log))
    assert not torn and records
    revived.create_study(_study(pkg, "after"))
    after = _state(pkg, revived)
    revived.close()
    again = pkg.wal.PersistentDataStore(str(tmp_path))
    assert _state(pkg, again) == after and again.load_study("owners/o/studies/after").name
    clean = pkg.wal.PersistentDataStore(str(tmp_path / "clean"))
    _populate(pkg, clean, studies=1)
    clean.close()
    assert pkg.wal.PersistentDataStore(str(tmp_path / "clean")).recovered_quarantined_bytes == 0


def test_the_quarantine_moves_the_same_bytes_in_both_packages(tmp_path):
    moved = []
    for pkg in (JAX, PORT):
        directory = tmp_path / pkg.name
        store = pkg.wal.PersistentDataStore(str(directory))
        _populate(pkg, store, studies=3)
        store.close()
        _corrupt_midpoint(directory / pkg.wal.LOG_FILE)
        pkg.wal.PersistentDataStore(str(directory)).close()
        moved.append(_files(directory))
    assert moved[1] == moved[0]


@PKGS
def test_sequence_numbers_count_mutations_across_restarts_and_compaction(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    assert store.seq == 0
    _populate(pkg, store, studies=2)
    seq = store.seq
    assert seq == 2 * 11  # per study: create, 4 trials, 2 updates, 2 ops, 1 es op, metadata
    store.compact_now()
    assert store.seq == seq
    store.close()
    revived = pkg.wal.PersistentDataStore(str(tmp_path))
    assert revived.seq == seq
    revived.create_study(_study(pkg, "extra"))
    assert revived.seq == seq + 1
    other = pkg.wal.PersistentDataStore(str(tmp_path / "two"))
    other.create_study(_study(pkg, "s0"))
    other.create_trial(_trial(pkg, "s0"))
    assert other.seq == 2


@PKGS
def test_read_directory_with_seqs_places_the_snapshot_and_the_log(pkg, tmp_path):
    store = pkg.wal.PersistentDataStore(str(tmp_path))
    store.create_study(_study(pkg, "s0"))
    store.compact_now()
    store.create_study(_study(pkg, "s1"))
    seq = store.seq
    store.close()
    records, torn = pkg.wal.read_directory_with_seqs(str(tmp_path))
    seqs = [s for s, _, _ in records]
    assert not torn and max(seqs) == seq and seqs == sorted(seqs)
    plain, _ = pkg.wal.read_directory(str(tmp_path))
    assert [(op, pl) for _, op, pl in records] == plain


@PKGS
def test_export_with_seq_and_the_append_hook(pkg, tmp_path):
    seen = []

    class Sink:
        def submit(self, seq, opcode, payload):
            seen.append(seq)

    store = pkg.wal.PersistentDataStore(str(tmp_path / "a"), on_append=Sink())
    _populate(pkg, store, studies=1)
    assert seen == list(range(1, len(seen) + 1))
    seq, records = store.export_with_seq()
    assert seq == store.seq and records == pkg.wal.export_records(store._inner)

    class Boom:
        def submit(self, seq, opcode, payload):
            raise RuntimeError("streamer exploded")

    boom = pkg.wal.PersistentDataStore(str(tmp_path / "b"), on_append=Boom())
    boom.create_study(_study(pkg, "s0"))
    assert boom.load_study("owners/o/studies/s0").name and boom.seq == 1


@PKGS
def test_record_framing_and_study_keys(pkg, tmp_path):
    with pytest.raises(ValueError):
        pkg.wal.WriteAheadLog(str(tmp_path / "log")).append(99, b"payload")
    store = pkg.wal.PersistentDataStore(str(tmp_path / "s"))
    _populate(pkg, store, studies=1)
    store.delete_trial("owners/o/studies/s0/trials/3")
    store.close()
    records, torn = pkg.wal.read_directory(str(tmp_path / "s"))
    assert not torn and records
    assert {pkg.wal.study_key_of(op, pl) for op, pl in records} == {"owners/o/studies/s0"}
    assert {pkg.wal.CREATE_STUDY, pkg.wal.UPDATE_METADATA, pkg.wal.DELETE_TRIAL} <= {
        op for op, _ in records}


def test_the_record_vocabulary_equals_the_jax_packages():
    for name in ("CREATE_STUDY", "UPDATE_STUDY", "DELETE_STUDY", "CREATE_TRIAL", "UPDATE_TRIAL",
                 "DELETE_TRIAL", "CREATE_SUGGESTION_OP", "UPDATE_SUGGESTION_OP",
                 "CREATE_EARLY_STOPPING_OP", "UPDATE_EARLY_STOPPING_OP", "UPDATE_METADATA",
                 "SNAPSHOT_META", "SNAPSHOT_FILE", "LOG_FILE", "CORRUPT_SUFFIX", "DATA_OPCODES"):
        assert getattr(wal, name) == getattr(jwal, name), name
    for opcode in sorted(jwal.DATA_OPCODES):
        payload = b"payload-%d" % opcode
        assert wal.WriteAheadLog._frame(opcode, payload) == jwal.WriteAheadLog._frame(
            opcode, payload)


# -- ShardedDataStore -----------------------------------------------------------------


def test_sharded_stores_place_studies_on_the_same_shards():
    placed = []
    for pkg in (JAX, PORT):
        shards = [pkg.ram.NestedDictRAMDataStore() for _ in range(3)]
        store = pkg.sharded.ShardedDataStore(shards)
        where = []
        for i in range(24):
            study = _study(pkg, f"s{i}")
            store.create_study(study)
            store.create_trial(_trial(pkg, f"s{i}"))
            owner = store.shard_for(study.name)
            where.append(shards.index(owner))
            assert owner.load_study(study.name).name == study.name
            assert owner.max_trial_id(study.name) == 1
            assert all(not any(s.name == study.name for s in other.list_studies("owners/o"))
                       for other in shards if other is not owner)
        assert len(store.list_studies("owners/o")) == 24
        placed.append(where)
    assert placed[1] == placed[0] and len(set(placed[1])) == 3


@PKGS
def test_a_sharded_store_refuses_bad_shards(pkg):
    with pytest.raises(ValueError):
        pkg.sharded.ShardedDataStore([])
    with pytest.raises(ValueError):
        pkg.sharded.ShardedDataStore([pkg.ram.NestedDictRAMDataStore()], shard_ids=["a", "b"])


# -- standby logs and recovery plans ----------------------------------------------------


def _records(pkg, *items):
    out = []
    for seq, opcode, sid in items:
        if opcode == pkg.wal.DELETE_STUDY:
            payload = f"owners/o/studies/{sid}".encode()
        else:
            payload = _study(pkg, sid).SerializeToString()
        out.append((seq, opcode, payload))
    return out


def _standby_script(pkg, store):
    """Deliveries, fences and restarts; returns every answer."""
    w = pkg.wal
    answers = [
        store.append_batch("origin-a", 1, _records(pkg, (1, w.CREATE_STUDY, "s0")), reset=True),
        store.append_batch("origin-a", 1, _records(pkg, (2, w.UPDATE_STUDY, "s0"))),
        store.append_batch("origin-a", 1, _records(pkg, (1, w.UPDATE_STUDY, "s0"))),  # stale seq
        store.append_batch("origin-a", 2, _records(pkg, (3, w.CREATE_STUDY, "s1"))),  # no baseline
    ]
    store.fence("origin-a", 2)
    answers += [
        store.append_batch("origin-a", 1, _records(pkg, (4, w.UPDATE_STUDY, "s0"))),  # fenced
        store.append_batch("origin-a", 1, [], reset=True),  # a stale reset is fenced too
        store.append_batch("origin-a", 2, _records(pkg, (5, w.CREATE_STUDY, "s0"),
                                                    (5, w.CREATE_STUDY, "s1")),
                           reset=True, baseline_seq=5),
        store.append_batch("origin-a", 2, _records(pkg, (6, w.DELETE_STUDY, "s1"))),
        store.append_batch("origin-b", 3, _records(pkg, (9, w.CREATE_STUDY, "s2")), reset=True,
                           baseline_seq=9),
    ]
    answers.append((store.epoch("origin-a"), store.last_seq("origin-a"),
                    [r[0] for r in store.records_for("origin-a")], store.depths(),
                    store.view_for("origin-a").baseline_seq, store.view_for("nobody")))
    return answers


def test_standby_files_and_fencing_answers_equal_the_jax_packages(tmp_path):
    out = []
    for pkg in (JAX, PORT):
        directory = str(tmp_path / pkg.name)
        store = pkg.repl.StandbyStore(directory)
        answers = _standby_script(pkg, store)
        store.close()
        reloaded = pkg.repl.StandbyStore(directory)
        answers.append((reloaded.epoch("origin-a"), reloaded.records_for("origin-a"),
                        reloaded.view_for("origin-b").baseline_seq))
        files = {}
        for root, _, names in os.walk(directory):
            for name in names:
                path = os.path.join(root, name)
                files[os.path.relpath(path, directory)] = open(path, "rb").read()
        out.append((answers, files))
    assert out[1] == out[0]
    answers, files = out[1]
    assert [a[0] for a in answers[:8]] == [True, True, True, False, False, False, True, True]
    assert answers[9][:3] == (2, 6, [5, 5, 6])
    assert set(files) == {"standby/origin-a/standby.log", "standby/origin-b/standby.log"}


@PKGS
def test_a_memory_standby_store_keeps_the_same_answers(pkg, tmp_path):
    disk = _standby_script(pkg, pkg.repl.StandbyStore(str(tmp_path)))
    memory = _standby_script(pkg, pkg.repl.StandbyStore(None))
    assert memory == disk


def _plan_cases(pkg):
    w, view = pkg.wal, pkg.repl.StandbyView
    r = lambda *items: _records(pkg, *items)  # noqa: E731
    return {
        "standby_when_local_missing": dict(
            local=[], torn=False, views=[view(0, r((1, w.CREATE_STUDY, "s0")))]),
        "standby_wins_ties": dict(
            local=r((5, w.CREATE_STUDY, "s0")), torn=False,
            views=[view(0, r((5, w.CREATE_STUDY, "s0")))]),
        "local_only_when_longer": dict(
            local=r((5, w.CREATE_STUDY, "s0"), (6, w.UPDATE_STUDY, "s0")), torn=False,
            views=[view(0, r((5, w.CREATE_STUDY, "s0")))]),
        "corrupt_prefix_loses": dict(
            local=r((5, w.CREATE_STUDY, "s0")), torn=True,
            views=[view(0, r((5, w.CREATE_STUDY, "s0"), (8, w.UPDATE_STUDY, "s0")))]),
        "best_standby_per_study": dict(
            local=[], torn=False, views=[
                view(0, r((3, w.CREATE_STUDY, "s0"))),
                view(0, r((3, w.CREATE_STUDY, "s0"), (9, w.UPDATE_STUDY, "s0"),
                          (9, w.CREATE_STUDY, "s1")))]),
        "net_deleted": dict(
            local=r((1, w.CREATE_STUDY, "s0"), (2, w.DELETE_STUDY, "s0")), torn=False, views=[]),
        "absence_outranks_stale_local": dict(
            local=r((6, w.CREATE_STUDY, "s0")), torn=True, views=[view(20, [])]),
        "absence_ignored_off_the_successor_set": dict(
            local=r((6, w.CREATE_STUDY, "s0")), torn=False, views=[view(20, [])],
            successors_fn=lambda study: ["replica-9"], holders=["replica-1"]),
        "catch_up_keeps_late_deletes": dict(
            local=r((1, w.CREATE_STUDY, "s0"), (7, w.DELETE_STUDY, "s0")), torn=False, views=[],
            min_seq=5),
        "catch_up_skips_replayed": dict(
            local=r((1, w.CREATE_STUDY, "s0")), torn=False, views=[], min_seq=4),
    }


_PLAN_WANT = {
    "standby_when_local_missing": [("s0", "standby", 1, 1)],
    "standby_wins_ties": [("s0", "standby", 5, 1)],
    "local_only_when_longer": [("s0", "local", 6, 2)],
    "corrupt_prefix_loses": [("s0", "standby", 8, 2)],
    "best_standby_per_study": [("s0", "standby", 9, 2), ("s1", "standby", 9, 1)],
    "net_deleted": [],
    "absence_outranks_stale_local": [],
    "absence_ignored_off_the_successor_set": [("s0", "local", 6, 1)],
    "catch_up_keeps_late_deletes": [("s0", "local", 7, 1)],
    "catch_up_skips_replayed": [],
}


def _plan(pkg, case):
    kw = dict(case)
    local, torn, views = kw.pop("local"), kw.pop("torn"), kw.pop("views")
    plan = pkg.repl.plan_recovery("origin", local, torn, views, **kw)
    return ([(s.study, s.source, s.seq, s.records) for s in plan.studies], plan.local_torn,
            plan.max_seq, plan.source_counts())


@pytest.mark.parametrize("name", sorted(_PLAN_WANT))
def test_plan_recovery_chooses_the_jax_packages_sources(name):
    theirs = _plan(JAX, _plan_cases(JAX)[name])
    ours = _plan(PORT, _plan_cases(PORT)[name])
    assert ours == theirs
    assert [(s.rsplit("/", 1)[1], src, seq, len(recs)) for s, src, seq, recs in ours[0]] == (
        _PLAN_WANT[name])


class _Successors:
    """Two in-memory standby stores behind a deliver function."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.stores = {"succ-a": pkg.repl.StandbyStore(None), "succ-b": pkg.repl.StandbyStore(None)}
        self.alive = {"succ-a": True, "succ-b": True}
        self.seq, self.records = 0, []

    def deliver(self, successor, origin, epoch, records, reset, baseline_seq):
        if not self.alive[successor]:
            return None
        return self.stores[successor].append_batch(origin, epoch, records, reset=reset,
                                                   baseline_seq=baseline_seq)

    def baseline(self, successor):
        return self.seq, [(self.seq, op, pl) for op, pl in self.records]

    def streamer(self, successors=("succ-a", "succ-b"), **kw):
        return self.pkg.repl.ReplicationStreamer(
            "origin", 1, successors_fn=lambda key: list(successors), deliver_fn=self.deliver,
            baseline_fn=self.baseline, **kw)

    def put(self, seq):
        self.seq = seq
        self.records = [(self.pkg.wal.CREATE_STUDY, _study(self.pkg, "s0").SerializeToString())]
        return self.records[0][1]


@PKGS
def test_a_streamer_reaches_both_successors(pkg):
    fake = _Successors(pkg)
    streamer = fake.streamer()
    try:
        streamer.submit(1, pkg.wal.CREATE_STUDY, fake.put(1))
        assert streamer.flush(5)
        assert [s.last_seq("origin") for s in fake.stores.values()] == [1, 1]
        assert streamer.lag() == 0
    finally:
        streamer.close()


@PKGS
def test_a_dead_successor_is_rebaselined_on_return(pkg):
    fake = _Successors(pkg)
    fake.alive["succ-b"] = False
    streamer = fake.streamer()
    try:
        streamer.submit(1, pkg.wal.CREATE_STUDY, fake.put(1))
        assert streamer.flush(5)
        assert fake.stores["succ-b"].last_seq("origin") == 0
        fake.alive["succ-b"] = True
        streamer.request_resync("succ-b")
        assert streamer.flush(5)
        assert fake.stores["succ-b"].last_seq("origin") == 1
    finally:
        streamer.close()


@PKGS
def test_queue_overflow_drops_then_rebaselines(pkg):
    fake = _Successors(pkg)
    fake.alive = {"succ-a": False, "succ-b": False}
    streamer = fake.streamer(queue_size=4, batch_max=2)
    try:
        payload = fake.put(63)
        for seq in range(1, 64):
            streamer.submit(seq, pkg.wal.CREATE_STUDY, payload)
        streamer.flush(2)
        assert streamer.dropped > 0
        fake.alive = {"succ-a": True, "succ-b": True}
        streamer.submit(64, pkg.wal.CREATE_STUDY, fake.put(64))
        assert streamer.flush(5)
        assert [s.last_seq("origin") for s in fake.stores.values()] == [64, 64]
    finally:
        streamer.close()


@PKGS
def test_a_fenced_streamer_stops(pkg):
    fake = _Successors(pkg)
    streamer = fake.streamer(successors=("succ-a",))
    try:
        payload = fake.put(1)
        streamer.submit(1, pkg.wal.CREATE_STUDY, payload)
        assert streamer.flush(5)
        fake.stores["succ-a"].fence("origin", 2)
        streamer.submit(2, pkg.wal.UPDATE_STUDY, payload)
        deadline = time.monotonic() + 5
        while not streamer.fenced and time.monotonic() < deadline:
            time.sleep(0.01)
        assert streamer.fenced, "the fenced streamer did not stop within 5 s"
    finally:
        streamer.close()


# -- NetChaos -------------------------------------------------------------------------


def _outcomes(pkg, seed, rules, calls):
    net = pkg.netchaos.NetChaos(seed=seed, sleep_fn=lambda s: None)
    for (src, dst), kw in rules.items():
        net.set_link(src, dst, **kw)
    seen = []
    for src, dst in calls:
        try:
            seen.append("dup" if net.strike(src, dst) else "ok")
        except pkg.netchaos.PartitionedError:
            seen.append("partitioned")
        except pkg.netchaos.LinkDroppedError:
            seen.append("drop")
    return seen, net.counts()


@pytest.mark.parametrize("seed", [0, 7, 9])
def test_one_seed_strikes_the_same_calls_in_both_packages(seed):
    rules = {("a", "b"): dict(drop_prob=0.3, duplicate_prob=0.2),
             ("a", "*"): dict(delay_prob=0.5, delay_secs=0.01),
             ("*", "*"): dict(drop_prob=0.1)}
    calls = [("a", "b"), ("a", "c"), ("b", "a"), ("c", "d")] * 30
    ours = _outcomes(PORT, seed, rules, calls)
    assert ours == _outcomes(JAX, seed, rules, calls)
    assert {"ok", "drop", "dup"} <= set(ours[0])


@pytest.mark.parametrize("spec", [
    "seed=9;drop=a>b:0.25;delay=a>*:0.05@0.3;dup=x>y:0.1;partition=c;partition=m>n",
    "delay=a>b:0.5", "seed=3;drop=*>*:0.5;dup=a>b:0.5"])
def test_spec_strings_parse_to_the_same_schedule(spec):
    nets = [pkg.netchaos.NetChaos.from_spec(spec) for pkg in (JAX, PORT)]
    assert nets[1].seed == nets[0].seed
    for src, dst in (("a", "b"), ("a", "z"), ("x", "y"), ("c", "q"), ("m", "n"), ("n", "m")):
        rules = [n._rule_for(src, dst) for n in nets]
        assert [vars(r) if r else None for r in rules[1:]] == [vars(rules[0]) if rules[0] else None]
        assert nets[1].is_partitioned(src, dst) == nets[0].is_partitioned(src, dst)


@PKGS
def test_drops_delays_and_duplicates(pkg):
    net = pkg.netchaos.NetChaos(seed=0)
    net.set_link("a", "b", drop_prob=1.0)
    with pytest.raises(ConnectionError):
        net.wrap(lambda: "ok", "a", "b")()
    slept = []
    slow = pkg.netchaos.NetChaos(seed=0, sleep_fn=slept.append)
    slow.set_link("a", "b", delay_prob=1.0, delay_secs=0.25)
    assert slow.wrap(lambda: "ok", "a", "b")() == "ok" and slept == [0.25]
    calls = []
    dup = pkg.netchaos.NetChaos(seed=0)
    dup.set_link("a", "b", duplicate_prob=1.0)
    assert dup.wrap(lambda: calls.append(1) or len(calls), "a", "b")() == 2
    wild = pkg.netchaos.NetChaos(seed=0)
    wild.set_link("*", "*", drop_prob=1.0)
    wild.set_link("a", "b", drop_prob=0.0)
    wild.strike("a", "b")
    with pytest.raises(pkg.netchaos.LinkDroppedError):
        wild.strike("a", "c")
    with pytest.raises(ValueError):
        pkg.netchaos.NetChaos(seed=0).set_link("a", "b", drop_prob=1.5)
    for bad in ("drop=a:0.5", "frobnicate=a>b:1", "drop="):
        with pytest.raises(ValueError):
            pkg.netchaos.NetChaos.from_spec(bad)


@PKGS
def test_partitions_heal_and_keep_the_stream_aligned(pkg):
    net = pkg.netchaos.NetChaos(seed=0)
    net.partition("b")
    for src, dst in (("a", "b"), ("b", "a")):
        with pytest.raises(pkg.netchaos.PartitionedError):
            net.strike(src, dst)
    net.heal("b")
    net.strike("a", "b")
    net.partition_link("a", "b")
    net.strike("b", "a")
    with pytest.raises(pkg.netchaos.PartitionedError):
        net.strike("a", "b")
    net.heal("b")
    assert not net.is_partitioned("a", "b")

    def run(partition_first):
        n = pkg.netchaos.NetChaos(seed=9)
        n.set_link("a", "b", drop_prob=0.5)
        if partition_first:
            n.partition("b")
        for _ in range(5):
            try:
                n.strike("a", "b")
            except pkg.netchaos.NetChaosError:
                pass
        n.heal("b")
        return _outcomes_after(pkg, n)

    assert run(True) == run(False)


def _outcomes_after(pkg, net):
    out = []
    for _ in range(10):
        try:
            net.strike("a", "b")
            out.append("ok")
        except pkg.netchaos.LinkDroppedError:
            out.append("drop")
    return out


class _Stub:
    def Suggest(self, request):
        return ("served", request)

    def Other(self, request):
        return "other"


@PKGS
def test_wrapped_stubs_strike_their_listed_methods(pkg):
    net = pkg.netchaos.NetChaos(seed=0)
    net.partition("replica-0")
    listed = net.wrap_stub(_Stub(), "client", "replica-0", methods=["Suggest"])
    with pytest.raises(pkg.netchaos.PartitionedError):
        listed.Suggest("r")
    assert listed.Other("r") == "other"
    with pytest.raises(pkg.netchaos.PartitionedError):
        net.wrap_stub(_Stub(), "client", "replica-0").Other("r")
    counts = net.counts()["client>replica-0"]
    assert counts["calls"] == 2 and counts["partitioned"] == 2 and net.total("partitioned") == 2


def test_the_ports_netchaos_composes_with_a_stub_fault_injector():
    """The port's link schedule around another injector's stub proxy (here
    the JAX package's ``ChaosMonkey``; the port's ``testing/chaos.py`` is not
    ported yet): the outer link strikes first, each from its own stream."""
    monkey = jchaos.ChaosMonkey(seed=1, failure_prob=1.0)
    inner = jchaos.ChaosServiceStub(_Stub(), monkey, methods=("Suggest",))
    net = netchaos.NetChaos(seed=2)
    stub = net.wrap_stub(inner, "client", "replica-0")
    net.partition("replica-0")
    with pytest.raises(netchaos.PartitionedError):
        stub.Suggest("r")
    net.heal("replica-0")
    with pytest.raises(jchaos.InjectedFaultError):
        stub.Suggest("r")
