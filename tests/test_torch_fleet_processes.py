"""The fleet across process boundaries on the CPU, held to the JAX package's.

- ``replication_service.proto``: every message's descriptor equals the JAX
  package's but for the package name, the file registers under the port's
  package, ``build.sh`` regenerates the five committed ``_pb2.py`` files byte
  for byte, and the method paths differ: each package's replication client
  gets UNIMPLEMENTED from the other's server (ROADMAP C9).
- the wire protocol on a real loopback gRPC server: baselines and appends,
  fencing over the wire, deduplication of duplicated deliveries, the recovery
  plumbing, the link's retries, dead-peer cooldown and repointing, the
  origin-side host; the partition matrix (partition during appends, a fenced
  stale origin, lease expiry against a slow replica).
- subprocesses (``replica_main`` / ``pythia_server_main`` with ``--device
  cpu``): SIGKILL of a study's owner fails over from the standby logs and
  revives on its old port; SIGTERM drains, flushes, compacts and dumps; the
  shared compute tier survives its server's crash through the frontends'
  local fallback and is respawned by the lease loop; ``--device cuda``
  without a GPU refuses to start.

Every wait on a process is bounded by its own deadline and says what it
waited for when it fails.
"""

from __future__ import annotations

import json
import os
import pathlib
import select
import shutil
import signal
import socket
import subprocess
import sys
import time
from concurrent import futures

import grpc
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
from google.protobuf import descriptor_pb2

from vizier_tpu.distributed import replication as jreplication
from vizier_tpu.distributed import replication_service as jrepl_service
from vizier_tpu.service import grpc_stubs as jgrpc_stubs
from vizier_tpu.service.protos import replication_service_pb2 as jpb
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.distributed import replication
from vizier_tpu_torch.distributed import replication_service as repl_service
from vizier_tpu_torch.distributed import subprocess_fleet
from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.reliability import ReliabilityConfig
from vizier_tpu_torch.service import grpc_stubs
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import protos
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import vizier_client
from vizier_tpu_torch.service.protos import replication_service_pb2 as pb
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2
from vizier_tpu_torch.testing import netchaos as netchaos_lib

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PB2 = ("key_value_pb2", "study_pb2", "vizier_service_pb2", "pythia_service_pb2",
        "replication_service_pb2")
# One torch thread per child, as the test processes themselves run.
_CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
STUDY = "owners/o/studies/wire"


# -- the proto ------------------------------------------------------------------------


@pytest.mark.parametrize("message", sorted(jpb.DESCRIPTOR.message_types_by_name))
def test_replication_message_descriptors_equal_the_jax_packages(message):
    a, b = descriptor_pb2.DescriptorProto(), descriptor_pb2.DescriptorProto()
    jpb.DESCRIPTOR.message_types_by_name[message].CopyToProto(a)
    pb.DESCRIPTOR.message_types_by_name[message].CopyToProto(b)
    assert str(b).replace('".vizier_tpu_torch.', '".vizier_tpu.') == str(a)
    assert pb.DESCRIPTOR.message_types_by_name[message].full_name == f"vizier_tpu_torch.{message}"


def test_the_replication_file_registers_under_the_ports_package():
    assert pb.DESCRIPTOR.name == "vizier_tpu_torch/service/protos/replication_service.proto"
    assert pb.DESCRIPTOR.package == "vizier_tpu_torch" and jpb.DESCRIPTOR.package == "vizier_tpu"
    assert sorted(pb.DESCRIPTOR.message_types_by_name) == sorted(
        jpb.DESCRIPTOR.message_types_by_name)
    service = pb.DESCRIPTOR.services_by_name["ReplicationService"]
    assert [(m.name, m.input_type.name, m.output_type.name) for m in service.methods] == [
        (name, req.DESCRIPTOR.name, resp.DESCRIPTOR.name)
        for name, (req, resp) in jgrpc_stubs.REPLICATION_METHODS.items()]
    assert list(grpc_stubs.REPLICATION_METHODS) == list(jgrpc_stubs.REPLICATION_METHODS)
    assert grpc_stubs.REPLICATION_SERVICE_NAME == "vizier_tpu_torch.ReplicationService"
    assert protos.replication_service_pb2 is pb


def test_a_record_crosses_the_packages_byte_for_byte():
    request = pb.DeliverAppendsRequest(origin="replica-0", epoch=3, reset=True, baseline_seq=7)
    request.records.add(seq=7, opcode=1, payload=b"\x00payload")
    data = request.SerializeToString(deterministic=True)
    theirs = jpb.DeliverAppendsRequest.FromString(data)
    assert theirs.SerializeToString(deterministic=True) == data
    assert repl_service.records_from_proto(request.records) == jrepl_service.records_from_proto(
        theirs.records)


def test_build_sh_regenerates_the_committed_modules(tmp_path):
    if shutil.which("protoc") is None:
        pytest.fail("protoc is not on PATH")
    out = tmp_path / "vizier_tpu_torch" / "service" / "protos"
    out.mkdir(parents=True)
    source = _ROOT / "vizier_tpu_torch" / "service" / "protos"
    for path in list(source.glob("*.proto")) + [source / "build.sh"]:
        shutil.copy(path, out / path.name)
    run = subprocess.run(["bash", str(out / "build.sh")], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert "Regenerated 5 message modules." in run.stdout
    for name in _PB2:
        assert (out / f"{name}.py").read_bytes() == (source / f"{name}.py").read_bytes(), name


class _Receiver:
    """One replica's receiver side behind a real loopback gRPC server."""

    def __init__(self, tmpdir, replica_id="replica-1", *, datastore=True, package=None):
        repl, service, stubs = package or (replication, repl_service, grpc_stubs)
        self.standby = repl.StandbyStore(str(tmpdir))
        self.datastore = (wal_lib.PersistentDataStore(str(tmpdir), snapshot_interval=10_000)
                          if datastore else None)
        self.servicer = service.ReplicationServicer(replica_id, self.standby,
                                                    datastore=self.datastore)
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        stubs.add_replication_servicer_to_server(self.servicer, self.server)
        self.endpoint = f"localhost:{self.server.add_insecure_port('localhost:0')}"
        self.server.start()

    def stop(self):
        self.server.stop(0).wait()
        grpc_stubs.close_channel(self.endpoint)
        jgrpc_stubs.close_channel(self.endpoint)
        if self.datastore is not None:
            self.datastore.close()
        self.standby.close()


@pytest.fixture
def receiver(tmp_path):
    r = _Receiver(tmp_path / "rx")
    yield r
    r.stop()


def test_the_replication_method_paths_differ_between_the_packages(tmp_path):
    ours = _Receiver(tmp_path / "ours", datastore=False)
    theirs = _Receiver(tmp_path / "theirs", datastore=False,
                       package=(jreplication, jrepl_service, jgrpc_stubs))
    try:
        for stubs, server, request in (
                (jgrpc_stubs, ours, jpb.HeartbeatRequest(sender="t")),
                (grpc_stubs, theirs, pb.HeartbeatRequest(sender="t"))):
            channel = grpc.insecure_channel(server.endpoint)
            try:
                with pytest.raises(grpc.RpcError) as error:
                    stubs.ReplicationServiceStub(channel).Heartbeat(request)
                assert error.value.code() == grpc.StatusCode.UNIMPLEMENTED
            finally:
                channel.close()
        assert grpc_stubs.create_replication_stub(ours.endpoint).Heartbeat(
            pb.HeartbeatRequest()).replica_id == "replica-1"
    finally:
        ours.stop()
        theirs.stop()


# -- the wire protocol ----------------------------------------------------------------


def _record(seq, name=STUDY, opcode=wal_lib.CREATE_STUDY):
    return (seq, opcode, study_pb2.Study(name=name).SerializeToString())


def _link(endpoint, **kw):
    return repl_service.GrpcReplicationLink({"replica-1": endpoint}, **kw)


def test_baselines_and_appends_ack_the_last_seq(receiver):
    link = _link(receiver.endpoint)
    assert link.deliver("replica-1", "replica-0", 1, [_record(1)], True, 1) == (True, 1)
    assert link.deliver("replica-1", "replica-0", 1,
                        [_record(2, opcode=wal_lib.UPDATE_STUDY)], False, 0) == (True, 2)
    assert len(receiver.standby.records_for("replica-0")) == 2
    # A delivery ahead of the standby's epoch without a baseline is refused,
    # and it is not a fencing event.
    assert link.deliver("replica-1", "replica-0", 3, [_record(3)], False, 0) == (False, 1)
    stub = grpc_stubs.create_replication_stub(receiver.endpoint)
    assert stub.Heartbeat(pb.HeartbeatRequest()).fenced_rejections == 0


def test_a_fence_over_the_wire_rejects_and_counts_the_stale_epoch(receiver):
    link = _link(receiver.endpoint)
    link.deliver("replica-1", "replica-0", 1, [_record(1)], True, 1)
    stub = grpc_stubs.create_replication_stub(receiver.endpoint)
    assert stub.Fence(pb.FenceRequest(origin="replica-0", epoch=5)).epoch == 5
    assert link.deliver("replica-1", "replica-0", 1, [_record(2)], False, 0) == (False, 5)
    heartbeat = stub.Heartbeat(pb.HeartbeatRequest(sender="t"))
    assert heartbeat.fenced_rejections == 1 and heartbeat.replica_id == "replica-1"
    assert len(receiver.standby.records_for("replica-0")) == 1


def test_a_duplicated_delivery_is_deduplicated_by_sequence(receiver):
    net = netchaos_lib.NetChaos(seed=0)
    net.set_link("replica-0", "replica-1", duplicate_prob=1.0)
    link = _link(receiver.endpoint, src_id="replica-0", netchaos=net)
    link.deliver("replica-1", "replica-0", 1, [_record(1)], True, 1)
    assert link.deliver("replica-1", "replica-0", 1, [_record(2, opcode=wal_lib.UPDATE_STUDY)],
                        False, 0) == (True, 2)
    assert net.total("duplicates") >= 1
    assert len(receiver.standby.records_for("replica-0")) == 2


def test_the_recovery_plumbing_round_trips(receiver):
    link = _link(receiver.endpoint)
    records = [_record(3), _record(4, opcode=wal_lib.UPDATE_STUDY)]
    link.deliver("replica-1", "replica-0", 2, records, True, 3)
    stub = grpc_stubs.create_replication_stub(receiver.endpoint)
    export = stub.ExportStandby(pb.ExportStandbyRequest(origin="replica-0"))
    assert (export.present, export.epoch, export.baseline_seq) == (True, 2, 3)
    assert repl_service.records_from_proto(export.records) == records
    assert not stub.ExportStandby(pb.ExportStandbyRequest(origin="nobody")).present
    request = pb.ApplyRecordsRequest()
    repl_service.records_to_proto([_record(1, name="owners/o/studies/a"),
                                   _record(2, name="owners/o/studies/b")], request.records)
    assert stub.ApplyRecords(request).applied == 2
    assert receiver.datastore.seq == 2  # re-logged on the receiver's disk
    state = stub.ExportState(pb.ExportStateRequest(studies=["owners/o/studies/b"]))
    assert state.seq == 2
    assert {wal_lib.study_key_of(r.opcode, r.payload) for r in state.records} == {
        "owners/o/studies/b"}
    assert not stub.Resync(pb.ResyncRequest(successor="x")).requested
    assert stub.FlushStream(pb.FlushStreamRequest()).flushed


def test_an_unreachable_peer_reports_none_and_cools_down():
    link = repl_service.GrpcReplicationLink(
        {"replica-9": "localhost:1"}, connect_timeout_secs=0.2, retry_attempts=2,
        retry_base_delay_secs=0.0, retry_max_delay_secs=0.0, down_cooldown_secs=30.0)
    assert link.deliver("replica-9", "replica-0", 1, [_record(1)], True, 1) is None
    t0 = time.monotonic()
    assert link.deliver("replica-9", "replica-0", 1, [_record(2)], False, 0) is None
    assert time.monotonic() - t0 < 0.15  # in cooldown: no second connect wait


def test_a_dropped_delivery_is_retried(receiver):
    net = netchaos_lib.NetChaos(seed=1)
    net.set_link("replica-0", "replica-1", drop_prob=0.5)
    link = _link(receiver.endpoint, src_id="replica-0", netchaos=net, retry_attempts=5,
                 retry_base_delay_secs=0.0, retry_max_delay_secs=0.0)
    for seq in range(1, 20):
        opcode = wal_lib.CREATE_STUDY if seq == 1 else wal_lib.UPDATE_STUDY
        accepted, _ = link.deliver("replica-1", "replica-0", 1, [_record(seq, opcode=opcode)],
                                   seq == 1, 1 if seq == 1 else 0)
        assert accepted
    assert net.total("drops") >= 1


def test_set_endpoint_clears_the_stub_and_the_cooldown(tmp_path):
    link = repl_service.GrpcReplicationLink({"replica-1": "localhost:1"}, connect_timeout_secs=2.0,
                                            retry_attempts=1, down_cooldown_secs=30.0)
    assert link.deliver("replica-1", "replica-0", 1, [_record(1)], True, 1) is None
    fresh = _Receiver(tmp_path / "fresh")
    try:
        link.set_endpoint("replica-1", fresh.endpoint)
        assert link.deliver("replica-1", "replica-0", 1, [_record(1)], True, 1) == (True, 1)
    finally:
        fresh.stop()


def _host(tmp_path, receiver, *, netchaos=None, name="origin", registry=None, **link_kw):
    store = wal_lib.PersistentDataStore(str(tmp_path / name), snapshot_interval=10_000)
    link = repl_service.GrpcReplicationLink({"replica-1": receiver.endpoint}, src_id="replica-0",
                                            netchaos=netchaos, **link_kw)
    host = repl_service.ReplicaReplicationHost(
        "replica-0", ["replica-0", "replica-1"], datastore=store, link=link, factor=1, epoch=1,
        repair_interval_secs=0.1, registry=registry)
    store.set_append_sink(host.sink())
    return store, host


def _wait(predicate, what: str, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"waited {timeout} s for {what}"
        time.sleep(0.02)


def test_the_host_streams_over_the_wire_and_stops_when_fenced(tmp_path, receiver):
    registry = metrics_lib.MetricsRegistry()
    store, host = _host(tmp_path, receiver, registry=registry)
    try:
        store.create_study(study_pb2.Study(name=STUDY))
        assert host.flush(10.0)
        _wait(lambda: receiver.standby.last_seq("replica-0") == 1, "the first record's delivery")
        assert [op for _, op, _ in receiver.standby.records_for("replica-0")] == [
            wal_lib.CREATE_STUDY]
        host.request_resync("replica-1")
        assert host.flush(10.0)
        resyncs = registry.counter("vizier_replication_resyncs")
        assert resyncs.value(origin="replica-0", reason="requested") >= 1
        receiver.standby.fence("replica-0", 9)
        store.update_study(study_pb2.Study(name=STUDY))
        _wait(lambda: host.fenced, "the fenced host to stop")
        assert receiver.servicer.fenced_rejections >= 1
        assert receiver.standby.last_seq("replica-0") == 1
    finally:
        host.close()
        store.close()


def _replayed(receiver):
    store = ram_datastore.NestedDictRAMDataStore()
    for _seq, opcode, payload in receiver.standby.records_for("replica-0"):
        wal_lib.apply_record(store, opcode, payload)
    return wal_lib.export_records(store)


def test_a_partition_during_appends_converges_after_heal(tmp_path):
    reference = _Receiver(tmp_path / "ref_rx")
    ref_store, ref_host = _host(tmp_path, reference, name="ref_origin",
                                retry_attempts=1, retry_base_delay_secs=0.0,
                                retry_max_delay_secs=0.0, down_cooldown_secs=0.05)
    net = netchaos_lib.NetChaos(seed=4)
    receiver = _Receiver(tmp_path / "rx")
    store, host = _host(tmp_path, receiver, netchaos=net, retry_attempts=1,
                        retry_base_delay_secs=0.0, retry_max_delay_secs=0.0,
                        down_cooldown_secs=0.05)
    try:
        def mutate(target, i):
            if i == 0:
                target.create_study(study_pb2.Study(name=STUDY))
            else:
                target.create_trial(study_pb2.Trial(name=f"{STUDY}/trials/{i}"))

        for i in range(4):
            mutate(ref_store, i)
            mutate(store, i)
        assert host.flush(10.0)
        # Both streams in sync before the partition (a loaded host's first
        # connect may time out; the repair pass re-baselines it).
        _wait(lambda: receiver.standby.last_seq("replica-0") == 4
              and reference.standby.last_seq("replica-0") == 4, "both logs at seq 4")
        resyncs_before = host.resyncs
        net.partition("replica-1")
        for i in range(4, 8):
            mutate(ref_store, i)
            mutate(store, i)
        # The window must strike a delivery (a loaded host may not reach it
        # within a fixed flush).
        _wait(lambda: net.counts().get("replica-0>replica-1", {}).get("partitioned", 0) >= 1,
              "a delivery struck by the partition")
        host.flush(2.0)
        assert receiver.standby.last_seq("replica-0") < 8
        net.heal("replica-1")
        for i in range(8, 10):
            mutate(ref_store, i)
            mutate(store, i)
        assert host.flush(10.0) and ref_host.flush(10.0)
        _wait(lambda: _replayed(receiver) == _replayed(reference),
              "the healed standby log to replay to the reference's state")
        assert receiver.standby.last_seq("replica-0") == reference.standby.last_seq("replica-0")
        # The heal cost a re-baseline. The origin counts it when the
        # baseline's response comes back, after the receiver has applied it:
        # a loaded host can show the healed log before the count.
        _wait(lambda: host.resyncs > resyncs_before, "the heal's re-baseline to be counted")
    finally:
        for h, s in ((host, store), (ref_host, ref_store)):
            h.close()
            s.close()
        receiver.stop()
        reference.stop()


def test_a_fenced_stale_origin_cannot_write_or_resurrect_deletions(tmp_path):
    net = netchaos_lib.NetChaos(seed=2)
    receiver = _Receiver(tmp_path / "rx")
    store, host = _host(tmp_path, receiver, netchaos=net, retry_attempts=1,
                        retry_base_delay_secs=0.0, retry_max_delay_secs=0.0,
                        down_cooldown_secs=0.05)
    try:
        store.create_study(study_pb2.Study(name=STUDY))
        doomed = "owners/o/studies/doomed"
        store.create_study(study_pb2.Study(name=doomed))
        assert host.flush(10.0)
        net.partition("replica-1")
        receiver.standby.fence("replica-0", 2)
        newer = repl_service.GrpcReplicationLink({"replica-1": receiver.endpoint},
                                                 src_id="replica-0b")
        assert newer.deliver("replica-1", "replica-0", 2, [
            (5, wal_lib.CREATE_STUDY, study_pb2.Study(name=STUDY).SerializeToString())],
            True, 5) == (True, 5)
        net.heal("replica-1")
        store.create_trial(study_pb2.Trial(name=f"{STUDY}/trials/99"))
        _wait(lambda: host.fenced, "the zombie's streamer to be fenced")
        assert receiver.servicer.fenced_rejections >= 1
        assert receiver.standby.last_seq("replica-0") == 5
        local, torn = wal_lib.read_directory_with_seqs(str(tmp_path / "origin"))
        plan = replication.plan_recovery(
            "replica-0", local, torn, [receiver.standby.view_for("replica-0")],
            successors_fn=lambda study: ["replica-1"], holders=["replica-1"])
        planned = {item.study: item for item in plan.studies}
        assert doomed not in planned and planned[STUDY].source == "standby"
        assert all(b"trials/99" not in payload for _, payload in planned[STUDY].records)
    finally:
        host.close()
        store.close()
        receiver.stop()


def test_leases_expire_on_silence_not_on_delay():
    lease = subprocess_fleet.LeaseTable(timeout_s=0.5)
    for step in range(10):
        lease.renew("replica-0", 100.0 + step * 0.3)
        assert not lease.expired("replica-0", 100.0 + step * 0.3 + 0.29)
    assert lease.expired("replica-0", 100.0 + 9 * 0.3 + 0.51)
    short = subprocess_fleet.LeaseTable(timeout_s=0.2)
    short.renew("replica-0", 50.0)
    assert not short.expired("replica-0", 50.1) and short.expired("replica-0", 50.2)
    short.drop("replica-0")
    assert not short.expired("replica-0", 99.0)
    snap = subprocess_fleet.LeaseTable(timeout_s=5.0)
    snap.renew("replica-0")
    assert 0.0 < snap.snapshot()["replica-0"] <= 5.0


# -- subprocesses -----------------------------------------------------------------------


def _config() -> vz.StudyConfig:
    config = vz.StudyConfig(algorithm="RANDOM_SEARCH")
    config.search_space.root.add_float_param("x", 0.0, 1.0)
    config.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return config


def _reliability() -> ReliabilityConfig:
    # Rides out a lease expiry plus a failover over the wire.
    return ReliabilityConfig(retry_max_attempts=16, retry_base_delay_secs=0.1,
                             retry_max_delay_secs=0.5)


def _fleet(tmp_path, n=3, **kwargs):
    kwargs.setdefault("lease_timeout_s", 1.0)
    kwargs.setdefault("heartbeat_interval_s", 0.1)
    return subprocess_fleet.SubprocessReplicaManager(
        n, wal_root=str(tmp_path / "fleet"), device="cpu", child_env=_CHILD_ENV, **kwargs)


def _drive(client, start, stop):
    for i in range(start, stop):
        (trial,) = client.get_suggestions(1)
        client.complete_trial(trial.id, vz.Measurement(metrics={"obj": 0.01 * i}))


def _study_client(fleet, name):
    fleet.stub.CreateStudy(vizier_service_pb2.CreateStudyRequest(
        parent=name.rsplit("/studies/", 1)[0], study=pc.study_to_proto(_config(), name)))
    return vizier_client.VizierClient(fleet.stub, name, "w", reliability=_reliability())


def test_a_sigkilled_owner_fails_over_from_standby_and_revives(tmp_path):
    fleet = _fleet(tmp_path)
    try:
        study = "owners/sub/studies/kfr"
        client = _study_client(fleet, study)
        owner = fleet.owner_of(study)
        _drive(client, 0, 6)
        fleet.kill_replica(owner)
        _drive(client, 6, 12)
        assert fleet.owner_of(study) != owner and not fleet.is_alive(owner)
        stats = fleet.serving_stats()
        assert stats["failovers"] >= 1 and stats["recovery_sources"].get("standby", 0) >= 1
        assert len(client.list_trials()) == 12
        fleet.revive_replica(owner)
        assert fleet.is_alive(owner) and fleet.owner_of(study) == owner
        _drive(client, 12, 14)
        assert len(client.list_trials()) == 14
        assert stats["leases"] and set(stats["router"]) == set(fleet.replica_ids())
    finally:
        fleet.shutdown()


def test_the_shared_compute_tier_survives_its_servers_crash(tmp_path):
    fleet = _fleet(tmp_path, n=2, compute_tier=True)
    try:
        assert fleet.has_compute_tier() and fleet.compute_is_alive()
        client = _study_client(fleet, "owners/tier/studies/e2e")
        _drive(client, 0, 4)
        assert fleet.serving_stats()["compute_tier"]["alive"]
        fleet.kill_compute_server()
        _drive(client, 4, 8)  # each frontend's local Pythia serves meanwhile
        assert len(client.list_trials()) == 8
        _wait(fleet.compute_is_alive, "the lease loop to respawn the compute server", 30.0)
        fleet.revive_compute_server()  # idempotent on a running server
        assert fleet.serving_stats()["compute_tier"]["restarts"] >= 1
        _drive(client, 8, 9)
        assert len(client.list_trials()) == 9
    finally:
        fleet.shutdown()


def _pick_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ready_line(proc, what: str, timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline()
            if not line:
                break
            if line.strip():
                return line.strip()
    pytest.fail(f"{what} printed no READY line within {timeout} s (exit {proc.poll()})")


def test_sigterm_drains_flushes_compacts_and_dumps(tmp_path):
    ports = [_pick_port(), _pick_port()]
    peers = ",".join(f"replica-{i}=localhost:{ports[i]}" for i in range(2))
    dump_dir = str(tmp_path / "obs")
    wal_dirs = [str(tmp_path / f"replica-{i}") for i in range(2)]
    procs, endpoints = [], []
    logs = [tmp_path / f"replica-{i}.err" for i in range(2)]
    for i in range(2):
        with open(logs[i], "w") as err:
            # faulthandler: a SIGABRT after a timeout prints every thread's stack.
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler", "-m",
                 "vizier_tpu_torch.distributed.replica_main", "--replica-id", f"replica-{i}",
                 "--port", str(ports[i]), "--wal-dir", wal_dirs[i], "--peers", peers,
                 "--obs-dump-dir", dump_dir, "--device", "cpu"],
                stdout=subprocess.PIPE, stderr=err, text=True, cwd=_ROOT,
                env={**os.environ, **_CHILD_ENV}))
    try:
        for i, proc in enumerate(procs):
            line = _ready_line(proc, f"replica-{i}")
            assert line.startswith("READY "), line
            endpoints.append(line.split(" ", 1)[1])
        study = study_pb2.Study(name="owners/sub/studies/gs")
        study.study_spec.algorithm = "RANDOM_SEARCH"
        grpc_stubs.create_vizier_stub(endpoints[0]).CreateStudy(
            vizier_service_pb2.CreateStudyRequest(parent="owners/sub", study=study))
        grpc_stubs.create_replication_stub(endpoints[0]).FlushStream(
            pb.FlushStreamRequest(timeout_secs=10.0))
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for i, proc in enumerate(procs):
            try:
                assert proc.wait(timeout=60) == 0, logs[i].read_text()[-4000:]
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGABRT)
                proc.wait(timeout=10)
                pytest.fail(f"replica-{i} did not exit within 60 s of SIGTERM; its threads:\n"
                            f"{logs[i].read_text()[-6000:]}")
        assert os.path.exists(os.path.join(wal_dirs[0], wal_lib.SNAPSHOT_FILE))
        standby = os.path.join(wal_dirs[1], "standby", "replica-0", "standby.log")
        assert os.path.getsize(standby) > 0
        for i in range(2):
            with open(os.path.join(dump_dir, f"replica-{i}-metrics.json")) as f:
                json.load(f)
        revived = wal_lib.PersistentDataStore(wal_dirs[0])
        assert revived.load_study("owners/sub/studies/gs").study_spec.algorithm == "RANDOM_SEARCH"
        revived.close()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        for endpoint in endpoints:
            grpc_stubs.close_channel(endpoint)


@pytest.mark.parametrize("module,flags", [
    ("replica_main", ["--replica-id", "replica-0"]),
    ("pythia_server_main", ["--server-id", "compute-0"])])
def test_the_mains_refuse_cuda_without_a_gpu(tmp_path, module, flags):
    """``--device`` defaults to ``cuda``; with no GPU visible the process
    exits non-zero before it serves, and says to pass the CPU."""
    code = (f"import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['main'] + {flags!r}; "
            f"from vizier_tpu_torch.distributed import {module}; {module}.main()")
    run = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, **_CHILD_ENV})
    assert run.returncode != 0 and "READY" not in run.stdout
    assert "device='cpu'" in run.stderr


def test_the_subprocess_manager_refuses_cuda_before_spawning(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        subprocess_fleet.SubprocessReplicaManager(2, wal_root=str(tmp_path / "fleet"))
    assert not (tmp_path / "fleet").exists()


@pytest.mark.slow
def test_partition_lease_expiry_fencing_and_a_slow_replica(tmp_path):
    net = netchaos_lib.NetChaos(seed=5)
    fleet = _fleet(tmp_path, netchaos=net)
    try:
        study = "owners/sub/studies/pmx"
        client = _study_client(fleet, study)
        owner = fleet.owner_of(study)
        _drive(client, 0, 4)
        net.set_link("manager", owner, delay_prob=1.0, delay_secs=0.3)
        time.sleep(1.5)
        fleet.check_health()
        assert fleet.is_alive(owner) and fleet.serving_stats()["failovers"] == 0
        net.clear_link("manager", owner)
        fleet._control.call_once(owner, "FlushStream", pb.FlushStreamRequest(timeout_secs=5.0))
        fleet.partition_replica(owner)
        _drive(client, 4, 8)
        assert fleet.owner_of(study) != owner
        with fleet._lock:
            assert fleet._replicas[owner].running()
        fleet.heal_partition(owner)
        grpc_stubs.create_vizier_stub(fleet.endpoint_of(owner)).CreateTrial(
            vizier_service_pb2.CreateTrialRequest(
                parent=study, trial=study_pb2.Trial(name=f"{study}/trials/888")))

        def fenced():
            fleet.check_health()
            return fleet.serving_stats()["replication"]["fenced_rejections"] >= 1

        _wait(fenced, "a fenced rejection of the zombie's append")
        ids = sorted(t.id for t in client.list_trials())
        assert 888 not in ids and len(ids) == 8
    finally:
        fleet.shutdown()
