"""The in-process fleet on the CPU, held to the JAX package's.

- ``ReplicaManager`` (N ``VizierServicer`` replicas, snapshot+WAL datastores,
  standby-log replication, one shared Pythia on ``device="cpu"``): the same
  script of creates, trials, kill, failover and revive gives the same owners,
  restored counts, recovery sources, recorder events (kinds and attributes,
  in the JAX order) and per-replica state in both packages; then the JAX
  package's manager scenarios on the port: failover through the client's
  retries, durable handoff, health sweeps and loop, revive with copy-back,
  deletes not resurrected, complete listings, shared-nothing failover from
  standby logs, epoch-fenced revive, speculative re-arm, in-flight drain,
  late-write catch-up and the transition barrier, per-replica dumps.
- ``RoutedVizierStub`` over in-process servicers in both packages, and
  ``VizierClient`` unchanged over ``server_endpoints`` (the port's gRPC
  servers).
- ``RemotePythiaStub``: remote serves, local fallback, cooldown and re-probe,
  fail mode, semantic errors, the closed-channel race, trace re-stamping, the
  switches; the shared servicer's config-hash turnover.

RANDOM_SEARCH studies throughout: fleet behaviour is under test here, not GP
parity (held in the serving and designer tests).
"""

from __future__ import annotations

import dataclasses
import shutil
import threading
import time
import types

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.distributed import replica_manager as jreplica_manager
from vizier_tpu.distributed import router_stub as jrouter_stub
from vizier_tpu.distributed import routing as jrouting
from vizier_tpu.observability import flight_recorder as jrecorder
from vizier_tpu.reliability import config as jreliability
from vizier_tpu.service import proto_converters as jpc
from vizier_tpu.service import pythia_service as jpythia_service
from vizier_tpu.service import vizier_client as jvizier_client
from vizier_tpu.service import vizier_service as jvizier_service
from vizier_tpu.service.protos import study_pb2 as jstudy_pb2
from vizier_tpu.service.protos import vizier_service_pb2 as jvs_pb2
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.distributed import ReplicaManager
from vizier_tpu_torch.distributed import compute_tier
from vizier_tpu_torch.distributed import replica_manager
from vizier_tpu_torch.distributed import router_stub
from vizier_tpu_torch.distributed import routing
from vizier_tpu_torch.distributed import wal as wal_lib
from vizier_tpu_torch.observability import fleet as fleet_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.reliability import config as reliability
from vizier_tpu_torch.reliability import retry as retry_lib
from vizier_tpu_torch.service import clients
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import pythia_service
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import vizier_client
from vizier_tpu_torch.service import vizier_server
from vizier_tpu_torch.service import vizier_service
from vizier_tpu_torch.service.protos import pythia_service_pb2
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2
from vizier_tpu_torch.serving.designer_cache import DesignerStateCache

JAX = types.SimpleNamespace(
    name="jax", vz=jvz, pc=jpc, vs=jvs_pb2, study=jstudy_pb2, manager=jreplica_manager,
    router_stub=jrouter_stub, routing=jrouting, recorder=jrecorder,
    pythia_service=jpythia_service, vizier_service=jvizier_service,
    vizier_client=jvizier_client, reliability=jreliability, kw={})
PORT = types.SimpleNamespace(
    name="port", vz=vz, pc=pc, vs=vizier_service_pb2, study=study_pb2, manager=replica_manager,
    router_stub=router_stub, routing=routing, recorder=recorder_lib,
    pythia_service=pythia_service, vizier_service=vizier_service,
    vizier_client=vizier_client, reliability=reliability, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
LIST = vizier_service_pb2.ListStudiesRequest(parent="owners/o")


def _config(pkg=PORT):
    config = pkg.vz.StudyConfig(algorithm="RANDOM_SEARCH")
    config.search_space.root.add_float_param("x", 0.0, 1.0)
    config.metric_information.append(
        pkg.vz.MetricInformation(name="obj", goal=pkg.vz.ObjectiveMetricGoal.MAXIMIZE))
    return config


def _create(stub, study_id: str, pkg=PORT) -> str:
    name = f"owners/o/studies/{study_id}"
    stub.CreateStudy(pkg.vs.CreateStudyRequest(
        parent="owners/o", study=pkg.pc.study_to_proto(_config(pkg), name)))
    return name


def _fast(pkg=PORT):
    # The failover tests cross a real dead-replica transition; the default
    # backoff would set their wall time.
    return dataclasses.replace(pkg.reliability.ReliabilityConfig(),
                               retry_base_delay_secs=0.001, retry_max_delay_secs=0.01)


def _client(stub, name, pkg=PORT, client_id="w0"):
    return pkg.vizier_client.VizierClient(stub, name, client_id, reliability=_fast(pkg))


def _run(client, n: int, start: int = 0, pkg=PORT) -> None:
    for i in range(start, start + n):
        (trial,) = client.get_suggestions(1)
        client.complete_trial(trial.id, pkg.vz.Measurement(metrics={"obj": 0.01 * i}))


@pytest.fixture
def recorder():
    rec = recorder_lib.FlightRecorder()
    previous = recorder_lib.set_recorder(rec)
    yield rec
    recorder_lib.set_recorder(previous)


@pytest.fixture
def manager(tmp_path):
    mgr = ReplicaManager(3, wal_root=str(tmp_path / "wal"), device="cpu")
    yield mgr
    mgr.shutdown()


# -- held to the JAX package ----------------------------------------------------------


def _timeline(pkg, tmp_path):
    """One script on a 3-replica WAL tier: returns what must agree."""
    rec = pkg.recorder.FlightRecorder()
    previous = pkg.recorder.set_recorder(rec)
    mgr = pkg.manager.ReplicaManager(3, wal_root=str(tmp_path / pkg.name), **pkg.kw)
    try:
        names = [_create(mgr.stub, f"t{i}", pkg) for i in range(8)]
        owners = {n: mgr.router.replica_for(n) for n in names}
        for name in names[:4]:
            _run(_client(mgr.stub, name, pkg), 2, pkg=pkg)
        victim = owners[names[0]]
        for rid in mgr.replica_ids():
            assert mgr.flush_replication(rid)
        mgr.kill_replica(victim)
        snapshot = mgr.check_health()
        moved = {n: mgr.router.replica_for(n) for n in names}
        stats = mgr.serving_stats()
        for name in names[4:6]:
            _run(_client(mgr.stub, name, pkg, client_id="mid"), 1, pkg=pkg)
        mgr.revive_replica(victim)
        back = {n: mgr.router.replica_for(n) for n in names}
        state = {}
        for rid in mgr.replica_ids():
            store = mgr.replica(rid).datastore
            state[rid] = {s.name: [(t.id, t.state) for t in store.list_trials(s.name)]
                          for s in store.list_studies("owners/o")}
        events = [(e["kind"], {k: v for k, v in e["attributes"].items()})
                  for e in rec.ring(pkg.recorder.FLEET) if e["kind"] != "replication_resync"]
        return dict(owners=owners, snapshot=snapshot, moved=moved, back=back, state=state,
                    failovers=stats["failovers"], restored=stats["restored_studies"],
                    sources=stats["recovery_sources"], events=events,
                    epochs={rid: mgr._replication.epoch_of(rid) for rid in mgr.replica_ids()})
    finally:
        mgr.shutdown()
        pkg.recorder.set_recorder(previous)


def test_kill_failover_revive_matches_the_jax_package(tmp_path):
    ours, theirs = _timeline(PORT, tmp_path), _timeline(JAX, tmp_path)
    assert ours == theirs
    assert [kind for kind, _ in ours["events"]] == [
        "replica_killed", "replica_failover", "replica_revive"]
    victim = ours["events"][0][1]["replica"]
    assert ours["events"][1][1]["restored_studies"] == sum(
        o == victim for o in ours["owners"].values())
    assert ours["back"] == ours["owners"] and ours["epochs"][victim] == 2


@pytest.mark.parametrize("replication", ["1", "0"])
def test_failover_sources_match_the_jax_package(tmp_path, monkeypatch, replication):
    out = []
    for pkg in (JAX, PORT):
        monkeypatch.setenv("VIZIER_DISTRIBUTED_REPLICATION", replication)
        monkeypatch.setenv("VIZIER_TORCH_DISTRIBUTED_REPLICATION", replication)
        mgr = pkg.manager.ReplicaManager(3, wal_root=str(tmp_path / pkg.name), **pkg.kw)
        try:
            names = [_create(mgr.stub, f"src{i}", pkg) for i in range(6)]
            dead = sorted({mgr.router.replica_for(n) for n in names})[:2]
            for rid in dead:
                mgr.flush_replication(rid)
                mgr.kill_replica(rid)
            restored = mgr.fail_over(dead[0])
            stats = mgr.serving_stats()
            out.append((mgr.replication_active, restored, stats["failovers"],
                        stats["recovery_sources"], "replication" in stats,
                        {n: mgr.router.replica_for(n) for n in names},
                        sorted(s.name for s in mgr.stub.ListStudies(pkg.vs.ListStudiesRequest(
                            parent="owners/o")).studies)))
        finally:
            mgr.shutdown()
    assert out[1] == out[0]
    assert out[1][0] == (replication == "1") and out[1][2] == 2


def test_recorder_events_keep_the_jax_order_and_fields(recorder, manager):
    study = _create(manager.stub, "recorder-events")
    owner = manager.router.replica_for(study)
    manager.stub.SuggestTrials(vizier_service_pb2.SuggestTrialsRequest(
        parent=study, suggestion_count=1, client_id="w"))
    manager.kill_replica(owner)
    manager.check_health()
    manager.revive_replica(owner)
    events = [e for e in recorder.ring(recorder_lib.FLEET) if e["kind"] != "replication_resync"]
    assert [e["kind"] for e in events] == ["replica_killed", "replica_failover", "replica_revive"]
    killed, failover, revive = events
    assert killed["attributes"] == {"replica": owner}
    assert set(failover["attributes"]) == {"replica", "successors", "restored_studies",
                                           "recovery_sources"}
    assert failover["attributes"]["replica"] == owner
    assert failover["attributes"]["restored_studies"] == 1
    successors = failover["attributes"]["successors"]
    assert successors and owner not in successors
    assert failover["time"] >= killed["time"]
    assert revive["attributes"] == {"replica": owner, "was_failed_over": True,
                                    "epoch_fenced": True}
    # The service's per-study events carry the replica that served them.
    (suggest,) = [e for e in recorder.ring(study) if e["kind"] == "suggest"]
    assert suggest["attributes"]["replica"] == owner


def test_a_ram_only_failover_records_no_successors(recorder):
    mgr = ReplicaManager(2, wal_root="", device="cpu")
    try:
        owner = mgr.replica_ids()[0]
        mgr.kill_replica(owner)
        mgr.check_health()
        (event,) = recorder.ring(recorder_lib.FLEET)[1:2]
        assert event["kind"] == "replica_failover"
        assert event["attributes"]["successors"] == []
        assert event["attributes"]["restored_studies"] == 0
    finally:
        mgr.shutdown()


# -- the fleet ----------------------------------------------------------------------


def test_the_fleet_shares_one_pythia_on_the_asked_device(manager):
    assert manager.replica_ids() == ["replica-0", "replica-1", "replica-2"]
    assert manager.pythia.device == torch.device("cpu")
    for rid in manager.replica_ids():
        replica = manager.replica(rid)
        assert replica.servicer._pythia is manager.pythia
        assert replica.servicer.replica_id == rid
    names = [_create(manager.stub, f"s{i}") for i in range(8)]
    for name in names:
        owner = manager.replica(manager.router.replica_for(name))
        assert owner.datastore.load_study(name).name == name
    assert len({manager.router.replica_for(n) for n in names}) > 1


def test_the_manager_refuses_cuda_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaManager(2, wal_root=str(tmp_path))


def test_serving_stats_and_metrics(manager):
    name = _create(manager.stub, "stats")
    _run(_client(manager.stub, name), 2)
    stats = manager.serving_stats()
    assert stats["failovers"] == 0 and stats["restored_studies"] == 0
    assert set(stats["router"]) == set(manager.replica_ids())
    assert all(state == "up" for state in stats["router"].values())
    assert stats["replicas"][manager.router.replica_for(name)]["requests"] > 0
    assert stats["replication"]["factor"] == 2
    assert "vizier_replica_failovers" in manager.prometheus_text()


def test_a_killed_owner_fails_over_through_the_clients_retries(manager):
    name = _create(manager.stub, "failover")
    client = _client(manager.stub, name)
    _run(client, 5)
    before = manager.router.replica_for(name)
    manager.kill_replica(before)
    _run(client, 5, start=5)
    after = manager.router.replica_for(name)
    assert after != before and not manager.router.is_up(before)
    successor = manager.replica(after)
    assert successor.datastore.max_trial_id(name) == 10
    assert len(client.list_trials()) == 10
    stats = manager.serving_stats()
    assert stats["failovers"] == 1 and stats["restored_studies"] >= 1
    # The handoff re-logged every record: a cold restart of the successor's
    # directory serves the study.
    restarted = wal_lib.PersistentDataStore(successor.wal_dir)
    try:
        assert restarted.max_trial_id(name) == 10
    finally:
        restarted.close()


def test_failing_over_is_idempotent_and_needs_a_dead_replica(manager):
    _create(manager.stub, "guard")
    assert manager.fail_over("replica-0") == 0
    manager._on_endpoint_failure("replica-1", ConnectionError("blip"))
    assert manager.router.is_up("replica-1")
    assert manager.serving_stats()["failovers"] == 0
    manager.kill_replica("replica-0")
    manager.fail_over("replica-0")
    assert manager.fail_over("replica-0") == 0
    assert manager.serving_stats()["failovers"] == 1


def test_a_ram_only_tier_fails_over_without_state_and_lists_loudly():
    mgr = ReplicaManager(3, wal_root=None, device="cpu")
    try:
        names = [_create(mgr.stub, f"ram{i}") for i in range(6)]
        victim = mgr.router.replica_for(names[0])
        mgr.kill_replica(victim)
        assert mgr.fail_over(victim) == 0
        assert not mgr.router.is_up(victim)
        with pytest.raises(ConnectionError, match="partial"):
            mgr.stub.ListStudies(LIST)
    finally:
        mgr.shutdown()


def test_health_sweeps_and_the_health_loop(manager):
    name = _create(manager.stub, "sweep")
    owner = manager.router.replica_for(name)
    manager.kill_replica(owner)
    assert manager.check_health()[owner] == "down"
    manager.check_health()
    assert manager.serving_stats()["failovers"] == 1
    manager.revive_replica(owner)
    manager.start_health_loop(interval_secs=0.01)
    try:
        manager.kill_replica(owner)
        deadline = time.monotonic() + 5.0
        while manager.router.is_up(owner):
            assert time.monotonic() < deadline, "the health loop did not sweep within 5 s"
            time.sleep(0.01)
    finally:
        manager.stop_health_loop()
    assert manager.serving_stats()["failovers"] == 2


def test_revive_copies_studies_back_and_warm_restarts(manager):
    name = _create(manager.stub, "revive")
    client = _client(manager.stub, name)
    _run(client, 4)
    owner = manager.router.replica_for(name)
    manager.kill_replica(owner)
    _run(client, 2, start=4)
    interim = manager.router.replica_for(name)
    assert interim != owner
    manager.revive_replica(owner)
    assert manager.router.replica_for(name) == owner
    revived = manager.replica(owner)
    assert revived.datastore.max_trial_id(name) == 6
    with pytest.raises(KeyError):
        manager.replica(interim).datastore.load_study(name)
    _run(client, 1, start=6)
    assert revived.datastore.max_trial_id(name) == 7
    warm = _create(manager.stub, "warm")
    _run(_client(manager.stub, warm), 3)
    other = manager.router.replica_for(warm)
    manager.kill_replica(other)
    manager.revive_replica(other)  # before anything noticed: WAL restart only
    assert manager.replica(other).datastore.max_trial_id(warm) == 3
    assert manager.serving_stats()["failovers"] == 1


def test_a_study_deleted_during_downtime_is_not_resurrected(manager):
    doomed, kept = _create(manager.stub, "doomed"), _create(manager.stub, "kept")
    _run(_client(manager.stub, doomed), 2)
    owner = manager.router.replica_for(doomed)
    manager.kill_replica(owner)
    manager.check_health()
    manager.stub.DeleteStudy(vizier_service_pb2.DeleteStudyRequest(name=doomed))
    manager.revive_replica(owner)
    revived = manager.replica(owner)
    with pytest.raises(KeyError):
        revived.datastore.load_study(doomed)
    restarted = wal_lib.PersistentDataStore(revived.wal_dir)
    try:
        with pytest.raises(KeyError):
            restarted.load_study(doomed)
    finally:
        restarted.close()
    owner_of_kept = manager.replica(manager.router.replica_for(kept))
    assert owner_of_kept.datastore.load_study(kept).name == kept


def test_listings_stay_complete_across_failover_and_revive(manager):
    names = {_create(manager.stub, f"ls{i}") for i in range(6)}
    victim = manager.router.replica_for(next(iter(names)))
    manager.kill_replica(victim)
    with pytest.raises(ConnectionError):
        manager.stub.ListStudies(LIST)
    assert {s.name for s in manager.stub.ListStudies(LIST).studies} == names
    manager.revive_replica(victim)
    assert {s.name for s in manager.stub.ListStudies(LIST).studies} == names


# -- shared-nothing replication -----------------------------------------------------


def test_failover_with_the_owners_disk_gone(manager, tmp_path):
    study = _create(manager.stub, "no-shared-fs")
    _run(_client(manager.stub, study), 1)
    owner = manager.router.replica_for(study)
    assert manager.flush_replication(owner)
    shutil.rmtree(tmp_path / "wal" / owner)
    manager.kill_replica(owner)
    assert manager.fail_over(owner) == 1
    assert manager.serving_stats()["recovery_sources"].get("standby", 0) >= 1
    trials = manager.stub.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=study)).trials
    assert [t.state for t in trials] == [study_pb2.Trial.SUCCEEDED]


def test_standby_replay_equals_local_replay_byte_for_byte(manager):
    studies = [_create(manager.stub, f"eq-{i}") for i in range(6)]
    for name in studies[:3]:
        _run(_client(manager.stub, name), 1)
    origin = manager.router.replica_for(studies[0])
    assert manager.flush_replication(origin)
    local = ram_datastore.NestedDictRAMDataStore()
    for opcode, payload in wal_lib.read_directory(manager.replica(origin).wal_dir)[0]:
        wal_lib.apply_record(local, opcode, payload)
    standby = ram_datastore.NestedDictRAMDataStore()
    for item in manager.recovery_plan(origin, None).studies:
        assert item.source == "standby"
        for opcode, payload in item.records:
            wal_lib.apply_record(standby, opcode, payload)
    assert wal_lib.export_records(standby) == wal_lib.export_records(local)


def test_a_corrupt_local_wal_recovers_from_standby(manager, tmp_path):
    study = _create(manager.stub, "corrupt-recovery")
    _run(_client(manager.stub, study), 1)
    owner = manager.router.replica_for(study)
    assert manager.flush_replication(owner)
    log = tmp_path / "wal" / owner / wal_lib.LOG_FILE
    data = bytearray(log.read_bytes())
    data[len(data) // 2:len(data) // 2 + 16] = b"\xff" * 16
    log.write_bytes(bytes(data))
    manager.kill_replica(owner)
    manager.fail_over(owner)
    (trial,) = manager.stub.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=study)).trials
    assert trial.state == study_pb2.Trial.SUCCEEDED
    assert manager.serving_stats()["recovery_sources"].get("standby", 0) >= 1


def test_revive_is_epoch_fenced_and_safe_under_traffic(manager):
    study = _create(manager.stub, "fence")
    _run(_client(manager.stub, study), 1)
    owner = manager.router.replica_for(study)
    plane = manager._replication
    assert plane.epoch_of(owner) == 1
    manager.kill_replica(owner)
    manager.fail_over(owner)
    _run(_client(manager.stub, study, client_id="mid-failover"), 1)
    manager.revive_replica(owner)
    assert plane.epoch_of(owner) == 2 and manager.router.replica_for(study) == owner
    successor = next(rid for rid in manager.replica_ids() if rid != owner)
    stale = [(99, wal_lib.CREATE_STUDY, study_pb2.Study(name="owners/o/studies/x")
              .SerializeToString())]
    assert manager.replica(successor).standby.append_batch(owner, 1, stale) == (False, 2)
    trials = manager.stub.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=study)).trials
    assert sum(t.state == study_pb2.Trial.SUCCEEDED for t in trials) == 2


def test_a_revived_successor_is_rebaselined(manager):
    study = _create(manager.stub, "resync")
    owner = manager.router.replica_for(study)
    successor = manager._replication.successors_for(study, owner)[0]
    manager.kill_replica(successor)
    manager.fail_over(successor)
    _run(_client(manager.stub, study), 1)
    manager.revive_replica(successor)
    target = manager.replica(owner).datastore.seq
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        view = manager.replica(successor).standby.view_for(owner)
        if view is not None and max([view.baseline_seq] + [r[0] for r in view.records]) >= target:
            break
        time.sleep(0.02)
    view = manager.replica(successor).standby.view_for(owner)
    assert view is not None, "no standby view after 5 s"
    assert max([view.baseline_seq] + [r[0] for r in view.records]) >= target - 1


@pytest.mark.parametrize("completed", [True, False])
def test_failover_rearms_speculation_only_with_completed_trials(tmp_path, monkeypatch,
                                                                completed):
    monkeypatch.setenv("VIZIER_TORCH_SPECULATIVE", "1")
    mgr = ReplicaManager(3, wal_root=str(tmp_path / "wal"), device="cpu")
    try:
        engine = mgr.pythia.serving_runtime.speculative_engine
        assert engine is not None and engine.bound
        study = _create(mgr.stub, "rearm")
        if completed:
            _run(_client(mgr.stub, study), 1)
        owner = mgr.router.replica_for(study)
        mgr.kill_replica(owner)
        mgr.fail_over(owner)
        rearms = mgr.serving_stats().get("speculative_rearms", 0)
        assert rearms >= 1 if completed else rearms == 0
    finally:
        mgr.shutdown()


# -- in-flight RPCs against failover --------------------------------------------------


def _create_trial_request(name):
    return vizier_service_pb2.CreateTrialRequest(
        parent=name, trial=pc.trial_to_proto(vz.Trial(parameters={"x": 0.5})))


def _list(manager, name):
    return manager.stub.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=name)).trials


def test_fail_over_drains_an_inflight_write(manager):
    name = _create(manager.stub, "drain")
    owner = manager.router.replica_for(name)
    replica = manager.replica(owner)
    entered, release = threading.Event(), threading.Event()
    original = replica.servicer.CreateTrial

    def slow_create(request):
        entered.set()
        assert release.wait(10.0)
        return original(request)

    replica.servicer.CreateTrial = slow_create
    rpc = threading.Thread(target=lambda: manager.stub.CreateTrial(_create_trial_request(name)))
    rpc.start()
    assert entered.wait(5.0), "the write did not start within 5 s"
    manager.kill_replica(owner)
    done = threading.Event()
    failover = threading.Thread(target=lambda: (manager.fail_over(owner), done.set()))
    failover.start()
    time.sleep(0.25)
    assert not done.is_set()  # held behind the in-flight write
    release.set()
    rpc.join(10.0)
    failover.join(10.0)
    assert done.is_set() and not rpc.is_alive(), "the drain did not end within 10 s"
    assert manager.router.replica_for(name) != owner and len(_list(manager, name)) == 1


def test_a_late_write_catches_up_after_a_self_triggered_failover(manager):
    name = _create(manager.stub, "catchup")
    owner = manager.router.replica_for(name)
    replica = manager.replica(owner)
    entered, release = threading.Event(), threading.Event()
    original = replica.servicer.CreateTrial

    def write_after_own_failover(request):
        entered.set()
        assert release.wait(10.0)
        manager.fail_over(owner)
        return original(request)

    replica.servicer.CreateTrial = write_after_own_failover
    rpc = threading.Thread(target=lambda: manager.stub.CreateTrial(_create_trial_request(name)))
    rpc.start()
    assert entered.wait(5.0), "the write did not start within 5 s"
    manager.kill_replica(owner)
    release.set()
    rpc.join(10.0)
    assert not rpc.is_alive(), "the write did not return within 10 s"
    assert len(_list(manager, name)) == 1


def test_the_barrier_parks_fresh_rpcs_and_exempts_nested_ones(manager):
    name = _create(manager.stub, "barrier")
    manager._begin_transition()
    started, finished = threading.Event(), threading.Event()

    def fresh():
        started.set()
        manager.stub.GetStudy(vizier_service_pb2.GetStudyRequest(name=name))
        finished.set()

    thread = threading.Thread(target=fresh)
    thread.start()
    assert started.wait(5.0)
    time.sleep(0.2)
    assert not finished.is_set()
    manager._end_transition()
    thread.join(5.0)
    assert finished.is_set(), "the parked RPC did not finish within 5 s"
    replica = manager.replica(manager.router.replica_for(name))
    original, nested = replica.servicer.GetStudy, threading.Event()

    def nested_read(request):
        manager._begin_transition()
        try:
            manager.stub.ListTrials(vizier_service_pb2.ListTrialsRequest(parent=name))
            nested.set()
        finally:
            manager._end_transition()
        return original(request)

    replica.servicer.GetStudy = nested_read
    manager.stub.GetStudy(vizier_service_pb2.GetStudyRequest(name=name))
    assert nested.is_set()


def test_dump_observability_splits_spans_per_replica(recorder, manager, tmp_path):
    tracer = tracing_lib.Tracer()
    previous = tracing_lib.set_tracer(tracer)
    try:
        for i in range(2):
            study = _create(manager.stub, f"dump-{i}")
            with tracer.span("client.suggest", study=study):
                manager.stub.SuggestTrials(vizier_service_pb2.SuggestTrialsRequest(
                    parent=study, suggestion_count=1, client_id="w"))
        written = manager.dump_observability(str(tmp_path / "dump"))
    finally:
        tracing_lib.set_tracer(previous)
    loaded = fleet_lib.load_fleet_dir(str(tmp_path / "dump"))
    assert "client" in loaded["spans"] and "fleet" in loaded["metrics"]
    sources = [s for s in loaded["spans"] if s.startswith("replica-")]
    assert sources and written["spans"]
    for source in sources:
        assert all(span["attributes"]["replica"] == source for span in loaded["spans"][source])
    assert fleet_lib.cross_replica_traces(fleet_lib.merge_spans(loaded["spans"]))


# -- RoutedVizierStub and the routed client ------------------------------------------------


@pytest.fixture
def tiers():
    made = []

    def make(pkg, n=3, **kwargs):
        servicers = {}
        for i in range(n):
            servicer = pkg.vizier_service.VizierServicer()
            pythia = pkg.pythia_service.PythiaServicer(servicer, **pkg.kw)
            servicer.set_pythia(pythia)
            made.append(pythia)
            servicers[f"replica-{i}"] = servicer
        return servicers, pkg.router_stub.RoutedVizierStub(servicers, **kwargs)

    yield make
    for pythia in made:
        pythia.shutdown()


@PKGS
def test_the_routed_stub_is_a_drop_in_with_study_affinity(pkg, tiers):
    servicers, stub = tiers(pkg)
    name = _create(stub, "dropin", pkg)
    client = pkg.vizier_client.VizierClient(stub, name, "w0")
    _run(client, 5, pkg=pkg)
    trials = client.list_trials()
    assert len(trials) == 5 and all(t.status == pkg.vz.TrialStatus.COMPLETED for t in trials)
    assert len(client.list_optimal_trials()) == 1
    names = {_create(stub, f"aff{i}", pkg) for i in range(7)} | {name}
    for study in names:
        owner = stub.router.replica_for(study)
        assert servicers[owner].datastore.load_study(study).name == study
        for rid, servicer in servicers.items():
            if rid != owner:
                with pytest.raises(KeyError):
                    servicer.datastore.load_study(study)
    listed = stub.ListStudies(pkg.vs.ListStudiesRequest(parent="owners/o"))
    assert {s.name for s in listed.studies} == names
    op = stub.SuggestTrials(pkg.vs.SuggestTrialsRequest(parent=name, suggestion_count=1,
                                                        client_id="w"))
    polled = stub.GetOperation(pkg.vs.GetOperationRequest(name=op.name))
    assert polled.name == op.name and polled.done
    stats = stub.stats()
    assert stats["replicas"][stub.router.replica_for(name)]["requests"] >= 1
    with pytest.raises(ValueError):
        stub.GetStudy(pkg.vs.GetStudyRequest(name="garbage"))
    assert all(state == "up" for state in stub.router.snapshot().values())


def test_routed_stubs_place_studies_as_the_jax_package_does(tiers):
    placed = []
    for pkg in (JAX, PORT):
        servicers, stub = tiers(pkg, n=4)
        names = [_create(stub, f"same{i}", pkg) for i in range(16)]
        placed.append({n: next(rid for rid, s in servicers.items()
                               if any(x.name == n for x in s.datastore.list_studies("owners/o")))
                       for n in names})
    assert placed[1] == placed[0]


@PKGS
def test_a_partial_listing_is_refused_until_failed_over(pkg, tiers):
    servicers, stub = tiers(pkg)
    names = {_create(stub, f"part{i}", pkg) for i in range(8)}
    stub.router.mark_down("replica-1")
    with pytest.raises(ConnectionError, match="partial"):
        stub.ListStudies(pkg.vs.ListStudiesRequest(parent="owners/o"))
    stub.note_failed_over("replica-1")
    on_one = {s.name for s in servicers["replica-1"].datastore.list_studies("owners/o")}
    assert {s.name for s in stub.ListStudies(
        pkg.vs.ListStudiesRequest(parent="owners/o")).studies} == names - on_one
    stub.set_endpoint("replica-1", servicers["replica-1"])
    stub.router.mark_up("replica-1")
    assert {s.name for s in stub.ListStudies(
        pkg.vs.ListStudiesRequest(parent="owners/o")).studies} == names


@PKGS
def test_routing_off_uses_the_first_replica(pkg, tiers):
    servicers, stub = tiers(pkg, routing_enabled=False)
    for i in range(5):
        _create(stub, f"pin{i}", pkg)
    assert len(servicers["replica-0"].datastore.list_studies("owners/o")) == 5
    assert not servicers["replica-1"].datastore.list_studies("owners/o")


class _Dead:
    def __getattr__(self, name):
        def call(request):
            raise ConnectionError("connection refused")

        return call


@PKGS
def test_transport_failures_mark_down_or_reach_the_hook(pkg, tiers):
    live = next(iter(tiers(pkg, n=1)[0].values()))
    router = pkg.routing.StudyRouter(["replica-0", "replica-1"])
    name = next(f"owners/o/studies/f{i}" for i in range(50)
                if router.replica_for(f"owners/o/studies/f{i}") == "replica-1")
    stub = pkg.router_stub.RoutedVizierStub({"replica-0": live, "replica-1": _Dead()},
                                            router=router, failure_threshold=2)
    request = pkg.vs.CreateStudyRequest(parent="owners/o",
                                        study=pkg.pc.study_to_proto(_config(pkg), name))
    for _ in range(2):
        with pytest.raises(ConnectionError):
            stub.CreateStudy(request)
    assert not stub.router.is_up("replica-1")
    stub.CreateStudy(request)
    assert live.datastore.load_study(name).name == name
    seen = []
    hooked = pkg.router_stub.RoutedVizierStub(
        {"replica-0": _Dead()}, on_failure=lambda rid, e: seen.append((rid, type(e).__name__)))
    with pytest.raises(ConnectionError):
        _create(hooked, "hooked", pkg)
    assert seen == [("replica-0", "ConnectionError")] and hooked.router.is_up("replica-0")


@PKGS
def test_a_success_resets_the_failure_count(pkg, tiers):
    inner = next(iter(tiers(pkg, n=1)[0].values()))
    state = {"fail": True}

    class Flaky:
        def __getattr__(self, name):
            method = getattr(inner, name)

            def call(request):
                if state["fail"]:
                    state["fail"] = False
                    raise ConnectionError("blip")
                return method(request)

            return call

    stub = pkg.router_stub.RoutedVizierStub({"replica-0": Flaky()}, failure_threshold=2)
    with pytest.raises(ConnectionError):
        _create(stub, "flaky", pkg)
    _create(stub, "flaky", pkg)
    state["fail"] = True
    with pytest.raises(ConnectionError):
        _create(stub, "flaky2", pkg)
    assert stub.router.is_up("replica-0")


def test_vizier_client_runs_unchanged_over_server_endpoints(monkeypatch):
    servers = [vizier_server.DefaultVizierServer(device="cpu") for _ in range(3)]
    try:
        endpoints = [s.endpoint for s in servers]
        monkeypatch.setattr(vizier_client, "_routed_stubs", {})
        monkeypatch.setattr(vizier_client.environment_variables, "server_endpoints", endpoints)
        router = routing.StudyRouter([f"replica-{i}" for i in range(3)])
        for i in range(6):
            study = clients.Study.from_study_config(_config(), owner="o", study_id=f"ep{i}")
            for trial in study.suggest(count=2):
                trial.complete(vz.Measurement(metrics={"obj": 0.5}))
            name = f"owners/o/studies/ep{i}"
            owner = servers[int(router.replica_for(name).split("-")[1])]
            assert owner.servicer.datastore.max_trial_id(name) == 2
            assert sum(any(s.name == name for s in srv.servicer.datastore.list_studies("owners/o"))
                       for srv in servers) == 1
            assert len(list(study.trials())) == 2
        stub = vizier_client.create_service_stub()
        assert isinstance(stub, router_stub.RoutedVizierStub)
        assert vizier_client.create_service_stub(endpoints) is stub
    finally:
        for server in servers:
            server.stop(0)


# -- the compute tier's frontend stub ---------------------------------------------------


STUDY = "owners/tier/studies/s"


def _suggest_request(config, name=STUDY):
    request = pythia_service_pb2.PythiaSuggestRequest(count=1, study_name=name)
    request.study_descriptor.config.CopyFrom(pc.study_to_proto(config, name).study_spec)
    request.study_descriptor.guid = name
    return request


class _Remote:
    def __init__(self, failures=0, error=ConnectionError, name="remote"):
        self.failures, self.error, self.name, self.calls = failures, error, name, 0

    def Suggest(self, request):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.error("tier down")
        response = pythia_service_pb2.PythiaSuggestResponse()
        p = response.suggestions.add().parameters.add()
        p.name, p.value.double_value = self.name, 1.0
        return response

    EarlyStop = Ping = Suggest


def _tier_stub(remote, local=None, clock=None, fallback="local", interval=5.0):
    built = {"count": 0}

    def factory():
        built["count"] += 1
        return remote

    stub = compute_tier.RemotePythiaStub(
        "localhost:1", local=local, replica_id="r0",
        config=compute_tier.ComputeTierConfig(enabled=True, endpoint="localhost:1",
                                              fallback=fallback, health_interval_s=interval),
        retry_policy=retry_lib.RetryPolicy(max_attempts=1), stub_factory=factory,
        time_fn=(clock or time.monotonic))
    return stub, built


def _served_by(response):
    return response.suggestions[0].parameters[0].name


def test_the_remote_tier_serves_and_counts():
    stub, built = _tier_stub(_Remote(), local=_Remote(name="local"))
    assert _served_by(stub.Suggest(_suggest_request(_config()))) == "remote"
    stats = stub.stats()
    assert built["count"] == 1 and stats["remote_calls"] == 1
    assert stats["fallback_serves"] == 0 and not stats["cooling_down"]
    assert stub.serving_stats()["compute_tier"]["endpoint"] == "localhost:1"


def test_an_unreachable_tier_falls_back_cools_down_and_reprobes():
    clock, local, remote = [100.0], _Remote(name="local"), _Remote(failures=1)
    stub, built = _tier_stub(remote, local=local, clock=lambda: clock[0])
    assert _served_by(stub.Suggest(_suggest_request(_config()))) == "local"
    stats = stub.stats()
    assert stats["remote_failures"] == 1 and stats["fallback_serves"] == 1
    assert stats["cooling_down"]
    stub.Suggest(_suggest_request(_config()))
    assert remote.calls == 1 and stub.stats()["fallback_serves"] == 2
    clock[0] += 5.1
    assert _served_by(stub.Suggest(_suggest_request(_config()))) == "remote"
    assert built["count"] == 2 and stub.stats()["remote_calls"] == 1


def test_fail_mode_and_semantic_errors_skip_the_fallback():
    stub, _ = _tier_stub(_Remote(failures=10), fallback="fail")
    with pytest.raises(ConnectionError):
        stub.Suggest(_suggest_request(_config()))
    local = _Remote(name="local")
    semantic, _ = _tier_stub(_Remote(failures=10, error=ValueError), local=local)
    with pytest.raises(ValueError):
        semantic.Suggest(_suggest_request(_config()))
    assert local.calls == 0 and not semantic.stats()["cooling_down"]
    closed, _ = _tier_stub(_Remote(failures=10, error=lambda msg: ValueError(
        "Cannot invoke RPC on closed channel!")), local=local)
    assert _served_by(closed.Suggest(_suggest_request(_config()))) == "local"
    assert closed.stats()["cooling_down"]
    with pytest.raises(ValueError):
        compute_tier.ComputeTierConfig(fallback="retry")


def test_the_trace_context_is_restamped_across_the_hop():
    seen = {}

    class Capture(_Remote):
        def Suggest(self, request):
            seen["trace_context"] = request.trace_context
            return super().Suggest(request)

    stub, _ = _tier_stub(Capture())
    stub.Suggest(_suggest_request(_config()))
    assert seen["trace_context"]


def test_the_tier_switches_read_the_ports_prefix(monkeypatch):
    for name in ("COMPUTE_TIER", "COMPUTE_TIER_ENDPOINT", "COMPUTE_TIER_FALLBACK"):
        monkeypatch.delenv("VIZIER_TORCH_" + name, raising=False)
    monkeypatch.setenv("VIZIER_COMPUTE_TIER", "1")
    monkeypatch.setenv("VIZIER_COMPUTE_TIER_ENDPOINT", "localhost:9")
    local = _Remote(name="local")
    assert compute_tier.ComputeTierConfig.from_env() == compute_tier.ComputeTierConfig()
    assert compute_tier.maybe_wrap_pythia(local) is local
    wrapped = compute_tier.maybe_wrap_pythia(local, replica_id="r1", endpoint="localhost:2")
    assert isinstance(wrapped, compute_tier.RemotePythiaStub)
    assert wrapped.stats()["endpoint"] == "localhost:2"
    monkeypatch.setenv("VIZIER_TORCH_COMPUTE_TIER", "1")
    monkeypatch.setenv("VIZIER_TORCH_COMPUTE_TIER_ENDPOINT", "localhost:3")
    monkeypatch.setenv("VIZIER_TORCH_COMPUTE_TIER_FALLBACK", "fail")
    env = compute_tier.ComputeTierConfig.from_env()
    assert (env.enabled, env.endpoint, env.fallback) == (True, "localhost:3", "fail")
    assert compute_tier.maybe_wrap_pythia(local).stats()["endpoint"] == "localhost:3"


class _BakedPolicy:
    """Bakes its construction-time search space into every suggestion."""

    should_be_cached = True

    def __init__(self, problem):
        self._names = [p.name for p in problem.search_space.parameters]

    def suggest(self, request):
        del request
        return policy_lib.SuggestDecision(suggestions=[
            vz.TrialSuggestion(parameters={name: 0.5 for name in self._names})])


@pytest.fixture
def shared_pythia():
    servicer = vizier_service.VizierServicer()
    pythia = pythia_service.PythiaServicer(
        servicer, policy_factory=lambda problem, algorithm, supporter, name: _BakedPolicy(problem),
        device="cpu")
    servicer.set_pythia(pythia)
    yield pythia
    pythia.shutdown()


def _param_config(param):
    config = vz.StudyConfig(algorithm="RANDOM_SEARCH")
    config.search_space.root.add_float_param(param, 0.0, 1.0)
    config.metric_information.append(vz.MetricInformation(name="obj"))
    return config


def test_a_recreated_study_is_served_fresh_by_the_shared_servicer(shared_pythia):
    first = shared_pythia.Suggest(_suggest_request(_param_config("a0")))
    assert not first.error and _served_by(first) == "a0"
    cached = shared_pythia._config_cache[STUDY]
    assert shared_pythia.Suggest(_suggest_request(_param_config("a0")))
    assert shared_pythia._config_cache[STUDY] is cached  # a hash hit, no reparse
    stats = shared_pythia.serving_runtime.designer_cache.stats
    assert stats.get("cache_invalidations_config") == 0
    second = shared_pythia.Suggest(_suggest_request(_param_config("b0")))
    assert not second.error and [p.name for p in second.suggestions[0].parameters] == ["b0"]
    hash_b = shared_pythia._config_cache[STUDY][0]
    assert all(key[2] == hash_b for key in shared_pythia._policy_cache if key[0] == STUDY)


def test_concurrent_turnover_never_serves_a_stale_policy(shared_pythia):
    errors, barrier = [], threading.Barrier(2)

    def drive(param):
        barrier.wait()
        for _ in range(16):
            response = shared_pythia.Suggest(_suggest_request(_param_config(param)))
            names = [p.name for p in response.suggestions[0].parameters] if not response.error \
                else response.error
            if names != [param]:
                errors.append(f"asked {param}, served {names}")

    threads = [threading.Thread(target=drive, args=(p,)) for p in ("a0", "b0")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)


def test_the_designer_cache_tracks_config_turnover(shared_pythia):
    cache = DesignerStateCache()
    assert not cache.note_config_hash("s1", "aaaa")
    cache.get_or_create("s1", object)
    assert not cache.note_config_hash("s1", "aaaa") and "s1" in cache
    assert cache.note_config_hash("s1", "bbbb") and "s1" not in cache
    assert cache.stats.get("cache_invalidations_config") == 1
    bounded = DesignerStateCache(max_entries=1)
    for i in range(bounded._max_hashes + 10):
        bounded.note_config_hash(f"s{i}", "h")
    assert len(bounded._config_hashes) == bounded._max_hashes
    runtime = shared_pythia.serving_runtime
    runtime.designer_cache.get_or_create(STUDY, object)
    runtime.flight_recorder = recorder_lib.FlightRecorder()
    runtime.flight_recorder.record(STUDY, "loadgen_outcome")
    assert not runtime.note_study_config(STUDY, "h1") and STUDY in runtime.designer_cache
    assert runtime.note_study_config(STUDY, "h2") and STUDY not in runtime.designer_cache
    assert runtime.flight_recorder.ring(STUDY)  # forensic history survives a turnover
