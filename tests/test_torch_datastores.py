"""The port's RAM and SQL datastores on the CPU, held to the JAX package's.

The same sequence of operations on the JAX package's store and on the port's
(RAM and SQLite) leaves studies, trials and operations whose deterministic
serializations are byte for byte equal, and either package's SQLite file is
read by the other's store with every study and trial there. The messages are
built in one package and handed to the other as bytes: the two packages'
messages are payload-compatible, not the same classes.
"""

from __future__ import annotations

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.service import datastore as jdatastore
from vizier_tpu.service import ram_datastore as jram
from vizier_tpu.service import sql_datastore as jsql
from vizier_tpu.service.protos import key_value_pb2 as jkv
from vizier_tpu.service.protos import study_pb2 as jstudy
from vizier_tpu.service.protos import vizier_service_pb2 as jvs
from vizier_tpu_torch.service import datastore
from vizier_tpu_torch.service import ram_datastore
from vizier_tpu_torch.service import sql_datastore
from vizier_tpu_torch.service.protos import key_value_pb2
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2

_JAX = dict(study=jstudy, vs=jvs, kv=jkv, ds=jdatastore, ram=jram.NestedDictRAMDataStore,
            sql=jsql.SQLDataStore)
_PORT = dict(study=study_pb2, vs=vizier_service_pb2, kv=key_value_pb2, ds=datastore,
             ram=ram_datastore.NestedDictRAMDataStore, sql=sql_datastore.SQLDataStore)


def _bytes(proto) -> bytes:
    return proto.SerializeToString(deterministic=True)


def _study(pkg, owner, sid):
    s = pkg["study"].Study(name=f"owners/{owner}/studies/{sid}", display_name=sid,
                           state=pkg["study"].Study.ACTIVE, creation_time_secs=12.5)
    spec = s.study_spec
    spec.algorithm = "DEFAULT"
    p = spec.parameters.add(name="x")
    p.double_range.min_value, p.double_range.max_value = 0.0, 1.0
    c = spec.parameters.add(name="c")
    c.categorical_values.values.extend(["a", "b"])
    m = spec.metrics.add(name="obj")
    m.goal = pkg["study"].MetricSpec.MAXIMIZE
    spec.metadata.add(key="k", ns=":alg", string_value="v")
    return s


def _trial(pkg, owner, sid, tid, state, value=None):
    t = pkg["study"].Trial(name=f"owners/{owner}/studies/{sid}/trials/{tid}", id=tid,
                           state=state, creation_time_secs=float(tid))
    a = t.parameters.add(name="x")
    a.value.double_value = tid / 10.0
    b = t.parameters.add(name="c")
    b.value.string_value = "ab"[tid % 2]
    meas = t.measurements.add(steps=1.0)
    meas.metrics.add(name="obj", value=0.5 * tid)
    if value is not None:
        t.final_measurement.metrics.add(name="obj", value=value)
    t.metadata.add(key="note", ns=":w", bytes_value=bytes([tid]))
    return t


def _script(pkg, store):
    """The same operations on one store; returns every read's bytes."""
    S, V, KV = pkg["study"], pkg["vs"], pkg["kv"]
    reads = []
    for owner, sid in (("o", "a"), ("o", "b"), ("p", "c")):
        store.create_study(_study(pkg, owner, sid))
    states = [S.Trial.SUCCEEDED, S.Trial.ACTIVE, S.Trial.REQUESTED, S.Trial.INFEASIBLE,
              S.Trial.ACTIVE]
    for tid, state in enumerate(states, 1):
        store.create_trial(_trial(pkg, "o", "a", tid, state,
                                  value=0.1 * tid if state == S.Trial.SUCCEEDED else None))
    store.create_trial(_trial(pkg, "o", "b", 1, S.Trial.ACTIVE))
    # Complete trial 2, delete trial 5 (the max id) and trial 3.
    t2 = store.get_trial("owners/o/studies/a/trials/2")
    t2.state = S.Trial.SUCCEEDED
    t2.final_measurement.metrics.add(name="obj", value=0.9)
    store.update_trial(t2)
    store.delete_trial("owners/o/studies/a/trials/5")
    store.delete_trial("owners/o/studies/a/trials/3")
    # Suggestion operations of two clients, one completed with its trials.
    for client, number in (("w0", 1), ("w0", 2), ("w1", 1)):
        op = V.Operation(name=f"owners/o/studies/a/clients/{client}/operations/{number}")
        store.create_suggestion_operation(op)
    done = store.get_suggestion_operation("owners/o/studies/a/clients/w0/operations/1")
    done.done = True
    done.response.trials.add().CopyFrom(store.get_trial("owners/o/studies/a/trials/2"))
    store.update_suggestion_operation(done)
    # Early-stopping operations, one recycled in place.
    es = V.EarlyStoppingOperation(
        name="owners/o/studies/a/trials/4/earlyStoppingOperations/earlystopping-4",
        status=V.EarlyStoppingOperation.ACTIVE, creation_time_secs=3.0)
    store.create_early_stopping_operation(es)
    es.status, es.should_stop, es.completion_time_secs = V.EarlyStoppingOperation.DONE, True, 4.0
    store.update_early_stopping_operation(es)
    store.create_early_stopping_operation(V.EarlyStoppingOperation(
        name="owners/o/studies/a/trials/1/earlyStoppingOperations/earlystopping-1"))
    # Metadata: a study-level update of an existing key, a new key, a trial key.
    store.update_metadata("owners/o/studies/a",
                          [KV.KeyValue(key="k", ns=":alg", string_value="w"),
                           KV.KeyValue(key="n", ns="", double_value=2.0)],
                          [(4, KV.KeyValue(key="note", ns=":w", string_value="four"))])
    study_b = store.load_study("owners/o/studies/b")
    study_b.state = S.Study.COMPLETED
    store.update_study(study_b)
    store.delete_study("owners/p/studies/c")

    reads.append([_bytes(s) for s in store.list_studies("owners/o")])
    reads.append([_bytes(s) for s in store.list_studies("owners/p")])
    reads.append([_bytes(t) for t in store.list_trials("owners/o/studies/a")])
    reads.append([_bytes(t) for t in store.list_trials(
        "owners/o/studies/a", states=(S.Trial.ACTIVE, S.Trial.REQUESTED))])
    reads.append([store.max_trial_id("owners/o/studies/a"), store.max_trial_id("owners/o/studies/b")])
    for client in ("w0", "w1", "w2"):
        for done_filter in (None, False, True):
            reads.append([_bytes(op) for op in store.list_suggestion_operations(
                "owners/o/studies/a", client, done=done_filter)])
        reads.append(store.max_suggestion_operation_number("owners/o/studies/a", client))
    reads.append([_bytes(op) for op in store.list_suggestion_operations(
        "owners/o/studies/a", "w0", lambda op: op.done)])
    for tid in (4, 1):
        reads.append(_bytes(store.get_early_stopping_operation(
            f"owners/o/studies/a/trials/{tid}/earlyStoppingOperations/earlystopping-{tid}")))
    return reads


def _store(pkg, kind, tmp_path):
    if kind == "ram":
        return pkg["ram"]()
    return pkg["sql"](f"sqlite:///{tmp_path}/{id(pkg)}.db")


@pytest.mark.parametrize("port_kind", ["ram", "sql"])
@pytest.mark.parametrize("jax_kind", ["ram", "sql"])
def test_the_same_operations_leave_byte_equal_records(tmp_path, jax_kind, port_kind):
    theirs = _script(_JAX, _store(_JAX, jax_kind, tmp_path))
    ours = _script(_PORT, _store(_PORT, port_kind, tmp_path))
    assert ours == theirs


_MISSING = [
    ("load_study", "owners/o/studies/zz"),
    ("get_trial", "owners/o/studies/a/trials/99"),
    ("get_suggestion_operation", "owners/o/studies/a/clients/w9/operations/1"),
    ("get_early_stopping_operation",
     "owners/o/studies/a/trials/9/earlyStoppingOperations/earlystopping-9"),
    ("delete_study", "owners/o/studies/zz"),
    ("delete_trial", "owners/o/studies/a/trials/99"),
    ("list_trials", "owners/o/studies/zz"),
]


@pytest.mark.parametrize("kind", ["ram", "sql"])
@pytest.mark.parametrize("method,name", _MISSING, ids=[m for m, _ in _MISSING])
def test_missing_resources_raise_like_the_jax_package(tmp_path, kind, method, name):
    for pkg in (_JAX, _PORT):
        store = _store(pkg, kind, tmp_path)
        store.create_study(_study(pkg, "o", "a"))
        with pytest.raises(pkg["ds"].NotFoundError):
            getattr(store, method)(name)
        with pytest.raises(KeyError):
            getattr(store, method)(name)


@pytest.mark.parametrize("kind", ["ram", "sql"])
def test_duplicates_raise_already_exists(tmp_path, kind):
    store = _store(_PORT, kind, tmp_path)
    store.create_study(_study(_PORT, "o", "a"))
    with pytest.raises(datastore.AlreadyExistsError):
        store.create_study(_study(_PORT, "o", "a"))
    store.create_trial(_trial(_PORT, "o", "a", 1, study_pb2.Trial.ACTIVE))
    with pytest.raises(datastore.AlreadyExistsError):
        store.create_trial(_trial(_PORT, "o", "a", 1, study_pb2.Trial.ACTIVE))
    op = vizier_service_pb2.Operation(name="owners/o/studies/a/clients/w/operations/1")
    store.create_suggestion_operation(op)
    with pytest.raises(datastore.AlreadyExistsError):
        store.create_suggestion_operation(op)


@pytest.mark.parametrize("writer,reader", [(_JAX, _PORT), (_PORT, _JAX)],
                         ids=["jax_file_read_by_port", "port_file_read_by_jax"])
def test_either_packages_sqlite_file_is_read_by_the_other(tmp_path, writer, reader):
    url = f"sqlite:///{tmp_path}/shared.db"
    written = _script(writer, writer["sql"](url))
    store = reader["sql"](url)
    studies = store.list_studies("owners/o")
    assert [s.name for s in studies] == ["owners/o/studies/a", "owners/o/studies/b"]
    assert [_bytes(s) for s in studies] == written[0]
    assert [_bytes(t) for t in store.list_trials("owners/o/studies/a")] == written[2]
    assert [t.id for t in store.list_trials("owners/o/studies/b")] == [1]
    assert [_bytes(op) for op in store.list_suggestion_operations(
        "owners/o/studies/a", "w0", done=False)] == written[6]
    # The reader keeps writing to the other package's file.
    store.create_trial(_trial(reader, "o", "b", 2, reader["study"].Trial.REQUESTED))
    assert store.max_trial_id("owners/o/studies/b") == 2
