"""The port's service layer on the CPU, held to the JAX package's.

- protos: every message's descriptor equals the JAX package's but for the
  package name; populated messages serialized by one package parse in the
  other and give the same deterministic bytes again; both packages' protos
  load in one process, and their gRPC method paths differ (ROADMAP C9).
- converters: the same study config and trials give the same bytes.
- servicers: the same client script runs against the JAX package's server
  and the port's (``device="cpu"``), in-process and over gRPC:
  RANDOM_SEARCH (a seeded ``RandomPolicy`` in both), QUASI_RANDOM_SEARCH and
  GRID_SEARCH give the same suggestions trial for trial and the same optimal
  trials; the median and regression early-stopping decisions are equal;
  ``ListOptimalTrials`` gives the same ids, single- and two-objective; a
  failing designer degrades to the same stamped fallback bytes; the DEFAULT
  served over gRPC by the port's server gives finite, in-bounds suggestions
  with no fallback stamp; and the scenarios of the JAX package's
  ``tests/service/test_service.py`` hold for both packages.
- clients: the port's copy of ``StudyConformance``, in-process and over
  gRPC, against the port's ``clients.Study``.
"""

from __future__ import annotations

import datetime
import math
import threading
import time
import types

import grpc
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)
from google.protobuf import descriptor_pb2

from vizier_tpu import pyvizier as jvz
from vizier_tpu.algorithms import random_policy as jrandom_policy
from vizier_tpu.service import clients as jclients
from vizier_tpu.service import grpc_stubs as jgrpc_stubs
from vizier_tpu.service import policy_factory as jpolicy_factory
from vizier_tpu.service import proto_converters as jpc
from vizier_tpu.service import protos as jprotos
from vizier_tpu.service import pythia_service as jpythia_service
from vizier_tpu.service import resources as jresources
from vizier_tpu.service import vizier_client as jvizier_client
from vizier_tpu.service import vizier_server as jvizier_server
from vizier_tpu.service import vizier_service as jvizier_service
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import random_policy
from vizier_tpu_torch.client import client_abc_testing
from vizier_tpu_torch.reliability import fallback as fallback_lib
from vizier_tpu_torch.service import clients
from vizier_tpu_torch.service import grpc_stubs
from vizier_tpu_torch.service import policy_factory
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import protos
from vizier_tpu_torch.service import pythia_service
from vizier_tpu_torch.service import resources
from vizier_tpu_torch.service import vizier_client
from vizier_tpu_torch.service import vizier_server
from vizier_tpu_torch.service import vizier_service

JAX = types.SimpleNamespace(
    name="jax", vz=jvz, random_policy=jrandom_policy, clients=jclients, grpc_stubs=jgrpc_stubs,
    policy_factory=jpolicy_factory, pc=jpc, protos=jprotos, pythia_service=jpythia_service,
    resources=jresources, vizier_client=jvizier_client, vizier_server=jvizier_server,
    vizier_service=jvizier_service, kw={})
PORT = types.SimpleNamespace(
    name="port", vz=vz, random_policy=random_policy, clients=clients, grpc_stubs=grpc_stubs,
    policy_factory=policy_factory, pc=pc, protos=protos, pythia_service=pythia_service,
    resources=resources, vizier_client=vizier_client, vizier_server=vizier_server,
    vizier_service=vizier_service, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
_FILES = ("key_value_pb2", "study_pb2", "vizier_service_pb2", "pythia_service_pb2")
_WHEN = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)


def _bytes(proto) -> bytes:
    return proto.SerializeToString(deterministic=True)


# -- protos ---------------------------------------------------------------------


def _messages():
    return [(f, name) for f in _FILES
            for name in getattr(jprotos, f).DESCRIPTOR.message_types_by_name]


@pytest.mark.parametrize("module,message", _messages(), ids=[f"{f}.{m}" for f, m in _messages()])
def test_message_descriptor_equals_the_jax_packages(module, message):
    """Fields (names, numbers, types, labels, json names, message and enum
    types), oneofs, nested messages and enums, all but the package."""
    theirs = getattr(jprotos, module).DESCRIPTOR.message_types_by_name[message]
    ours = getattr(protos, module).DESCRIPTOR.message_types_by_name[message]
    a, b = descriptor_pb2.DescriptorProto(), descriptor_pb2.DescriptorProto()
    theirs.CopyToProto(a)
    ours.CopyToProto(b)
    assert str(b).replace('".vizier_tpu_torch.', '".vizier_tpu.') == str(a)
    assert ours.full_name == f"vizier_tpu_torch.{message}"


@pytest.mark.parametrize("module", _FILES)
def test_files_register_under_the_ports_package_beside_the_jax_packages(module):
    ours = getattr(protos, module).DESCRIPTOR
    theirs = getattr(jprotos, module).DESCRIPTOR
    assert ours.name == f"vizier_tpu_torch/service/protos/{module[:-4]}.proto"
    assert ours.package == "vizier_tpu_torch" and theirs.package == "vizier_tpu"
    assert sorted(ours.message_types_by_name) == sorted(theirs.message_types_by_name)
    assert sorted(ours.services_by_name) == sorted(theirs.services_by_name)
    for name, service in theirs.services_by_name.items():
        assert [(m.name, m.input_type.name, m.output_type.name) for m in service.methods] == [
            (m.name, m.input_type.name, m.output_type.name)
            for m in ours.services_by_name[name].methods]
    assert getattr(protos, module).__name__ == f"vizier_tpu_torch.service.protos.{module}"


def _populated(pkg):
    """A Study, a Trial, a SuggestTrialsRequest and a PythiaSuggestRequest."""
    config = _rich_config(pkg.vz)
    study = pkg.pc.study_to_proto(config, "owners/o/studies/s", display_name="s")
    study.creation_time_secs = 7.25
    trial = pkg.pc.trial_to_proto(_rich_trial(pkg.vz), name="owners/o/studies/s/trials/3")
    V = pkg.protos.vizier_service_pb2
    suggest = V.SuggestTrialsRequest(parent=study.name, suggestion_count=3, client_id="w",
                                     deadline_secs=12.5, trace_context="ab-cd")
    P = pkg.protos.pythia_service_pb2
    pythia = P.PythiaSuggestRequest(count=2, algorithm="DEFAULT", study_name=study.name,
                                    deadline_secs=-0.5, trace_context="t-s")
    pythia.study_descriptor.config.CopyFrom(study.study_spec)
    pythia.study_descriptor.guid = study.name
    pythia.study_descriptor.max_trial_id = 41
    op = V.Operation(name="owners/o/studies/s/clients/w/operations/1", done=True, error="e")
    op.response.trials.add().CopyFrom(trial)
    return {"Study": study, "Trial": trial, "SuggestTrialsRequest": suggest,
            "PythiaSuggestRequest": pythia, "Operation": op}


@pytest.mark.parametrize("kind", ["Study", "Trial", "SuggestTrialsRequest",
                                  "PythiaSuggestRequest", "Operation"])
@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port_to_jax", "jax_to_port"])
def test_a_message_crosses_the_packages_byte_for_byte(kind, writer, reader):
    sent = _populated(writer)[kind]
    data = _bytes(sent)
    received = type(_populated(reader)[kind]).FromString(data)
    assert _bytes(received) == data
    assert _bytes(received) == _bytes(_populated(reader)[kind])


# -- converters -----------------------------------------------------------------


def _rich_config(m):
    """tests/service/test_service.py's converter cases, in package ``m``."""
    config = m.StudyConfig(algorithm="RANDOM_SEARCH")
    root = config.search_space.root
    root.add_float_param("x", 0.0, 1.0)
    root.add_categorical_param("c", ["a", "b"])
    root.add_int_param("n", 1, 5)
    root.add_discrete_param("d", [0.5, 1.5])
    sel = root.add_categorical_param("model", ["m1", "m2"])
    sel.select_values(["m2"]).add_float_param("lr", 1e-4, 1e-1, scale_type=m.ScaleType.LOG)
    config.metadata.ns("alg")["state"] = b"\x00\x01"
    config.metadata.ns("gp_ucb_pe")["max_acquisition_evaluations"] = "300"
    config.metric_information.append(
        m.MetricInformation(name="obj", goal=m.ObjectiveMetricGoal.MAXIMIZE))
    config.metric_information.append(
        m.MetricInformation(name="safe", goal=m.ObjectiveMetricGoal.MINIMIZE,
                            safety_threshold=0.7, desired_min_safe_trials_fraction=0.5))
    config.automated_stopping_config = m.AutomatedStoppingConfig(
        use_steps=False, min_num_trials=4, rule="regression")
    config.observation_noise = m.ObservationNoise.HIGH
    return config


def _rich_trial(m):
    t = m.Trial(id=3, parameters={"x": 0.25, "c": "b", "n": 2}, assigned_worker="w1",
                creation_time=_WHEN)
    t.metadata.ns("m")["k"] = "v"
    t.metadata.ns("m").ns("deep")["b"] = b"\x02"
    t.measurements.append(m.Measurement(metrics={"obj": 0.5}, steps=1, elapsed_secs=2.0))
    t.complete(m.Measurement(metrics={"obj": m.Metric(0.9, std=0.1)}))
    t.completion_time = _WHEN
    return t


def _trial_cases(m):
    infeasible = m.Trial(id=1, creation_time=_WHEN)
    infeasible.complete(infeasibility_reason="nan")
    infeasible.completion_time = _WHEN
    stopping = m.Trial(id=2, parameters={"x": 0.5}, creation_time=_WHEN)
    stopping.stop("slow")
    requested = m.Trial(id=4, parameters={"c": "a"}, is_requested=True, creation_time=_WHEN)
    return {"completed": _rich_trial(m), "infeasible": infeasible, "stopping": stopping,
            "requested": requested}


def test_study_config_converts_to_the_same_bytes():
    ours = _bytes(pc.study_config_to_proto(_rich_config(vz)))
    assert ours == _bytes(jpc.study_config_to_proto(_rich_config(jvz)))
    back = pc.study_config_from_proto(protos.study_pb2.StudySpec.FromString(ours))
    assert back.search_space.get("model").children[0].name == "lr"
    assert back.metric_information.get("safe").safety_threshold == 0.7
    assert back.metadata.ns("alg")["state"] == b"\x00\x01"
    assert back.automated_stopping_config.rule == "regression"
    assert _bytes(pc.study_config_to_proto(back)) == ours


@pytest.mark.parametrize("case", ["completed", "infeasible", "stopping", "requested"])
def test_trials_convert_to_the_same_bytes(case):
    ours = _bytes(pc.trial_to_proto(_trial_cases(vz)[case], name="owners/o/studies/s/trials/9"))
    theirs = _bytes(jpc.trial_to_proto(_trial_cases(jvz)[case], name="owners/o/studies/s/trials/9"))
    assert ours == theirs
    back = pc.trial_from_proto(protos.study_pb2.Trial.FromString(theirs))
    again = jpc.trial_from_proto(jprotos.study_pb2.Trial.FromString(theirs))
    assert back.status.name == again.status.name and back.infeasible == again.infeasible
    assert back.parameters.as_dict() == again.parameters.as_dict()
    assert _bytes(pc.trial_to_proto(back, name="owners/o/studies/s/trials/9")) == ours


def test_suggestions_and_metadata_convert_to_the_same_bytes():
    s = vz.TrialSuggestion(parameters={"x": 0.5, "c": "a"})
    s.metadata.ns("reliability")["fallback"] = "quasi_random"
    t = jvz.TrialSuggestion(parameters={"x": 0.5, "c": "a"})
    t.metadata.ns("reliability")["fallback"] = "quasi_random"
    ours, theirs = pc.trial_suggestion_to_proto(s), jpc.trial_suggestion_to_proto(t)
    ours.creation_time_secs = theirs.creation_time_secs = 0.0
    assert _bytes(ours) == _bytes(theirs)
    md = vz.Metadata()
    md.ns("a").ns("b")["k"] = 2.5
    jmd = jvz.Metadata()
    jmd.ns("a").ns("b")["k"] = 2.5
    assert [_bytes(kv) for kv in pc.metadata_to_key_values(md)] == [
        _bytes(kv) for kv in jpc.metadata_to_key_values(jmd)]


# -- servicers ------------------------------------------------------------------


class _Seeded:
    """The package's default factory, with RANDOM_SEARCH seeded the same in
    both packages (the default factory's RandomPolicy draws a fresh seed)."""

    def __init__(self, pkg):
        self._pkg = pkg
        self._inner = pkg.policy_factory.DefaultPolicyFactory(**pkg.kw)

    def __call__(self, problem, algorithm, supporter, study_name):
        if (algorithm or "").upper() == "RANDOM_SEARCH":
            return self._pkg.random_policy.RandomPolicy(supporter, seed=7)
        return self._inner(problem, algorithm, supporter, study_name)


def _servicer(pkg, factory=None, **kwargs):
    servicer = pkg.vizier_service.VizierServicer(**kwargs)
    servicer.set_pythia(pkg.pythia_service.PythiaServicer(servicer, factory, **pkg.kw))
    return servicer


def _close(servicer):
    servicer._pythia.shutdown()


class _Transport:
    """An in-process service or a gRPC server for one package."""

    def __init__(self, pkg, kind, factory=None):
        self.pkg, self.kind = pkg, kind
        if kind == "inprocess":
            self.servicer = _servicer(pkg, factory)
            pkg.vizier_client._local_servicer = self.servicer
            self.endpoint = None
            self.pythia = self.servicer._pythia
        else:
            self.server = pkg.vizier_server.DefaultVizierServer(policy_factory=factory, **pkg.kw)
            self.endpoint = self.server.endpoint
            self.pythia = self.server.pythia_servicer

    def close(self):
        if self.kind == "inprocess":
            self.pkg.vizier_client._local_servicer = None
        else:
            self.server.stop(0)
        self.pythia.shutdown()


def _config(m, algorithm, objectives=1, stopping=None):
    config = m.StudyConfig(algorithm=algorithm)
    root = config.search_space.root
    root.add_float_param("x", 0.0, 1.0)
    root.add_int_param("n", 1, 4)
    root.add_categorical_param("c", ["a", "b"])
    config.metric_information.append(
        m.MetricInformation(name="obj", goal=m.ObjectiveMetricGoal.MAXIMIZE))
    if objectives == 2:
        config.metric_information.append(
            m.MetricInformation(name="cost", goal=m.ObjectiveMetricGoal.MINIMIZE))
    if stopping is not None:
        config.automated_stopping_config = m.AutomatedStoppingConfig(**stopping)
    return config


def _objective(params) -> float:
    return -(params["x"] - 0.3) ** 2 + 0.1 * params["n"] + (0.2 if params["c"] == "b" else 0.0)


def _client_script(pkg, endpoint, algorithm):
    study = pkg.clients.Study.from_study_config(
        _config(pkg.vz, algorithm), owner="parity", study_id=algorithm.lower(),
        endpoint=endpoint)
    seen = []
    for round_ in range(3):
        for trial in study.suggest(count=2, client_id=f"w{round_ % 2}"):
            params = trial.parameters
            seen.append((trial.id, sorted(params.items())))
            trial.complete(pkg.vz.Measurement(metrics={"obj": _objective(params)}))
    optimal = sorted(t.id for t in study.optimal_trials())
    study.delete()
    return seen, optimal


@pytest.mark.parametrize("transport", ["inprocess", "grpc"])
@pytest.mark.parametrize("algorithm", ["RANDOM_SEARCH", "QUASI_RANDOM_SEARCH", "GRID_SEARCH"])
def test_host_algorithms_suggest_the_same_trials_through_both_servers(algorithm, transport):
    results = []
    for pkg in (JAX, PORT):
        t = _Transport(pkg, transport, _Seeded(pkg))
        try:
            results.append(_client_script(pkg, t.endpoint, algorithm))
        finally:
            t.close()
    assert results[0] == results[1]
    assert len(results[1][0]) == 6 and len(results[1][1]) == 1


def _complete(servicer, pkg, name, metrics):
    V, S = pkg.protos.vizier_service_pb2, pkg.protos.study_pb2
    created = servicer.CreateTrial(V.CreateTrialRequest(parent=name, trial=S.Trial()))
    request = V.CompleteTrialRequest(name=created.name)
    for metric, value in metrics.items():
        m = request.final_measurement.metrics.add()
        m.name, m.value = metric, value
    servicer.CompleteTrial(request)
    return created.id


@pytest.mark.parametrize("objectives", [1, 2])
def test_list_optimal_trials_gives_the_same_ids(objectives):
    rng = np.random.default_rng(5)
    points = rng.uniform(size=(12, 2)).round(3)
    ids = []
    for pkg in (JAX, PORT):
        servicer = _servicer(pkg)
        name = "owners/o/studies/opt"
        servicer.CreateStudy(pkg.protos.vizier_service_pb2.CreateStudyRequest(
            parent="owners/o", study=pkg.pc.study_to_proto(
                _config(pkg.vz, "RANDOM_SEARCH", objectives), name)))
        for a, b in points:
            _complete(servicer, pkg, name, {"obj": a, "cost": b} if objectives == 2 else {"obj": a})
        response = servicer.ListOptimalTrials(
            pkg.protos.vizier_service_pb2.ListOptimalTrialsRequest(parent=name))
        ids.append([t.id for t in response.optimal_trials])
        _close(servicer)
    assert ids[0] == ids[1]
    assert len(ids[1]) == (1 if objectives == 1 else len(ids[1])) and ids[1]


def _curve_study(pkg, rule, completed, active, steps=8):
    """Learning curves y_t = f (1 - exp(-t / 3)) with seeded f and noise."""
    servicer = _servicer(pkg, early_stop_recycle_period=datetime.timedelta(seconds=0))
    V, S = pkg.protos.vizier_service_pb2, pkg.protos.study_pb2
    name = f"owners/o/studies/curves-{rule}"
    config = _config(pkg.vz, "RANDOM_SEARCH", stopping=dict(min_num_trials=4, rule=rule))
    servicer.CreateStudy(V.CreateStudyRequest(parent="owners/o",
                                              study=pkg.pc.study_to_proto(config, name)))
    rng = np.random.default_rng(11)
    active_names = []
    for i in range(completed + active):
        trial = S.Trial()
        for pname, value in (("x", float(rng.uniform())), ("n", int(rng.integers(1, 5)))):
            a = trial.parameters.add(name=pname)
            if isinstance(value, int):
                a.value.int_value = value
            else:
                a.value.double_value = value
        trial.parameters.add(name="c").value.string_value = "ab"[i % 2]
        created = servicer.CreateTrial(V.CreateTrialRequest(parent=name, trial=trial))
        final = float(rng.uniform(0.2, 1.0))
        noise = rng.normal(scale=0.01, size=steps)
        length = steps if i < completed else 3 + i % 3
        for step in range(1, length + 1):
            add = V.AddTrialMeasurementRequest(trial_name=created.name)
            add.measurement.steps = step
            metric = add.measurement.metrics.add()
            metric.name, metric.value = "obj", final * (1 - math.exp(-step / 3)) + noise[step - 1]
            servicer.AddTrialMeasurement(add)
        if i < completed:
            servicer.CompleteTrial(V.CompleteTrialRequest(name=created.name))
        else:
            active_names.append(created.name)
    return servicer, name, active_names


@pytest.mark.parametrize("rule", ["median", "regression"])
def test_early_stopping_decisions_are_equal(rule):
    decisions = []
    for pkg in (JAX, PORT):
        servicer, name, active = _curve_study(pkg, rule, completed=14, active=6)
        V = pkg.protos.vizier_service_pb2
        decisions.append([servicer.CheckTrialEarlyStoppingState(
            V.CheckTrialEarlyStoppingStateRequest(trial_name=t)).should_stop for t in active])
        pythia = servicer._pythia
        policy = pythia._stopping_policies.get(name)
        if rule == "regression":
            assert type(policy).__name__ == "RegressionEarlyStopPolicy"
            servicer.CheckTrialEarlyStoppingState(
                V.CheckTrialEarlyStoppingStateRequest(trial_name=active[0]))
            assert pythia._stopping_policies[name] is policy
        else:
            assert policy is None
        _close(servicer)
    assert decisions[0] == decisions[1]
    assert any(decisions[1]) and not all(decisions[1])


class _FailingFactory:
    """Every suggest raises inside the policy: a designer failure."""

    def __init__(self, pkg):
        self._inner = _Seeded(pkg)

    def __call__(self, problem, algorithm, supporter, study_name):
        policy = self._inner(problem, algorithm, supporter, study_name)

        def suggest(request):
            raise RuntimeError("designer exploded")

        policy.suggest = suggest
        return policy


def _pythia_request(pkg, config, name, *, count=3, max_trial_id=4, deadline_secs=0.0,
                    algorithm=""):
    request = pkg.protos.pythia_service_pb2.PythiaSuggestRequest(
        count=count, algorithm=algorithm, study_name=name, deadline_secs=deadline_secs)
    request.study_descriptor.config.CopyFrom(pkg.pc.study_config_to_proto(config))
    request.study_descriptor.guid = name
    request.study_descriptor.max_trial_id = max_trial_id
    return request


def _untimed(response) -> bytes:
    """A suggest response's bytes without the suggestions' creation times."""
    for suggestion in response.suggestions:
        suggestion.ClearField("creation_time_secs")
    return _bytes(response)


def test_a_failing_designer_degrades_to_the_same_stamped_fallback_bytes():
    """Three designer failures each degrade to seeded quasi-random points, the
    breaker then opens and short-circuits; both packages answer the same."""
    answers = []
    for pkg in (JAX, PORT):
        pythia = pkg.pythia_service.PythiaServicer(None, _FailingFactory(pkg), **pkg.kw)
        config = _config(pkg.vz, "RANDOM_SEARCH")
        request = _pythia_request(pkg, config, "owners/o/studies/failing")
        answers.append([_untimed(pythia.Suggest(request)) for _ in range(4)])
        snap = pythia.serving_stats()
        assert (snap["designer_failures"], snap["fallbacks"], snap["breaker_short_circuits"],
                snap["open_breakers"]) == (3, 12, 1, 1)
        pythia.shutdown()
    assert answers[0] == answers[1]
    response = protos.pythia_service_pb2.PythiaSuggestResponse.FromString(answers[1][3])
    suggestions = [pc.trial_from_proto(t) for t in response.suggestions]
    assert len(suggestions) == 3 and all(
        fallback_lib.is_fallback_suggestion(t.metadata) for t in suggestions)
    assert suggestions[0].metadata.ns("reliability")["fallback_reason"] == "circuit_open"


def test_the_vizier_servicer_reports_its_pythias_serving_stats_as_the_jax_one_does():
    """``VizierServicer.serving_stats`` is the connected in-process Pythia's
    snapshot, and {} with no in-process Pythia, in both packages."""
    snaps = []
    for pkg in (JAX, PORT):
        assert pkg.vizier_service.VizierServicer().serving_stats() == {}
        servicer = _servicer(pkg, _FailingFactory(pkg))
        request = _pythia_request(pkg, _config(pkg.vz, "RANDOM_SEARCH"), "owners/o/studies/stats")
        servicer._pythia.Suggest(request)
        snap = servicer.serving_stats()
        assert snap == servicer._pythia.serving_stats()
        snaps.append(snap)
        _close(servicer)
    assert snaps[1].keys() == snaps[0].keys()
    for key in ("designer_failures", "fallbacks", "breaker_short_circuits", "open_breakers"):
        assert snaps[1][key] == snaps[0][key], key
    assert snaps[1]["fallbacks"] > 0


def test_an_expired_wire_deadline_is_refused_before_dispatch_by_both():
    errors = []
    for pkg in (JAX, PORT):
        calls = []

        def factory(problem, algorithm, supporter, study_name, _calls=calls):
            _calls.append(1)
            return _Seeded(pkg)(problem, algorithm, supporter, study_name)

        pythia = pkg.pythia_service.PythiaServicer(None, factory, **pkg.kw)
        response = pythia.Suggest(_pythia_request(
            pkg, _config(pkg.vz, "RANDOM_SEARCH"), "owners/o/studies/late", deadline_secs=-1.0))
        errors.append(response.error.split("(over budget")[0])
        assert not response.suggestions and pythia.serving_stats()["deadline_exceeded"] == 1
        pythia.shutdown()
    assert errors[0] == errors[1]
    assert errors[1].startswith("DeadlineExceededError: TRANSIENT: DEADLINE_EXCEEDED")


class _SlowFactory(_Seeded):
    calls = 0

    def __call__(self, problem, algorithm, supporter, study_name):
        policy = super().__call__(problem, algorithm, supporter, study_name)
        inner = policy.suggest

        def suggest(request):
            type(self).calls += 1
            time.sleep(0.5)
            return inner(request)

        policy.suggest = suggest
        return policy


@PKGS
def test_concurrent_identical_suggests_coalesce_onto_one_computation(pkg):
    _SlowFactory.calls = 0
    pythia = pkg.pythia_service.PythiaServicer(None, _SlowFactory(pkg), **pkg.kw)
    request = _pythia_request(pkg, _config(pkg.vz, "RANDOM_SEARCH"), "owners/o/studies/co")
    out = [None] * 4
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait()
        out[i] = _bytes(pythia.Suggest(request))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    snap = pythia.serving_stats()
    pythia.shutdown()
    assert _SlowFactory.calls == 1 and len(set(out)) == 1 and out[0]
    assert snap["coalesced_requests"] == 3 and snap["coalesced_computations"] == 1


def _create(servicer, pkg, config, name="owners/o/studies/s"):
    servicer.CreateStudy(pkg.protos.vizier_service_pb2.CreateStudyRequest(
        parent="owners/o", study=pkg.pc.study_to_proto(config, name)))
    return name


def _suggest(servicer, pkg, name, count, client):
    return servicer.SuggestTrials(pkg.protos.vizier_service_pb2.SuggestTrialsRequest(
        parent=name, suggestion_count=count, client_id=client))


@PKGS
def test_active_trials_are_reused_per_client(pkg):
    servicer = _servicer(pkg, _Seeded(pkg))
    name = _create(servicer, pkg, _config(pkg.vz, "RANDOM_SEARCH"))
    first, again = (_suggest(servicer, pkg, name, 2, "w0") for _ in range(2))
    assert [t.id for t in first.response.trials] == [t.id for t in again.response.trials]
    other = _suggest(servicer, pkg, name, 2, "w1")
    assert {t.id for t in other.response.trials}.isdisjoint(t.id for t in first.response.trials)
    _close(servicer)


@PKGS
def test_a_pythia_error_is_captured_in_the_operation(pkg):
    servicer = _servicer(pkg)
    name = _create(servicer, pkg, _config(pkg.vz, "NO_SUCH_ALGORITHM"))
    op = _suggest(servicer, pkg, name, 1, "w0")
    assert op.done and "Unknown algorithm" in op.error
    _close(servicer)


@PKGS
def test_completed_trials_are_immutable(pkg):
    servicer = _servicer(pkg, _Seeded(pkg))
    V, S = pkg.protos.vizier_service_pb2, pkg.protos.study_pb2
    name = _create(servicer, pkg, _config(pkg.vz, "RANDOM_SEARCH"))
    trial = _suggest(servicer, pkg, name, 1, "w0").response.trials[0]
    request = V.CompleteTrialRequest(name=trial.name)
    metric = request.final_measurement.metrics.add()
    metric.name, metric.value = "obj", 1.0
    servicer.CompleteTrial(request)
    with pytest.raises(ValueError):
        servicer.CompleteTrial(request)
    add = V.AddTrialMeasurementRequest(trial_name=trial.name)
    add.measurement.metrics.add(name="obj", value=2.0)
    with pytest.raises(ValueError):
        servicer.AddTrialMeasurement(add)
    created = servicer.CreateTrial(V.CreateTrialRequest(parent=name, trial=S.Trial()))
    done = servicer.CompleteTrial(V.CompleteTrialRequest(name=created.name))
    assert done.state == S.Trial.INFEASIBLE
    _close(servicer)


@PKGS
def test_an_orphaned_operation_is_recovered(pkg, tmp_path):
    url = f"sqlite:///{tmp_path}/wedge.db"
    first = _servicer(pkg, _Seeded(pkg), database_url=url)
    name = _create(first, pkg, _config(pkg.vz, "RANDOM_SEARCH"))
    first.datastore.create_suggestion_operation(pkg.protos.vizier_service_pb2.Operation(
        name=pkg.resources.SuggestionOperationResource("o", "s", "w0", 1).name))
    restarted = _servicer(pkg, _Seeded(pkg), database_url=url)
    op = _suggest(restarted, pkg, name, 1, "w0")
    assert op.done and not op.error and len(op.response.trials) == 1
    assert op.name.endswith("/operations/2")
    orphan = restarted.GetOperation(pkg.protos.vizier_service_pb2.GetOperationRequest(
        name=pkg.resources.SuggestionOperationResource("o", "s", "w0", 1).name))
    assert orphan.done and "Orphaned" in orphan.error
    _close(first)
    _close(restarted)


@PKGS
def test_a_stale_early_stopping_operation_is_recycled(pkg):
    servicer, name, active = _curve_study(pkg, "median", completed=3, active=1, steps=3)
    V = pkg.protos.vizier_service_pb2
    # The active trial's curve (steps 1..3) lags the completed ones? Plant a
    # stale ACTIVE op pinned to should_stop=False for it first.
    trial_id = int(active[0].rsplit("/", 1)[1])
    servicer.datastore.create_early_stopping_operation(V.EarlyStoppingOperation(
        name=pkg.resources.EarlyStoppingOperationResource("o", name.rsplit("/", 1)[1],
                                                          trial_id).name,
        status=V.EarlyStoppingOperation.ACTIVE, creation_time_secs=0.0))
    first = servicer.CheckTrialEarlyStoppingState(
        V.CheckTrialEarlyStoppingStateRequest(trial_name=active[0]))
    stored = servicer.datastore.get_early_stopping_operation(
        pkg.resources.EarlyStoppingOperationResource("o", name.rsplit("/", 1)[1], trial_id).name)
    assert stored.status == V.EarlyStoppingOperation.DONE and stored.creation_time_secs > 0
    assert stored.should_stop == first.should_stop
    _close(servicer)


@PKGS
def test_an_algorithm_override_stays_with_its_request(pkg):
    servicer = _servicer(pkg, _Seeded(pkg))
    pythia = servicer._pythia
    config = _config(pkg.vz, "RANDOM_SEARCH")
    name = _create(servicer, pkg, config, "owners/o/studies/override")
    assert not pythia.Suggest(_pythia_request(pkg, config, name, count=1,
                                              algorithm="QUASI_RANDOM_SEARCH")).error
    assert pythia._config_cache[name][1].algorithm == "RANDOM_SEARCH"
    assert not pythia.Suggest(_pythia_request(pkg, config, name, count=1)).error
    _close(servicer)


@PKGS
@pytest.mark.parametrize("key,value,attribute,expected", [
    ("acquisition_budget_policy", None, "acquisition_budget_policy", "first_pick_full"),
    ("acquisition_budget_policy", "per_pick", "acquisition_budget_policy", "per_pick"),
    ("max_acquisition_evaluations", "300", "max_acquisition_evaluations", 300),
    ("acquisition_budget_policy", "always_free_lunch", None, "acquisition_budget_policy"),
    ("max_acquisition_evaluations", "-5", None, "max_acquisition_evaluations"),
])
def test_metadata_knobs_reach_the_default_designer(pkg, key, value, attribute, expected):
    from vizier_tpu.pythia import local_policy_supporters as jlps
    from vizier_tpu_torch.pythia import local_policy_supporters as lps

    config = _config(pkg.vz, "DEFAULT")
    problem = config.to_problem()
    if value is not None:
        problem.metadata.ns("gp_ucb_pe")[key] = value
    supporter = (jlps if pkg is JAX else lps).InRamPolicySupporter(config)
    factory = pkg.policy_factory.DefaultPolicyFactory(**pkg.kw)
    if attribute is None:
        with pytest.raises(ValueError, match=expected):
            factory(problem, "DEFAULT", supporter, "s")
        return
    designer = factory(problem, "DEFAULT", supporter, "s")._designer_factory(problem)
    assert getattr(designer, attribute) == expected


def test_the_default_over_grpc_from_the_ports_server_is_served_by_the_designer():
    server = vizier_server.DefaultVizierServer(device="cpu")
    try:
        config = vz.StudyConfig(algorithm="DEFAULT")
        for j in range(3):
            config.search_space.root.add_float_param(f"x{j}", -1.0, 2.0)
        config.metric_information.append(vz.MetricInformation(name="obj"))
        config.metadata.ns("gp_ucb_pe")["max_acquisition_evaluations"] = "300"
        config.metadata.ns("gp_ucb_pe")["acquisition_budget_policy"] = "per_pick"
        study = clients.Study.from_study_config(config, owner="gp", study_id="default",
                                                endpoint=server.endpoint)
        rng = np.random.default_rng(2)
        for trial in study.suggest(count=6, client_id="seed"):
            trial.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        for round_ in range(2):
            for trial in study.suggest(count=2):
                p = trial.parameters
                values = np.array([p[f"x{j}"] for j in range(3)])
                assert np.all(np.isfinite(values)) and np.all((values >= -1) & (values <= 2))
                materialized = trial.materialize()
                assert not fallback_lib.is_fallback_suggestion(materialized.metadata)
                assert materialized.metadata.ns("gp_ucb_pe").get("acquisition") is not None
                trial.complete(vz.Measurement(metrics={"obj": float(-np.sum(values ** 2))}))
        stats = server.serving_stats()
        assert stats["fallbacks"] == 0 and stats["designer_failures"] == 0
        entry = server.pythia_servicer.serving_runtime.designer_cache.peek(
            study.resource_name, touch=False)
        assert entry.designer.max_acquisition_evaluations == 300
        assert entry.designer.acquisition_budget_policy == "per_pick"
        assert entry.designer.device == torch.device("cpu")
    finally:
        server.stop(0)


def test_the_split_pythia_topology_serves_the_port():
    server = vizier_server.DistributedPythiaVizierServer(policy_factory=_Seeded(PORT),
                                                         device="cpu")
    try:
        study = clients.Study.from_study_config(_config(vz, "RANDOM_SEARCH"), owner="me",
                                                study_id="dist", endpoint=server.endpoint)
        assert len(study.suggest(count=2)) == 2
    finally:
        server.stop(0)


def test_parallel_workers_on_the_ports_in_process_service():
    t = _Transport(PORT, "inprocess", _Seeded(PORT))
    try:
        study = clients.Study.from_study_config(_config(vz, "RANDOM_SEARCH"), owner="me",
                                                study_id="conc")
        errors = []

        def worker(wid):
            try:
                for _ in range(3):
                    for trial in study.suggest(count=1, client_id=f"w{wid}"):
                        trial.complete(vz.Measurement(metrics={"obj": 0.5}))
            except Exception as e:  # noqa: BLE001 - the test reads it
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors
        trials = list(study.trials())
        assert len(trials) == 24 and all(tr.status == vz.TrialStatus.COMPLETED for tr in trials)
    finally:
        t.close()


def test_the_method_paths_differ_between_the_packages():
    """Payload-compatible, not call-compatible (ROADMAP C9): each package's
    client gets UNIMPLEMENTED from the other's server."""
    assert grpc_stubs.VIZIER_SERVICE_NAME == "vizier_tpu_torch.VizierService"
    assert grpc_stubs.PYTHIA_SERVICE_NAME == "vizier_tpu_torch.PythiaService"
    assert list(grpc_stubs.VIZIER_METHODS) == list(jgrpc_stubs.VIZIER_METHODS)
    assert list(grpc_stubs.PYTHIA_METHODS) == list(jgrpc_stubs.PYTHIA_METHODS)
    ours = vizier_server.DefaultVizierServer(device="cpu")
    theirs = jvizier_server.DefaultVizierServer()
    try:
        for stub_module, server, request in (
                (jgrpc_stubs, ours, jprotos.vizier_service_pb2.GetStudyRequest(name="owners/o/studies/s")),
                (grpc_stubs, theirs, protos.vizier_service_pb2.GetStudyRequest(name="owners/o/studies/s"))):
            channel = grpc.insecure_channel(server.endpoint)
            try:
                with pytest.raises(grpc.RpcError) as error:
                    stub_module.VizierServiceStub(channel).GetStudy(request)
                assert error.value.code() == grpc.StatusCode.UNIMPLEMENTED
            finally:
                channel.close()
    finally:
        ours.stop(0)
        theirs.stop(0)
        theirs.pythia_servicer.shutdown()


def test_servers_and_servicers_run_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pythia_service.PythiaServicer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vizier_server.DefaultVizierServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vizier_server.DistributedPythiaVizierServer()
    monkeypatch.setattr(vizier_client, "_local_servicer", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clients.Study.from_study_config(_config(vz, "RANDOM_SEARCH"), owner="me", study_id="d")
    pythia = pythia_service.PythiaServicer(device="cpu")
    assert pythia.device == torch.device("cpu")
    pythia.shutdown()


# -- clients: the port's copy of the JAX package's conformance suite --------------


class TestInProcessClientConformance(client_abc_testing.StudyConformance):
    def setup_method(self):
        self._transport = _Transport(PORT, "inprocess")

    def teardown_method(self):
        self._transport.close()

    def create_study(self, problem, study_id):
        config = vz.StudyConfig.from_problem(problem, vz.Algorithm.RANDOM_SEARCH)
        return clients.Study.from_study_config(config, owner="conformance", study_id=study_id)


class TestGrpcClientConformance(client_abc_testing.StudyConformance):
    _server = None

    @classmethod
    def setup_class(cls):
        cls._server = vizier_server.DefaultVizierServer(device="cpu")

    @classmethod
    def teardown_class(cls):
        cls._server.stop(0)

    def setup_method(self):
        clients.environment_variables.server_endpoint = self._server.endpoint

    def teardown_method(self):
        clients.environment_variables.server_endpoint = clients.NO_ENDPOINT

    def create_study(self, problem, study_id):
        config = vz.StudyConfig.from_problem(problem, vz.Algorithm.RANDOM_SEARCH)
        return clients.Study.from_study_config(config, owner="conformance-grpc",
                                               study_id=study_id)
