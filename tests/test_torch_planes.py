"""The serving runtime's opt-in planes on the CPU, held to the JAX package's.

- admission: the same ``decide``/``release`` script on one injected clock
  gives equal decisions, states, reasons, retry-after values, snapshots,
  counters and recorder events in both packages' controllers;
- the batch executor's fair share and lanes: the same queued slots with the
  same weights come out of ``_fair_order`` / ``_order_due`` in the same
  order, and ``_take_due`` / ``_next_deadline`` defer a speculative bucket
  behind live slots and flush it at its starvation cap, step for step as
  the JAX executor does, with the two-lane table and with three lanes;
- the SLO engine: the same metric sequence gives equal statuses, burn rates,
  gauges and breach dump keys;
- the flight recorder: the same calls give equal events, times aside;
- fleet dumps: each package's ``load_fleet_dir`` / ``fleet_report`` reads
  the other's dump directory to the same report;
- ``trial_states`` / ``trial_frontier``: equal in both packages' servicers,
  RAM and SQL stores;
- ``prometheus_text``: both runtimes, every plane armed, after the same
  script expose the same metric names and label sets;
- the admission gate through both packages' ``PythiaServicer``: the same
  shed errors and the same degraded, stamped response bytes.

The speculative engine's own cases are in ``tests/test_torch_speculative.py``.
"""

from __future__ import annotations

import json
import os
import re

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.observability import fleet as jfleet
from vizier_tpu.observability import flight_recorder as jrecorder
from vizier_tpu.observability import metrics as jmetrics
from vizier_tpu.observability import slo as jslo
from vizier_tpu.observability import tracing as jtracing
from vizier_tpu.parallel import batch_executor as jexecutor
from vizier_tpu.service import proto_converters as jpc
from vizier_tpu.service import vizier_service as jvizier_service
from vizier_tpu.service.protos import study_pb2 as jstudy_pb2
from vizier_tpu.service.protos import vizier_service_pb2 as jvizier_service_pb2
from vizier_tpu.serving import admission as jadmission
from vizier_tpu.serving import config as jserving_config
from vizier_tpu.serving import runtime as jruntime
from vizier_tpu.serving import speculative as jspeculative
from vizier_tpu.serving import stats as jstats
from vizier_tpu import pyvizier as jvz
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.observability import fleet
from vizier_tpu_torch.observability import flight_recorder
from vizier_tpu_torch.observability import metrics
from vizier_tpu_torch.observability import slo
from vizier_tpu_torch.observability import tracing
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.service import proto_converters as pc
from vizier_tpu_torch.service import vizier_service
from vizier_tpu_torch.service.protos import study_pb2
from vizier_tpu_torch.service.protos import vizier_service_pb2
from vizier_tpu_torch.serving import admission
from vizier_tpu_torch.serving import config as serving_config
from vizier_tpu_torch.serving import runtime
from vizier_tpu_torch.serving import speculative
from vizier_tpu_torch.serving import stats


class _Clock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def _strip_times(events):
    return [{k: v for k, v in e.items() if k != "time"} for e in events]


# -- admission -------------------------------------------------------------------

_ADMISSION_CONFIG = dict(enabled=True, max_inflight=3, tenant_inflight=2,
                         weights=(("a", 4.0), ("b", 0.5)), retry_after_ms=25.0,
                         window_s=2.0, min_decisions=4)

# Each step: ("decide", tenant, deadline_secs) | ("release", decision index)
# | ("advance", seconds).
_ADMISSION_SCRIPTS = {
    "caps": [("decide", "a", 0), ("decide", "a", 0), ("decide", "a", 0), ("decide", "b", 0),
             ("decide", "c", 0), ("release", 0), ("decide", "c", 0), ("release", 1),
             ("release", 3), ("advance", 3.0), ("decide", "b", 0), ("advance", 2.5),
             ("decide", "a", 0)],
    "degrade_and_recover": [("decide", "a", 0), ("decide", "a", 0), ("decide", "c", 0)]
    + [("decide", t, 0) for t in "bcbcb"]
    + [("decide", "b", 0), ("decide", "a", 0), ("release", 0), ("release", 1),
       ("release", 2), ("advance", 2.5), ("decide", "a", 0), ("release", 10),
       ("advance", 2.5), ("decide", "c", 0), ("advance", 2.5), ("decide", "b", 0),
       ("advance", 2.5), ("decide", "b", 0)],
    "deadline": [("decide", "a", 0.1), ("decide", "a", 30.0), ("decide", "b", 0.5),
                 ("decide", "b", 0), ("release", 1), ("decide", "a", 2.0)],
}


def _run_admission(adm, recorder_mod, metrics_mod, stats_mod, script):
    clock = _Clock()
    registry = metrics_mod.MetricsRegistry()
    recorder = recorder_mod.FlightRecorder()
    stats_sink = stats_mod.ServingStats(registry)
    controller = adm.AdmissionController(
        adm.AdmissionConfig(**_ADMISSION_CONFIG), stats=stats_sink, metrics=registry,
        recorder=recorder, compute_p50_fn=lambda: 0.4, queue_depth_fn=lambda: 8,
        time_fn=clock)
    decisions, trace = [], []
    for op, *args in script:
        if op == "decide":
            tenant, deadline = args
            decision = controller.decide(tenant, deadline_secs=deadline,
                                         study=f"owners/{tenant}/studies/s")
            decisions.append(decision)
            trace.append((decision.outcome, decision.tenant, decision.reason,
                          decision.retry_after_ms, decision.state, controller.state,
                          str(decision.error()) if decision.outcome == adm.SHED else ""))
        elif op == "release":
            controller.release(decisions[args[0]])
            trace.append(("release", controller.inflight()))
        else:
            clock.now += args[0]
    counters = {k: v for k, v in stats_sink.snapshot().items() if k.startswith("admission")}
    return (trace, controller.snapshot(), counters, _strip_times(recorder.events()),
            registry.prometheus_text())


@pytest.mark.parametrize("script", sorted(_ADMISSION_SCRIPTS))
def test_admission_decisions_equal_the_jax_packages(script):
    steps = _ADMISSION_SCRIPTS[script]
    ours = _run_admission(admission, flight_recorder, metrics, stats, steps)
    theirs = _run_admission(jadmission, jrecorder, jmetrics, jstats, steps)
    assert ours == theirs
    outcomes = {row[0] for row in ours[0]}
    assert "shed" in outcomes and "admit" in outcomes
    if script == "degrade_and_recover":
        assert "degrade" in outcomes
        assert [(t["from"], t["to"]) for t in ours[1]["transitions"]][:2] == [
            ("healthy", "shedding"), ("shedding", "degraded")]
        assert ours[1]["state"] == "healthy"


def test_admission_env_switches_mirror_the_jax_names(monkeypatch):
    assert not admission.AdmissionConfig.from_env().enabled
    monkeypatch.setenv("VIZIER_TORCH_ADMISSION", "1")
    monkeypatch.setenv("VIZIER_TORCH_ADMISSION_MAX_INFLIGHT", "5")
    monkeypatch.setenv("VIZIER_TORCH_ADMISSION_WEIGHTS", "prod:8,dev:1,bad")
    monkeypatch.setenv("VIZIER_ADMISSION", "0")
    cfg = admission.AdmissionConfig.from_env()
    assert cfg.enabled and cfg.max_inflight == 5 and cfg.weights == (("prod", 8.0), ("dev", 1.0))
    assert cfg.as_dict() == jadmission.AdmissionConfig(
        enabled=True, max_inflight=5, weights=(("prod", 8.0), ("dev", 1.0))).as_dict()
    assert admission.tenant_of("owners/prod/studies/s") == "prod"
    assert admission.tenant_of("studies/x") == jadmission.tenant_of("studies/x") == "default"


# -- the executor's fair share and lanes ---------------------------------------------


def _slots(mod, tenants, lane="live", now=0.0, start=0):
    return [mod._Slot(start + i, None, 1, now, None, lane=lane, tenant=t)
            for i, t in enumerate(tenants)]


def _fair_share_run(mod, adm):
    controller = adm.AdmissionController(adm.AdmissionConfig(
        enabled=True, weights=(("a", 3.0), ("b", 1.0), ("c", 2.5))))
    ex = mod.BatchExecutor(max_batch_size=4, admission=controller)
    rounds = [_slots(mod, "aaaaaabbbbcc"), _slots(mod, "bbbbbbba", start=20),
              _slots(mod, "cacacabbb", start=40), _slots(mod, "aaaa", start=60)]
    orders = [[(s.designer, s.tenant) for s in ex._fair_order(r)] for r in rounds]
    due = [("k1", _slots(mod, "aa", start=80), "full"), ("k2", _slots(mod, "b", start=90), "full"),
           ("k3", _slots(mod, "cc", start=95), "timeout")]
    ordered = [key for key, _, _ in ex._order_due(due)]
    again = [key for key, _, _ in ex._order_due(due)]
    ex.close()
    return orders, ordered, again, dict(ex._tenant_served)


def test_fair_order_equals_the_jax_executors():
    ours = _fair_share_run(batch_executor, admission)
    assert ours == _fair_share_run(jexecutor, jadmission)
    # Deficit round robin, not FIFO: the heavy tenant does not take the
    # whole first flush.
    assert [t for _, t in ours[0][0][:4]] != ["a"] * 4


def _lane_run(mod):
    clock = _Clock(0.0)
    ex = mod.BatchExecutor(max_batch_size=2, max_wait_ms=100.0, time_fn=clock)
    trace = []

    def step(t):
        clock.now = t
        depth = ex.queue_depth()
        due = ex._take_due()
        trace.append((t, depth, ex.live_pending(),
                      [(key, [s.designer for s in slots], reason) for key, slots, reason in due],
                      ex._next_deadline()))

    # A speculative bucket behind a live one: it waits out the live flush,
    # then flushes on the ordinary window once no live slot is queued.
    ex._queues["spec"] = _slots(mod, [None], lane="speculative", now=0.0)
    ex._queues["live"] = _slots(mod, [None], now=0.05, start=10)
    for t in (0.06, 0.12, 0.16, 0.16):
        step(t)
    # Live slots queued all along: the speculative bucket defers until its
    # starvation cap ("spec_starved"); a live slot arriving in a speculative
    # bucket makes it a live one.
    ex._queues["spec"] = _slots(mod, [None, None, None], lane="speculative", now=1.0, start=20)
    ex._queues["live"] = _slots(mod, [None], now=1.0, start=30)
    for t in (1.09, 1.2):
        step(t)
    ex._queues["live"] = _slots(mod, [None], now=1.2, start=40)
    for t in (1.26, 1.31):
        step(t)
    ex._queues["mixed"] = _slots(mod, [None], lane="speculative", now=2.0, start=50) + _slots(
        mod, [None], now=2.0, start=51)
    ex._queues["spec"] = _slots(mod, [None], lane="speculative", now=2.0, start=60)
    for t in (2.05, 2.11, 2.22):
        step(t)
    ex.close()
    return trace


def _three_lane_run(mod):
    """A batchwork lane between live and speculative: it defers to live slots
    up to its own cap, and the speculative lane defers to both."""
    clock = _Clock(0.0)
    lanes = [mod.LaneSpec("live", 0), mod.LaneSpec("batchwork", 1, True, 150.0),
             mod.LaneSpec("speculative", 2, True, 250.0)]
    ex = mod.BatchExecutor(max_batch_size=2, max_wait_ms=100.0, time_fn=clock, lanes=lanes)
    trace = []

    def step(t):
        clock.now = t
        depth = ex.queue_depth()
        due = ex._take_due()
        trace.append((t, depth, ex.live_pending(),
                      [(key, [s.designer for s in slots], reason) for key, slots, reason in due],
                      ex._next_deadline()))

    ex._queues["spec"] = _slots(mod, [None] * 3, lane="speculative", now=0.0)
    ex._queues["bulk"] = _slots(mod, [None], lane="batchwork", now=0.0, start=10)
    ex._queues["live"] = _slots(mod, [None], now=0.05, start=20)
    for t in (0.1, 0.16, 0.2, 0.27, 0.4):
        step(t)
    ex._queues["live"] = _slots(mod, [None], now=1.0, start=30)
    ex._queues["bulk"] = _slots(mod, [None], lane="batchwork", now=1.0, start=40)
    ex._queues["spec"] = _slots(mod, [None], lane="speculative", now=1.0, start=50)
    for t in (1.101, 1.12, 1.16):
        ex._queues["live"] = ex._queues.get("live") or _slots(mod, [None], now=t, start=60)
        step(t)
    ex._queues["mixed"] = _slots(mod, [None], lane="speculative", now=2.0, start=70) + _slots(
        mod, [None], lane="batchwork", now=2.0, start=71)
    ex._queues["live"] = _slots(mod, [None], now=2.0, start=80)
    for t in (2.11, 2.22, 2.5):
        step(t)
    ex.close()
    return trace


def test_three_lane_rules_equal_the_jax_executors():
    ours = _three_lane_run(batch_executor)
    assert ours == _three_lane_run(jexecutor)
    flushes = [(t, [(key, reason) for key, _, reason in due]) for t, _, _, due, _ in ours]
    assert ours[0][1] == {"live": 1, "batchwork": 1, "speculative": 3}
    # Live first; batchwork once no live slot is queued; speculative last.
    order = [key for _, due in flushes for key, _ in due]
    assert order.index("live") < order.index("bulk") < order.index("spec")
    # A batchwork slot makes the speculative slot's bucket a batchwork one.
    assert ("mixed", "full") in [f for _, due in flushes for f in due]


def test_lane_rules_equal_the_jax_executors():
    ours = _lane_run(batch_executor)
    assert ours == _lane_run(jexecutor)
    flushes = [(t, [(key, reason) for key, _, reason in due]) for t, _, _, due, _ in ours]
    assert flushes == [
        (0.06, []), (0.12, []), (0.16, [("live", "timeout")]), (0.16, [("spec", "timeout")]),
        # Live slots queued all along: the speculative bucket waits for its cap.
        (1.09, []), (1.2, [("live", "timeout")]),
        (1.26, [("spec", "full"), ("spec", "spec_starved")]), (1.31, [("live", "timeout")]),
        # A live slot makes its bucket live; the speculative-only one waits.
        (2.05, [("mixed", "full")]), (2.11, [("spec", "timeout")]), (2.22, [])]


# -- SLO engine ------------------------------------------------------------------------


def _slo_run(slo_mod, metrics_mod, recorder_mod, stats_mod, dump_dir):
    registry = metrics_mod.MetricsRegistry()
    serving = stats_mod.ServingStats(registry)
    latency = registry.histogram("vizier_suggest_latency_seconds")
    occupancy = registry.histogram("vizier_batch_occupancy",
                                   buckets=[1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64])
    flushes = registry.counter("vizier_batch_flushes")
    recorder = recorder_mod.FlightRecorder()
    recorder.record("owners/a/studies/s", "suggest", trace_id="t0")
    engine = slo_mod.SloEngine(slo_mod.SloConfig(
        enabled=True, windows=(10.0, 60.0), eval_interval_s=0.0, suggest_p99_ms=1000.0,
        min_samples=3, dump_dir=dump_dir, breach_cooldown_s=5.0), registry, recorder=recorder)
    out = []
    for now, (slow, fast, spec, sheds) in zip(
            (100.0, 104.0, 112.0, 130.0, 200.0),
            ((0, 4, (2, 1, 0), 0), (3, 2, (0, 2, 1), 2), (1, 6, (4, 0, 0), 0),
             (5, 0, (0, 0, 0), 6), (0, 0, (0, 0, 0), 0))):
        for i in range(slow):
            latency.observe(2.5 + 0.3 * i, trace_id=f"slow-{now}-{i}", hop="pythia")
        for i in range(fast):
            latency.observe(0.05 * (i + 1), trace_id=f"fast-{now}-{i}", hop="service",
                            tenant="a")
        serving.increment("speculative_hits", spec[0])
        serving.increment("speculative_misses", spec[1])
        serving.increment("speculative_stale", spec[2])
        serving.increment("admission_sheds", sheds)
        serving.increment("fallbacks", sheds // 2)
        occupancy.observe(1 + slow, bucket="b")
        flushes.inc(reason="timeout")
        statuses = engine.evaluate(now=now)
        out.append([s.as_dict() for s in statuses])
    dumps = []
    for path in engine.dumps:
        with open(path) as f:
            payload = json.load(f)
        dumps.append((os.path.basename(path), sorted(payload), payload["breaching"],
                      {hop: [e["trace_id"] for e in kept]
                       for hop, kept in payload["exemplars"].items()},
                      sorted(payload["flight_recorder"]), payload["config"]))
    slo_lines = sorted(line for line in registry.prometheus_text().splitlines()
                       if "vizier_slo_" in line)
    breaches = [e["attributes"]["slos"] for e in recorder.events("slo_breach")]
    return out, dumps, slo_lines, breaches


def test_slo_engine_equals_the_jax_packages(tmp_path):
    ours = _slo_run(slo, metrics, flight_recorder, stats, str(tmp_path / "port"))
    theirs = _slo_run(jslo, jmetrics, jrecorder, jstats, str(tmp_path / "jax"))
    assert ours[0] == theirs[0]
    # Dump file names carry the breach's UTC second: equal up to it.
    strip = lambda dumps: [(re.sub(r"-\d{8}T\d{6}-", "-", d[0]),) + d[1:5] + (  # noqa: E731
        {k: v for k, v in d[5].items() if k != "dump_dir"},) for d in dumps]
    assert strip(ours[1]) == strip(theirs[1])
    assert ours[2] == theirs[2] and ours[3] == theirs[3]
    assert ours[1], "the slow suggests must breach the p99 objective"
    breached = {s["slo"] for row in ours[0] for s in row if s["breached"]}
    assert "suggest_p99:pythia" in breached and "admission_shed_rate" in breached
    assert any(s["burn_rate"] is not None and s["burn_rate"] > 1 for row in ours[0] for s in row)


def test_slo_config_reads_the_ports_switches(monkeypatch):
    assert not slo.SloConfig.from_env().enabled
    monkeypatch.setenv("VIZIER_TORCH_SLO", "1")
    monkeypatch.setenv("VIZIER_TORCH_SLO_WINDOWS", "5, 30,bad")
    monkeypatch.setenv("VIZIER_TORCH_SLO_SUGGEST_P99_MS", "900")
    monkeypatch.setenv("VIZIER_SLO", "0")
    cfg = slo.SloConfig.from_env()
    assert cfg.enabled and cfg.windows == (5.0, 30.0) and cfg.suggest_p99_ms == 900.0
    assert slo.SloConfig().as_dict() == jslo.SloConfig().as_dict()


# -- flight recorder -----------------------------------------------------------------


def _recorder_run(recorder_mod, tracing_mod):
    rec = recorder_mod.FlightRecorder(ring_size=3, max_studies=2)
    tracer = tracing_mod.Tracer()
    rec.record("s1", "suggest", trace_id="t1", operation="op1", error=False)
    with tracer.span("x") as span:
        previous = tracing_mod.set_tracer(tracer)
        try:
            rec.record("s1", "complete", trial="s1/trials/1")
        finally:
            tracing_mod.set_tracer(previous)
        ambient = span.trace_id
    for i in range(3):
        rec.record("s2", "speculation", outcome="stored", n=i)
    rec.record(None, "batch_flush", bucket="b", occupancy=2, reason="full", members=["t1"])
    rec.record("s2", "fallback", reason="circuit_open", count=5)
    events = [dict(e, trace_id="<ambient>") if e.get("trace_id") == ambient else e
              for e in rec.events()]
    out = (_strip_times(events), rec.studies(), _strip_times(rec.ring("s2")),
           sorted(rec.snapshot()), rec.invalidate("s2"), rec.invalidate("s2"), rec.studies(),
           _strip_times(rec.events("batch_flush")))
    noop = recorder_mod.NOOP_RECORDER
    noop.record("s", "suggest")
    return out + ((noop.enabled, noop.events(), noop.snapshot(), noop.dump_json("/dev/null")),)


def test_flight_recorder_events_equal_the_jax_packages():
    ours = _recorder_run(flight_recorder, tracing)
    assert ours == _recorder_run(jrecorder, jtracing)
    assert ours[1] == ["<fleet>", "s2"]  # max_studies=2 evicted s1


def test_flight_recorder_switch(monkeypatch):
    previous = flight_recorder.set_recorder(None)
    try:
        assert not flight_recorder.get_recorder().enabled
        flight_recorder.set_recorder(None)
        monkeypatch.setenv("VIZIER_TORCH_FLIGHT_RECORDER", "1")
        monkeypatch.setenv("VIZIER_TORCH_FLIGHT_RECORDER_RING", "2")
        recorder = flight_recorder.get_recorder()
        assert recorder.enabled and recorder is flight_recorder.get_recorder()
        for i in range(3):
            recorder.record("s", "e", i=i)
        assert [e["attributes"]["i"] for e in recorder.ring("s")] == [1, 2]
        assert jrecorder.get_recorder() is not recorder
    finally:
        flight_recorder.set_recorder(previous)


# -- fleet dumps -----------------------------------------------------------------------


def _dump(recorder_mod, tracing_mod, metrics_mod, fleet_mod, out_dir, source, trace_ids):
    tracer = tracing_mod.Tracer()
    for i, trace_id in enumerate(trace_ids):
        parent = tracing_mod.parse_context(f"{trace_id}-{'0' * 15}{i}")
        with tracer.span("compute_tier.remote_suggest", parent=parent, frontend=source):
            pass
    registry = metrics_mod.MetricsRegistry()
    registry.gauge("vizier_slo_burn_rate").set(1.5, slo="suggest_p99:pythia", window="60s")
    registry.histogram("vizier_batch_occupancy", buckets=[1, 2, 4, 8]).observe(3, bucket="b")
    recorder = recorder_mod.FlightRecorder()
    recorder.record(None, "replica_failover", replica=source, successors=["r9"])
    recorder.record(None, "slo_breach", slos=["suggest_p99:pythia"])
    recorder.record("s", "suggest")
    return fleet_mod.dump_process(out_dir, source, tracer=tracer, registry=registry,
                                  recorder=recorder)


def _normalized(report):
    report = json.loads(json.dumps(report))
    for row in report["failover_timeline"]:
        row["time"] = 0.0
    return report


def test_fleet_dumps_cross_the_packages(tmp_path):
    out = str(tmp_path)
    ours = _dump(flight_recorder, tracing, metrics, fleet, out, "r1", ["aa" * 16, "bb" * 16])
    theirs = _dump(jrecorder, jtracing, jmetrics, jfleet, out, "r2", ["aa" * 16, "cc" * 16])
    assert sorted(ours) == sorted(theirs) == ["metrics", "recorder", "spans"]
    assert fleet.load_fleet_dir(out) == jfleet.load_fleet_dir(out)
    report = fleet.fleet_report(out)
    assert _normalized(report) == _normalized(jfleet.fleet_report(out))
    assert report["sources"] == ["r1", "r2"] and report["cross_replica_traces"] == 1
    assert report["compute_tier"]["fan_in"] == 2
    assert [row["kind"] for row in report["failover_timeline"]] == [
        "replica_failover", "slo_breach", "replica_failover", "slo_breach"]
    assert fleet.render_fleet_report(report) == jfleet.render_fleet_report(report)
    trace = "aa" * 16
    assert [s["source"] for s in fleet.merged_trace(out, trace)] == [
        s["source"] for s in jfleet.merged_trace(out, trace)]


# -- trial_states and trial_frontier -----------------------------------------------------


def _frontier_run(vz_mod, pc_mod, service_mod, study_pb, service_pb, database_url):
    servicer = service_mod.VizierServicer(database_url=database_url)
    config = vz_mod.StudyConfig(algorithm="RANDOM_SEARCH")
    config.search_space.root.add_float_param("x", 0.0, 1.0)
    config.metric_information.append(vz_mod.MetricInformation(name="y"))
    study = servicer.CreateStudy(service_pb.CreateStudyRequest(
        parent="owners/o", study=pc_mod.study_to_proto(config, "owners/o/studies/s")))
    for i in range(1, 8):
        trial = pc_mod.trial_to_proto(vz_mod.Trial(id=i, parameters={"x": i / 10}))
        servicer.CreateTrial(service_pb.CreateTrialRequest(parent=study.name, trial=trial))
    for i, kind in ((1, "measured"), (2, "infeasible"), (5, "measured")):
        request = service_pb.CompleteTrialRequest(name=f"{study.name}/trials/{i}")
        if kind == "measured":
            metric = request.final_measurement.metrics.add()
            metric.name, metric.value = "y", float(i)
        else:
            request.trial_infeasible, request.infeasible_reason = True, "bad"
        servicer.CompleteTrial(request)
    servicer.StopTrial(service_pb.StopTrialRequest(name=f"{study.name}/trials/6"))
    servicer.DeleteTrial(service_pb.DeleteTrialRequest(name=f"{study.name}/trials/7"))
    states = [(int(i), study_pb.Trial.State.Name(s))
              for i, s in servicer.datastore.trial_states(study.name)]
    return states, servicer.trial_frontier(study.name)


@pytest.mark.parametrize("store", ["ram", "sql"])
def test_trial_frontier_equals_the_jax_packages(store, tmp_path):
    urls = {p: None if store == "ram" else f"sqlite:///{tmp_path}/{p}.db" for p in ("j", "p")}
    ours = _frontier_run(vz, pc, vizier_service, study_pb2, vizier_service_pb2, urls["p"])
    theirs = _frontier_run(jvz, jpc, jvizier_service, jstudy_pb2, jvizier_service_pb2, urls["j"])
    assert ours == theirs
    completed, active, max_id = ours[1]
    assert completed == [1, 2, 5] and 3 in active and 6 not in active and max_id == 6


# -- prometheus_text ----------------------------------------------------------------------


def _label_sets(text):
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample = line.rsplit(" ", 1)[0]
        out.add(sample)
    return out


def _runtime_script(runtime_mod, config_mod, spec_mod, slo_mod, adm, recorder_mod):
    recorder = recorder_mod.FlightRecorder()
    previous = recorder_mod.set_recorder(recorder)
    try:
        rt = runtime_mod.ServingRuntime(
            config_mod.ServingConfig(),
            speculative=spec_mod.SpeculativeConfig(speculative=True),
            slo=slo_mod.SloConfig(enabled=True, eval_interval_s=0.0, windows=(60.0,)),
            admission=adm.AdmissionConfig(enabled=True, max_inflight=1))
    finally:
        recorder_mod.set_recorder(previous)
    try:
        rt.observe_suggest_latency("pythia", 0.4, trace_id="t1")
        rt.observe_suggest_latency("service", 0.5, trace_id="t1", tenant="a")
        first = rt.admission.decide("a", study="owners/a/studies/s")
        rt.admission.decide("b", study="owners/b/studies/s")
        rt.admission.release(first)
        engine = rt.speculative_engine
        engine.try_serve("owners/a/studies/s", 1, spec_mod.make_fingerprint(b"c", [], []))
        engine.observe_suggest_latency("miss", 0.01)
        rt.designer_cache.get_or_create("owners/a/studies/s", lambda: object())
        rt.breakers.get("owners/a/studies/s").record_failure()
        report = rt.slo_report()
        text = rt.prometheus_text()
        snapshot = rt.admission_snapshot()
    finally:
        rt.shutdown()
    return _label_sets(text), sorted(s["slo"] for s in report["statuses"]), snapshot


def test_prometheus_text_names_and_labels_equal_the_jax_packages():
    ours = _runtime_script(runtime, serving_config, speculative, slo, admission, flight_recorder)
    theirs = _runtime_script(jruntime, jserving_config, jspeculative, jslo, jadmission, jrecorder)
    assert ours[0] == theirs[0]
    assert ours[1:] == theirs[1:]
    names = {sample.split("{")[0] for sample in ours[0]}
    for name in ("vizier_slo_value", "vizier_slo_breached", "vizier_admission_decisions_total",
                 "vizier_admission_state", "vizier_speculative_events_total",
                 "vizier_speculative_suggest_latency_seconds_count",
                 "vizier_serving_admission_sheds_total"):
        assert name in names, name


def test_runtime_with_every_plane_off_builds_none_of_them():
    rt = runtime.ServingRuntime(serving_config.ServingConfig())
    assert rt.admission is None and rt.speculative_engine is None and rt.slo_engine is None
    assert not rt.flight_recorder.enabled and rt.batch_executor._admission is None
    assert rt.slo_report() == {"armed": False} and rt.admission_snapshot() == {"enabled": False}
    assert rt.bind_speculative(None, None, None) is False
    calls = []
    out = rt.admitted_suggest("owners/a/studies/s", lambda: calls.append(1) or "live", None)
    assert out == "live" and calls == [1]
    out = rt.speculative_suggest("s", 1, None, lambda: "live", None, None)
    assert out == "live"
    rt.shutdown()


# -- the admission gate through the Pythia servicers --------------------------------------


def _gated_pythia_run(vz_mod, pc_mod, pythia_mod, pb, adm, policy_mod, broken_low=False, **kw):
    """While tenant a's policy computes, the servicer is asked for tenants b,
    b and low: two sheds escalate to DEGRADED and low is degraded.
    ``broken_low`` gives low's request a config that fails to parse."""
    config = vz_mod.StudyConfig(algorithm="DEFAULT")
    config.search_space.root.add_float_param("x", 0.0, 1.0)
    config.search_space.root.add_categorical_param("c", ["u", "v"])
    config.metric_information.append(vz_mod.MetricInformation(name="y"))

    def request(tenant):
        name = f"owners/{tenant}/studies/s"
        out = pb.PythiaSuggestRequest(count=2, study_name=name)
        out.study_descriptor.config.CopyFrom(pc_mod.study_config_to_proto(config))
        out.study_descriptor.guid = name
        out.study_descriptor.max_trial_id = 3
        if broken_low and tenant == "low":
            out.study_descriptor.config.parameters.add(name="z")  # no domain
        return out

    inner = []
    holder = {}

    class _Policy:
        should_be_cached = False

        def suggest(self, req):
            for tenant in ("b", "b", "low"):
                inner.append(holder["pythia"].Suggest(request(tenant)))
            return policy_mod.SuggestDecision(suggestions=[vz_mod.TrialSuggestion({"x": 0.25, "c": "u"})])

    pythia = pythia_mod.PythiaServicer(
        None, lambda *a: _Policy(),
        admission_config=adm.AdmissionConfig(enabled=True, max_inflight=1, min_decisions=2,
                                             weights=(("low", 0.5),)), **kw)
    holder["pythia"] = pythia
    try:
        outer = pythia.Suggest(request("a"))
        snapshot = pythia.serving_runtime.admission_snapshot()
        counters = {k: v for k, v in pythia.serving_stats().items()
                    if k.startswith(("admission", "fallbacks", "breaker", "designer"))}
    finally:
        pythia.shutdown()
    for response in [outer] + inner:
        for suggestion in response.suggestions:
            suggestion.ClearField("creation_time_secs")
    return ([r.SerializeToString(deterministic=True) for r in [outer] + inner], snapshot,
            counters)


def test_the_servicers_admission_gate_equals_the_jax_packages():
    from vizier_tpu.pythia import policy as jpolicy
    from vizier_tpu.service import pythia_service as jpythia_service
    from vizier_tpu.service.protos import pythia_service_pb2 as jpb
    from vizier_tpu_torch.pythia import policy as policy_lib
    from vizier_tpu_torch.service import pythia_service
    from vizier_tpu_torch.service.protos import pythia_service_pb2 as pb

    ours = _gated_pythia_run(vz, pc, pythia_service, pb, admission, policy_lib, device="cpu")
    theirs = _gated_pythia_run(jvz, jpc, jpythia_service, jpb, jadmission, jpolicy)
    assert ours == theirs
    responses = [pb.PythiaSuggestResponse.FromString(b) for b in ours[0]]
    assert not responses[0].error and len(responses[0].suggestions) == 1
    assert all("RESOURCE_EXHAUSTED" in r.error and "retry_after_ms=50" in r.error
               for r in responses[1:3])
    assert not responses[3].error and len(responses[3].suggestions) == 2
    assert ours[1]["state"] == "degraded" and ours[2]["admission_degraded"] == 1
    assert ours[2]["breaker_short_circuits"] == 0 and ours[2]["designer_failures"] == 0


def test_a_degraded_request_with_a_broken_config_fails_as_in_the_jax_package():
    """Under DEGRADE, a config that fails to parse completes the op with the
    permanent parse error in both packages, not a transient fallback
    failure that clients would retry."""
    from vizier_tpu.pythia import policy as jpolicy
    from vizier_tpu.service import pythia_service as jpythia_service
    from vizier_tpu.service.protos import pythia_service_pb2 as jpb
    from vizier_tpu_torch.pythia import policy as policy_lib
    from vizier_tpu_torch.reliability import errors
    from vizier_tpu_torch.service import pythia_service
    from vizier_tpu_torch.service.protos import pythia_service_pb2 as pb

    ours = _gated_pythia_run(vz, pc, pythia_service, pb, admission, policy_lib, broken_low=True,
                             device="cpu")
    theirs = _gated_pythia_run(jvz, jpc, jpythia_service, jpb, jadmission, jpolicy,
                               broken_low=True)
    assert ours == theirs
    degraded = pb.PythiaSuggestResponse.FromString(ours[0][3])
    assert "has no domain" in degraded.error and not degraded.suggestions
    assert degraded.error.startswith("ValueError") and not errors.has_transient_marker(
        degraded.error)
    assert ours[1]["state"] == "degraded" and ours[2].get("fallbacks", 0) == 0
