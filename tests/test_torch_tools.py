"""The repository's tools on the port, held to the JAX tools on the CPU.

``vizier_tpu_torch/tools/`` holds the counterparts of the JAX package's
``tools/obs_report.py``, ``profile_e2e.py``, ``warm_start_ab.py`` and
``surrogate_ab.py``. The JAX tools are loaded as
``tests/observability/test_obs_report.py`` loads them (``tools/`` on
``sys.path``, JAX on the CPU).

- obs_report: every case of ``tests/observability/test_obs_report.py`` on
  the port's tool and the port's tracer, metrics, SLO engine, recorder and
  fleet dump; then both tools on the same files (a span file from each
  package's tracer, a metrics snapshot from each package's registry, a soak
  report from each package's mini-soak, a fleet dump directory from each
  package) give equal ``--json`` reports and equal ``--trace`` trees.
- profile_e2e at 40 trials x 3-D, 500 evaluations, batch 2: the JSON line
  has the JAX tool's row names and the stages sum to no more than the total.
- warm_start_ab and surrogate_ab (both designers) at a tiny size through both
  packages' command lines: the report keys and the configuration echoes are
  equal, ``rank_sum_p`` is equal on the same arrays, the port's bit-identity
  checks pass.
- No port tool writes a file unless given ``--out``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.loadgen import driver as jdriver
from vizier_tpu.loadgen import models as jmodels
from vizier_tpu.loadgen import report as jreport
from vizier_tpu.observability import fleet as jfleet
from vizier_tpu.observability import flight_recorder as jrecorder
from vizier_tpu.observability import metrics as jmetrics
from vizier_tpu.observability import slo as jslo
from vizier_tpu.observability import tracing as jtracing
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.compute.ir import BucketKey
from vizier_tpu_torch.loadgen import driver
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.loadgen import report
from vizier_tpu_torch.observability import fleet as fleet_lib
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import slo as slo_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.parallel.mesh import MeshConfig
from vizier_tpu_torch.tools import obs_report
from vizier_tpu_torch.tools import profile_e2e
from vizier_tpu_torch.tools import surrogate_ab
from vizier_tpu_torch.tools import warm_start_ab

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "tools"))
import obs_report as jobs_report  # noqa: E402  (tools/ is not a package)
import surrogate_ab as jsurrogate_ab  # noqa: E402
import warm_start_ab as jwarm_start_ab  # noqa: E402

# Each package's observability modules, by package.
_OBS = {
    "jax": dict(tracing=jtracing, metrics=jmetrics, slo=jslo, recorder=jrecorder,
                fleet=jfleet),
    "torch": dict(tracing=tracing_lib, metrics=metrics_lib, slo=slo_lib,
                  recorder=recorder_lib, fleet=fleet_lib),
}


def _trace_file(tmp_path, package="torch", name="spans.jsonl") -> str:
    tracer = _OBS[package]["tracing"].Tracer()
    for _ in range(3):
        with tracer.span("client.suggest"):
            with tracer.span("designer.suggest"):
                pass
    path = tmp_path / name
    tracer.dump_jsonl(str(path))
    return str(path)


def _armed_registry(package="torch"):
    """A registry that has been through one real SLO evaluation."""
    obs = _OBS[package]
    registry = obs["metrics"].MetricsRegistry()
    hist = registry.histogram("vizier_suggest_latency_seconds")
    for _ in range(9):
        hist.observe(0.001, hop="pythia")
    hist.observe(0.9, trace_id="t-slow", hop="pythia")
    engine = obs["slo"].SloEngine(
        obs["slo"].SloConfig(enabled=True, windows=(5.0,), min_samples=1, suggest_p99_ms=25.0),
        registry,
        recorder=obs["recorder"].FlightRecorder(),
    )
    engine.evaluate()
    return registry


def _dump_dir(tmp_path, package="torch") -> str:
    obs = _OBS[package]
    for source, spans in {
        "client": [
            {"name": "client.suggest", "trace_id": "t1", "span_id": "c",
             "parent_id": None, "start_time": 1.0, "duration_secs": 0.2},
        ],
        "replica-0": [
            {"name": "service.suggest_trials", "trace_id": "t1",
             "span_id": "s", "parent_id": "c", "start_time": 1.1,
             "duration_secs": 0.1},
        ],
    }.items():
        obs["fleet"].write_spans(str(tmp_path), source, spans)
    recorder = obs["recorder"].FlightRecorder()
    recorder.record(None, "replica_failover", replica="replica-0", successors=["replica-1"])
    recorder.dump_json(str(tmp_path / ("fleet" + obs["fleet"].RECORDER_SUFFIX)))
    return str(tmp_path)


def _run_main(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _run_jax_obs_report(argv, monkeypatch) -> str:
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["obs_report.py", *argv])
    with contextlib.redirect_stdout(out):
        jobs_report.main()
    return out.getvalue()


# -- tests/observability/test_obs_report.py on the port's tool ----------------------------


def test_dump_then_load(tmp_path):
    spans = obs_report.load_spans(_trace_file(tmp_path))
    assert len(spans) == 6
    assert {s["name"] for s in spans} == {"client.suggest", "designer.suggest"}
    for span in spans:
        assert span["duration_secs"] > 0
        assert span["trace_id"] and span["span_id"]


def test_corrupt_lines_skipped(tmp_path):
    path = tmp_path / "bad.jsonl"
    good = json.dumps({"name": "x", "trace_id": "t", "span_id": "s", "duration_secs": 0.1})
    path.write_text(f"{good}\nnot json at all\n\n{good}\n")
    assert len(obs_report.load_spans(str(path))) == 2


def test_phase_table(tmp_path):
    rows = obs_report.phase_breakdown(obs_report.load_spans(_trace_file(tmp_path)))
    by_phase = {r["phase"]: r for r in rows}
    assert by_phase["client.suggest"]["count"] == 3
    row = by_phase["designer.suggest"]
    assert 0 < row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"] <= row["max_ms"]
    assert by_phase["client.suggest"]["total_ms"] >= by_phase["designer.suggest"]["total_ms"]
    table = obs_report.render_table(rows)
    assert "client.suggest" in table and "p99 ms" in table


def test_exact_percentiles():
    (row,) = obs_report.phase_breakdown(
        [{"name": "p", "duration_secs": v / 1000.0} for v in range(1, 101)])
    assert row["p50_ms"] == 50.5
    assert row["max_ms"] == 100.0


def test_trace_tree(tmp_path):
    spans = obs_report.load_spans(_trace_file(tmp_path))
    trace_id = spans[0]["trace_id"]
    lines = obs_report.render_trace(spans, trace_id).splitlines()
    assert lines[0] == f"trace {trace_id}"
    assert any(line.startswith("  client.suggest") for line in lines)
    assert any(line.startswith("    designer.suggest") for line in lines)


def test_trace_tree_missing(tmp_path):
    spans = obs_report.load_spans(_trace_file(tmp_path))
    assert "No spans" in obs_report.render_trace(spans, "nope")


def _named(names):
    return [{"name": n, "duration_secs": 0.01} for n in names]


@pytest.mark.parametrize("names, expected", [
    (["gp_bandit.train_gp", "gp_ucb_pe.train_gp", "other"],
     {"mode": "exact", "exact": 2, "sparse": 0}),
    (["sparse_gp.train", "sparse_gp.acquisition"], {"mode": "sparse", "exact": 0, "sparse": 2}),
    (["sparse_gp.train", "gp_bandit.train_gp"], {"mode": "mixed", "exact": 1, "sparse": 1}),
    (["rpc"], {"mode": "none", "exact": 0, "sparse": 0}),
])
def test_surrogate_activity(names, expected):
    assert obs_report.surrogate_activity(_named(names)) == expected


def test_the_phase_families_come_from_the_ports_registry():
    """Every registered program's device phase classifies by its declared
    surrogate family, and its batched phase maps back to its kind."""
    from vizier_tpu_torch.compute import registry

    sparse, exact, kinds = obs_report._phase_families()
    for program in registry.programs():
        family = sparse if program.surrogate_family == "sparse" else exact
        assert program.device_phase.split(".")[0] + "." in family
        assert kinds["jax." + program.device_phase] == program.kind
    assert {p.kind: p.surrogate_family for p in registry.programs()
            if p.kind.startswith("gp_")} == {
        "gp_bandit": "exact", "gp_bandit_sparse": "sparse",
        "gp_ucb_pe": "exact", "gp_ucb_pe_sparse": "sparse"}
    flushes = obs_report.program_kind_activity(
        _named(["jax.sparse_gp.ucb_pe_suggest_batched", "jax.gp_ucb_pe.suggest_batched",
                "jax.gp_ucb_pe.suggest_batched", "jax.gp_ucb_pe.train_gp"]))
    assert {k: v["flushes"] for k, v in flushes.items()} == {
        "gp_ucb_pe_sparse": 1, "gp_ucb_pe": 2}


def _speculative_spans():
    return [
        {"name": "pythia.suggest", "duration_secs": 0.001,
         "events": [{"name": "speculative.hit", "attributes": {}}]},
        {"name": "pythia.suggest", "duration_secs": 0.8,
         "events": [{"name": "speculative.miss", "attributes": {}}]},
        {"name": "pythia.suggest", "duration_secs": 0.9,
         "events": [{"name": "speculative.stale", "attributes": {}}]},
        {"name": "speculative.precompute", "duration_secs": 0.7,
         "attributes": {"outcome": "stored"}},
        {"name": "speculative.precompute", "duration_secs": 0.7,
         "attributes": {"outcome": "superseded"}},
    ]


def test_counts_serve_events_and_precompute_spans():
    act = obs_report.speculative_activity(_speculative_spans())
    assert act["hit"] == 1 and act["miss"] == 1 and act["stale"] == 1
    assert act["precomputes"] == 2 and act["stored"] == 1
    assert act["hit_rate"] == round(1 / 3, 4)


def test_no_speculative_activity_is_all_zero():
    act = obs_report.speculative_activity([{"name": "pythia.suggest", "duration_secs": 0.1}])
    assert act["hit"] == act["miss"] == act["precomputes"] == 0
    assert act["hit_rate"] == 0.0


def test_slo_round_trip_from_fresh_metrics_dump(tmp_path):
    path = tmp_path / "metrics.json"
    path.write_text(_armed_registry().dump_json())
    slo = obs_report.slo_activity(obs_report.load_metrics(str(path)))
    assert slo["armed"] is True
    assert slo["evaluations"] == 1
    assert "suggest_p99:pythia" in slo["breached"]
    assert slo["burn_rates"]["suggest_p99:pythia"]["5s"] >= 5.0
    assert slo["values"]["suggest_p99:pythia"]["5s"] > 0.025
    rendered = obs_report.render_slo(slo)
    assert "BREACHED" in rendered and "suggest_p99:pythia" in rendered


def test_unarmed_dump(tmp_path):
    registry = metrics_lib.MetricsRegistry()
    registry.counter("vizier_serving_fallbacks").inc()
    path = tmp_path / "metrics.json"
    path.write_text(registry.dump_json())
    slo = obs_report.slo_activity(obs_report.load_metrics(str(path)))
    assert slo["armed"] is False and slo["breached"] == []
    assert "not armed" in obs_report.render_slo(slo)


def test_label_parser():
    labels = obs_report._parse_label_str('{slo="suggest_p99:pythia",window="60s"}')
    assert labels == {"slo": "suggest_p99:pythia", "window": "60s"}


def test_fleet_section_from_fresh_dump(tmp_path):
    section = obs_report.fleet_section(_dump_dir(tmp_path))
    assert section["sources"] == ["client", "replica-0"]
    assert section["cross_replica_traces"] == 1
    assert section["failover_timeline"][0]["kind"] == "replica_failover"


def test_json_report_schema_is_stable(tmp_path):
    """The --json contract: device_activity, speculative_activity, slo and
    fleet sections all parse from freshly dumped span and metric files."""
    span_path = _trace_file(tmp_path)
    metrics_path = tmp_path / "metrics.json"
    metrics_path.write_text(_armed_registry().dump_json())
    (tmp_path / "fleet").mkdir()
    dump_dir = _dump_dir(tmp_path / "fleet")
    out = _run_main(obs_report.main, [span_path, "--json", "--slo", str(metrics_path),
                                      "--fleet", dump_dir])
    report_ = json.loads(out)
    assert {"spans", "surrogate_activity", "speculative_activity", "program_kind_activity",
            "device_activity", "slo", "fleet", "phases"} <= set(report_)
    assert report_["spans"] == 6
    assert report_["slo"]["armed"] is True
    assert report_["slo"]["burn_rates"]["suggest_p99:pythia"]["5s"] >= 5.0
    assert report_["fleet"]["cross_replica_traces"] == 1
    assert report_["device_activity"] == {}
    assert report_["speculative_activity"]["hit"] == 0


def test_json_report_without_slo_or_fleet_keeps_keys(tmp_path):
    report_ = json.loads(_run_main(obs_report.main, [_trace_file(tmp_path), "--json"]))
    assert report_["slo"] is None and report_["fleet"] is None


def _flush_span(device=None, occupancy=2, duration=0.01):
    attrs = {"bucket": "gp_ucb_pe/t16/f4x0/m1/q1", "occupancy": occupancy}
    if device is not None:
        attrs["device"] = device
    return {"name": "batch_executor.flush", "duration_secs": duration, "attributes": attrs}


def test_per_device_breakdown():
    spans = [
        _flush_span("mesh0", occupancy=2, duration=0.010),
        _flush_span("mesh0", occupancy=4, duration=0.030),
        _flush_span("mesh1", occupancy=1, duration=0.020),
        {"name": "pythia.suggest", "duration_secs": 0.5},
    ]
    out = obs_report.device_activity(spans)
    assert set(out) == {"mesh0", "mesh1"}
    assert out["mesh0"]["flushes"] == 2
    assert out["mesh0"]["busy_ms"] == 40.0
    assert out["mesh0"]["mean_occupancy"] == 3.0
    assert out["mesh1"]["flushes"] == 1


def test_single_device_run_is_empty():
    assert obs_report.device_activity([_flush_span(device=None) for _ in range(3)]) == {}


class _StubDesigner:
    """The JAX executor tests' stub: the batch hooks with trivial arithmetic."""

    def __init__(self, value):
        self.value = value

    def suggest(self, count=1):
        return [vz.TrialSuggestion(parameters={"x": float(self.value)})] * (count or 1)

    def batch_bucket_key(self, count=1):
        return BucketKey(kind="stub", pad_trials=8, cont_width=1, cat_width=0,
                         metric_count=1, count=count or 1, statics=("g",))

    def batch_prepare(self, count=1):
        return dict(designer=self, count=count or 1, value=self.value)

    def batch_execute(self, items, pad_to=None):
        return [dict(value=item["value"]) for item in items]

    def batch_finalize(self, item, output):
        return [vz.TrialSuggestion(parameters={"x": float(output["value"])})] * item["count"]


def test_live_mesh_flush_spans_carry_device(tmp_path):
    """End to end: a real mesh-executor flush emits a device-attributed span
    the report rolls up."""
    tracer = tracing_lib.Tracer()
    previous = tracing_lib.set_tracer(tracer)
    try:
        executor = BatchExecutor(max_batch_size=4, max_wait_ms=5.0,
                                 mesh=MeshConfig(enabled=True, shard_devices=1), device="cpu")
        errors = []
        try:
            def run(designer):
                try:
                    executor.suggest(designer, 1)
                except Exception as e:  # noqa: BLE001 - the test reads it
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(_StubDesigner(i),)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors and not any(t.is_alive() for t in threads)
        finally:
            executor.close()
        path = tmp_path / "mesh_spans.jsonl"
        tracer.dump_jsonl(str(path))
    finally:
        tracing_lib.set_tracer(previous)
    out = obs_report.device_activity(obs_report.load_spans(str(path)))
    assert out, "no device-attributed flush spans recorded"
    assert all(device.startswith("mesh") for device in out)


# -- both span reports on both packages' files ------------------------------------------


def _rich_trace_file(tmp_path, package: str) -> str:
    """Spans of every section the report reads, through ``package``'s tracer:
    a request tree, device phases of both surrogate families and a batched
    flush, mesh flushes with their device, speculative outcomes."""
    tracer = _OBS[package]["tracing"].Tracer()
    for i in range(3):
        with tracer.span("pythia.suggest") as span:
            span.add_event(("speculative.hit", "speculative.miss", "speculative.stale")[i])
            with tracer.span("jax.gp_ucb_pe.train_gp", jax_phase="gp_ucb_pe.train_gp"):
                pass
            with tracer.span("jax.sparse_gp.ucb_pe_acquisition"):
                pass
            with tracer.span("jax.gp_ucb_pe.suggest_batched"):
                pass
            with tracer.span("batch_executor.flush", device=f"mesh{i % 2}", occupancy=i + 1,
                             bucket="gp_ucb_pe/t16/f4x0/m1/q1"):
                pass
    with tracer.span("speculative.precompute", outcome="stored"):
        pass
    path = tmp_path / f"{package}-spans.jsonl"
    tracer.dump_jsonl(str(path))
    return str(path)


def _mini_soak_report(tmp_path, package: str) -> str:
    """A soak report from ``package``'s loadgen: four host-only studies on one
    replica with batching and the SLO plane armed."""
    mods = (models, driver, report) if package == "torch" else (jmodels, jdriver, jreport)
    models_, driver_, report_ = mods
    scenario = models_.build_scenario(models_.smoke_config(
        num_studies=4, replicas=1, kind_mix=(("random", 1.0), ("quasi_random", 1.0)),
        planes=models_.PlaneConfig(batching=True, speculative=False, mesh=False, slo=True)))
    kwargs = dict(device="cpu") if package == "torch" else {}
    built = report_.build_report(scenario, driver_.run(scenario, **kwargs))
    path = tmp_path / f"{package}-soak.json"
    path.write_text(json.dumps(built))
    return str(path)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_both_span_reports_are_equal_on_each_packages_files(tmp_path, monkeypatch, package):
    """The JAX tool and the port's on the same span, metrics, soak and fleet
    files: the same ``--json`` report, the same trace tree, the same text."""
    spans = _rich_trace_file(tmp_path, package)
    metrics_path = tmp_path / f"{package}-metrics.json"
    metrics_path.write_text(_armed_registry(package).dump_json())
    soak = _mini_soak_report(tmp_path, package)
    (tmp_path / "fleet").mkdir()
    dump_dir = _dump_dir(tmp_path / "fleet", package)
    argv = [spans, "--slo", str(metrics_path), "--soak", soak, "--fleet", dump_dir]
    port = json.loads(_run_main(obs_report.main, argv + ["--json"]))
    jax_ = json.loads(_run_jax_obs_report(argv + ["--json"], monkeypatch))
    assert port == jax_
    assert port["spans"] == 16 and port["surrogate_activity"]["mode"] == "mixed"
    assert port["program_kind_activity"]["gp_ucb_pe"]["flushes"] == 3
    assert set(port["device_activity"]) == {"mesh0", "mesh1"}
    assert port["speculative_activity"]["hit"] == 1
    assert port["slo"]["armed"] and port["soak"]["by_kind"] and port["fleet"]["spans"] == 2
    assert _run_main(obs_report.main, argv) == _run_jax_obs_report(argv, monkeypatch)
    only = ["--slo", str(metrics_path), "--soak", soak, "--fleet", dump_dir]
    assert _run_main(obs_report.main, only) == _run_jax_obs_report(only, monkeypatch)
    trace_id = obs_report.load_spans(spans)[0]["trace_id"]
    tree = _run_main(obs_report.main, [spans, "--trace", trace_id])
    assert tree == _run_jax_obs_report([spans, "--trace", trace_id], monkeypatch)
    assert len(tree.splitlines()) == 6


# -- profile_e2e -------------------------------------------------------------------------


def _jax_row_names() -> set:
    """The stage rows the JAX tool prints, read from its source: the keys it
    stores into ``stage`` and its ``(other/untimed)`` row."""
    tree = ast.parse((_ROOT / "tools" / "profile_e2e.py").read_text())
    names = {node.slice.value for node in ast.walk(tree)
             if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
             and node.value.id == "stage" and isinstance(node.slice, ast.Constant)}
    names |= {node.value for node in ast.walk(tree)
              if isinstance(node, ast.Constant) and node.value == "(other/untimed)"}
    return names


def test_profile_e2e_reports_the_jax_tools_rows_within_the_total(tmp_path, monkeypatch):
    """40 trials x 3-D, 500 evaluations, batch 2, one repeat on the CPU: the
    JSON line's stages are the JAX tool's rows ("suggest_batch(jit)" is the
    port's "suggest_batch": nothing is jitted), the top-level stages sum to
    no more than the total, the train and sweep ran, and the device phases
    that the stages hold came in the execute mode with no event time."""
    monkeypatch.chdir(tmp_path)
    out = _run_main(profile_e2e.main, ["--trials", "40", "--dim", "3", "--evals", "500",
                                       "--batch", "2", "--repeats", "1", "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []
    lines = out.splitlines()
    line = json.loads(lines[-1])["profile_e2e"]
    assert lines[-2].startswith("p50 total: ")
    (rep,) = line["repeats"]
    jax_rows = {name.replace("suggest_batch(jit)", "suggest_batch") for name in _jax_row_names()}
    assert set(rep["stages_ms"]) == jax_rows
    top = sum(rep["stages_ms"][k] for k in profile_e2e.TOP_LEVEL)
    assert top <= rep["total_ms"]
    assert top + rep["stages_ms"]["(other/untimed)"] == pytest.approx(rep["total_ms"])
    nested = sum(rep["stages_ms"][k] for k in profile_e2e.NESTED)
    assert 0 < nested <= rep["stages_ms"][profile_e2e.TRAIN]
    assert all(rep["stages_ms"][k] > 0 for k in profile_e2e.TOP_LEVEL)
    assert {name: (e["stage"], e["mode"], e["event_ms"]) for name, e in rep["events"].items()} == {
        "gp_ucb_pe.train_gp": (profile_e2e.TRAIN, "execute", None),
        "gp_ucb_pe.acquisition": ("suggest_batch", "execute", None)}
    for event in rep["events"].values():
        assert event["host_ms"] <= rep["stages_ms"][event["stage"]]
    assert line["config"] == dict(trials=40, dim=3, evals=500, batch=2, repeats=1)
    assert line["device"] == "cpu" and line["suggests"] == 2
    assert line["p50_total_ms"] == rep["total_ms"]


# -- warm_start_ab and surrogate_ab ------------------------------------------------------

# Small enough for the CPU, shaped so the JAX tools compile as few programs as
# they can: the latency arms' 5 trials and the parity runs' first GP suggest
# (after 5 seed trials) share one padded layout.
_SIZES = ["--trials", "5", "--dim", "2", "--evals", "100", "--batch", "2", "--repeats", "1",
          "--parity-trials", "10", "--parity-batch", "5", "--parity-evals", "100",
          "--parity-seeds", "1", "2"]
_SURROGATE_SIZES = [
    "--trials", "5", "--dim", "2", "--evals", "100", "--batch", "2", "--inducing", "4",
    "--exact-repeats", "1", "--sparse-repeats", "1", "--parity-trials", "10",
    "--parity-batch", "5", "--parity-dim", "2", "--parity-evals", "100",
    "--parity-inducing", "4", "--parity-seeds", "1", "2"]


def _jax_report(module, argv, tmp_path, monkeypatch) -> dict:
    out = tmp_path / "jax_report.json"
    monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv, "--out", str(out)])
    with contextlib.redirect_stdout(io.StringIO()):
        module.main()
    return json.loads(out.read_text())


def _port_report(module, argv, tmp_path, monkeypatch) -> dict:
    """The port tool's report from its printed line, run without ``--out`` in
    an empty directory that must stay empty."""
    cwd = tmp_path / "port_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = _run_main(module.main, [*argv, "--device", "cpu"])
    assert list(cwd.iterdir()) == [], "the tool wrote a file without --out"
    return json.loads(out.splitlines()[-1])


def _keys(tree):
    """The nested key structure of a report, without its values."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _assert_same_report_shape(port: dict, jax_: dict):
    assert _keys(port) == _keys(jax_)
    for section in ("latency", "parity"):
        assert port[section]["config"] == jax_[section]["config"]
        for name in port[section]:
            assert isinstance(port[section][name], type(jax_[section][name])), name
    assert port["backend"] == "cpu" == jax_["backend"]


def test_warm_start_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch):
    jax_ = _jax_report(jwarm_start_ab, _SIZES, tmp_path, monkeypatch)
    port = _port_report(warm_start_ab, _SIZES, tmp_path, monkeypatch)
    _assert_same_report_shape(port, jax_)
    assert len(port["latency"]["cold_suggest_ms"]) == len(port["latency"]["warm_suggest_ms"]) == 1
    assert len(port["parity"]["warm_final_regrets"]) == 2


@pytest.mark.parametrize("designer", ["gp_bandit", "ucb_pe"])
def test_surrogate_ab_reports_what_the_jax_tool_reports(tmp_path, monkeypatch, designer):
    argv = ["--designer", designer, *_SURROGATE_SIZES]
    jax_ = _jax_report(jsurrogate_ab, argv, tmp_path, monkeypatch)
    port = _port_report(surrogate_ab, argv, tmp_path, monkeypatch)
    _assert_same_report_shape(port, jax_)
    assert port["designer"] == designer
    assert port["surrogates_env_config"] == jax_["surrogates_env_config"]
    assert port["off_switch"] == {"off_bit_identical": True}
    assert jax_["off_switch"] == {"off_bit_identical": True}


def test_rank_sum_p_equals_the_jax_tools_on_the_same_arrays():
    rng = np.random.default_rng(3)
    cases = [(rng.normal(size=5), rng.normal(size=5)), ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),
             ([0.1, 0.2, 0.2, 5.0], [0.3, 0.2, 7.0]), (rng.uniform(size=7), rng.uniform(size=4))]
    for a, b in cases:
        expected = jwarm_start_ab.rank_sum_p(a, b)
        assert warm_start_ab.rank_sum_p(a, b) == pytest.approx(expected, rel=1e-12, abs=1e-15)
        assert surrogate_ab.rank_sum_p(a, b) == pytest.approx(
            jsurrogate_ab.rank_sum_p(a, b), rel=1e-12, abs=1e-15)


def test_the_measuring_tools_ask_for_the_card_by_default():
    for module in (warm_start_ab, surrogate_ab):
        assert module.parser().parse_args([]).device == "cuda"
        assert module.parser().parse_args([]).out is None
    with pytest.raises(RuntimeError, match="no GPU"):
        warm_start_ab.measure_latency(argparse.Namespace(
            device="cuda", trials=5, dim=2, evals=10, batch=1, repeats=1))
