"""Fleet aggregation: merge per-replica observability dumps into one view.

A copy of the JAX package's ``observability/fleet.py``: the same dump format
and merge, so each package's tools read the other's dump directories. Every
replica process owns a slice of the fleet's traces. The **dump format** is
three files per source, ``<source>-spans.jsonl`` (one span per line, what
``Tracer.dump_jsonl`` writes), ``<source>-metrics.json``
(``MetricsRegistry.snapshot()``) and ``<source>-recorder.json`` (the flight
recorder's time-ordered event list); the **merge** stitches spans from N
sources back into single cross-replica traces (trace context propagates
across the wire in the request protos) and rebuilds the failover timeline
from the recorder's ``replica_*`` events.

File-based on purpose: a dump directory survives the processes that wrote
it, ships in a bug report and needs no collector. Stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

SPAN_SUFFIX = "-spans.jsonl"
METRICS_SUFFIX = "-metrics.json"
RECORDER_SUFFIX = "-recorder.json"

# Recorder event kinds that make up the failover timeline.
_TIMELINE_KINDS = (
    "replica_killed",
    "replica_failover",
    "replica_revive",
    "slo_breach",
)


def dump_process(
    out_dir: str,
    source: str,
    tracer=None,
    registry=None,
    recorder=None,
) -> Dict[str, str]:
    """Writes one source's span/metric/recorder dumps into ``out_dir``.

    ``source`` is the replica id (or ``"client"`` for unattributed spans).
    Pass only the pieces the process has; missing ones write no file.
    Returns the paths written, keyed ``spans``/``metrics``/``recorder``.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    if tracer is not None and getattr(tracer, "enabled", True):
        path = os.path.join(out_dir, source + SPAN_SUFFIX)
        tracer.dump_jsonl(path)
        written["spans"] = path
    if registry is not None:
        path = os.path.join(out_dir, source + METRICS_SUFFIX)
        with open(path, "w") as f:
            json.dump(registry.snapshot(), f, sort_keys=True)
        written["metrics"] = path
    if recorder is not None and getattr(recorder, "enabled", False):
        path = os.path.join(out_dir, source + RECORDER_SUFFIX)
        recorder.dump_json(path)
        written["recorder"] = path
    return written


def write_spans(out_dir: str, source: str, spans: List[dict]) -> str:
    """Writes an explicit span list as ``<source>-spans.jsonl``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, source + SPAN_SUFFIX)
    with open(path, "w") as f:
        for span in spans:
            f.write(json.dumps(span) + "\n")
    return path


def _load_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                item = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(item, dict):
                out.append(item)
    return out


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _sources(dump_dir: str, suffix: str):
    for path in sorted(glob.glob(os.path.join(dump_dir, "*" + suffix))):
        yield os.path.basename(path)[: -len(suffix)], path


def load_fleet_dir(dump_dir: str) -> Dict[str, Dict[str, Any]]:
    """Reads every dump in ``dump_dir``:
    ``{"spans": {source: [span...]}, "metrics": {...}, "recorder": {...}}``.
    """
    spans = {source: _load_jsonl(path) for source, path in _sources(dump_dir, SPAN_SUFFIX)}
    metrics: Dict[str, dict] = {}
    for source, path in _sources(dump_dir, METRICS_SUFFIX):
        loaded = _load_json(path)
        if isinstance(loaded, dict):
            metrics[source] = loaded
    recorder: Dict[str, List[dict]] = {}
    for source, path in _sources(dump_dir, RECORDER_SUFFIX):
        loaded = _load_json(path)
        if isinstance(loaded, list):
            recorder[source] = [e for e in loaded if isinstance(e, dict)]
    return {"spans": spans, "metrics": metrics, "recorder": recorder}


def merge_spans(per_source: Dict[str, List[dict]]) -> List[dict]:
    """One flat span list, each span stamped with its dump ``source``,
    ordered by start time — the cross-replica trace substrate."""
    merged: List[dict] = []
    for source, spans in sorted(per_source.items()):
        for span in spans:
            span = dict(span)
            span["source"] = source
            merged.append(span)
    merged.sort(key=lambda s: s.get("start_time", 0.0))
    return merged


def cross_replica_traces(merged: List[dict]) -> List[dict]:
    """Traces whose spans came from 2+ distinct dump sources — one request
    observed end-to-end across processes, stitched back together by the
    propagated trace id."""
    by_trace: Dict[str, Dict[str, Any]] = {}
    for span in merged:
        trace_id = span.get("trace_id")
        if not trace_id:
            continue
        row = by_trace.setdefault(trace_id, {"trace_id": trace_id, "sources": set(), "spans": 0})
        row["sources"].add(span.get("source", ""))
        row["spans"] += 1
    out = [
        {**row, "sources": sorted(row["sources"])}
        for row in by_trace.values()
        if len(row["sources"]) >= 2
    ]
    out.sort(key=lambda row: (-row["spans"], row["trace_id"]))
    return out


def failover_timeline(per_source_events: Dict[str, List[dict]]) -> List[dict]:
    """The fleet's topology-change history, time-ordered: kill, failover
    (with successor list), revive, and SLO breach events from every
    source's flight-recorder dump."""
    timeline: List[dict] = []
    for source, events in sorted(per_source_events.items()):
        for event in events:
            if event.get("kind") not in _TIMELINE_KINDS:
                continue
            row = {"time": event.get("time"), "kind": event.get("kind"), "source": source}
            row.update(event.get("attributes") or {})
            timeline.append(row)
    timeline.sort(key=lambda row: row.get("time") or 0.0)
    return timeline


def slo_series(metrics_snapshot: dict) -> Dict[str, Any]:
    """The ``vizier_slo_*`` families from one ``MetricsRegistry.snapshot()``
    dump, keyed by metric name — the SLO section of a merged report."""
    out: Dict[str, Any] = {}
    for name, family in sorted(metrics_snapshot.items()):
        if name.startswith("vizier_slo_") and isinstance(family, dict):
            out[name] = family.get("series", {})
    return out


# Frontend-side spans of the remote Pythia hop (the compute tier stamps
# frontend=<replica_id> on these, so a merged dump can attribute fan-in per
# frontend).
_COMPUTE_TIER_SPANS = (
    "compute_tier.remote_suggest",
    "compute_tier.remote_early_stop",
)


def compute_tier_section(merged: List[dict], metrics: Dict[str, dict]) -> Dict[str, Any]:
    """The disaggregated-compute view of a merged dump: which frontends
    crossed the remote Pythia hop (fan-in), and the compute server's
    batch-flush occupancy."""
    per_frontend: Dict[str, int] = {}
    remote_spans = 0
    for span in merged:
        if span.get("name") not in _COMPUTE_TIER_SPANS:
            continue
        remote_spans += 1
        frontend = (span.get("attributes") or {}).get("frontend") or span.get("source", "")
        per_frontend[frontend] = per_frontend.get(frontend, 0) + 1
    occupancy: Dict[str, float] = {}
    for source, snapshot in sorted(metrics.items()):
        family = snapshot.get("vizier_batch_occupancy")
        if not isinstance(family, dict):
            continue
        total = count = 0.0
        for series in (family.get("series") or {}).values():
            total += float(series.get("sum", 0.0))
            count += float(series.get("count", 0.0))
        if count > 0:
            occupancy[source] = round(total / count, 3)
    return {
        "remote_spans": remote_spans,
        "frontends": sorted(per_frontend),
        "fan_in": len(per_frontend),
        "per_frontend": dict(sorted(per_frontend.items())),
        "batch_occupancy": occupancy,
    }


def fleet_report(dump_dir: str) -> Dict[str, Any]:
    """The merged fleet view of one dump directory (JSON-ready)."""
    loaded = load_fleet_dir(dump_dir)
    merged = merge_spans(loaded["spans"])
    crossing = cross_replica_traces(merged)
    trace_ids = {s.get("trace_id") for s in merged if s.get("trace_id")}
    slo: Dict[str, Any] = {}
    for _source, snapshot in sorted(loaded["metrics"].items()):
        for name, series in slo_series(snapshot).items():
            slo.setdefault(name, {}).update(series)
    return {
        "dump_dir": dump_dir,
        "sources": sorted(loaded["spans"]),
        "spans": len(merged),
        "traces": len(trace_ids),
        "cross_replica_traces": len(crossing),
        "cross_replica_examples": crossing[:10],
        "failover_timeline": failover_timeline(loaded["recorder"]),
        "slo": slo,
        "compute_tier": compute_tier_section(merged, loaded["metrics"]),
    }


def merged_trace(dump_dir: str, trace_id: str) -> List[dict]:
    """One cross-replica trace's spans (source-stamped, time-ordered)."""
    merged = merge_spans(load_fleet_dir(dump_dir)["spans"])
    return [s for s in merged if s.get("trace_id") == trace_id]


def render_fleet_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`fleet_report`'s output."""
    lines = [
        f"fleet dump: {report['dump_dir']}",
        f"sources: {', '.join(report['sources']) or '(none)'}",
        f"{report['spans']} spans across {report['traces']} traces; "
        f"{report['cross_replica_traces']} cross-replica",
    ]
    for row in report["cross_replica_examples"]:
        lines.append(
            f"  trace {row['trace_id']}: {row['spans']} spans over {', '.join(row['sources'])}"
        )
    timeline = report["failover_timeline"]
    if timeline:
        lines.append("failover timeline:")
        for event in timeline:
            extras = {k: v for k, v in event.items() if k not in ("time", "kind", "source")}
            note = f" {extras}" if extras else ""
            lines.append(
                f"  t={event.get('time'):.3f} [{event['source']}] {event['kind']}{note}"
            )
    else:
        lines.append("failover timeline: (no events)")
    if report["slo"]:
        lines.append("slo gauges: " + ", ".join(sorted(report["slo"])))
    tier = report.get("compute_tier") or {}
    if tier.get("remote_spans"):
        occupancy = tier.get("batch_occupancy") or {}
        occ_note = (
            "; ".join(f"{src} occupancy {val}" for src, val in occupancy.items())
            or "no occupancy histograms"
        )
        lines.append(
            f"compute tier: {tier['remote_spans']} remote hops from "
            f"{tier['fan_in']} frontend(s) ({', '.join(tier['frontends'])}); {occ_note}"
        )
    return "\n".join(lines)
