"""Metrics registry: named counters/gauges/histograms, Prometheus text dump.

A copy of the JAX package's ``observability/metrics.py``, so that the port imports nothing
of the JAX package.

Stdlib-only (no prometheus_client in the image). Each metric owns a family
of labeled series; histograms use fixed exponential buckets and estimate
p50/p95/p99 by linear interpolation inside the bucket that crosses the
quantile — the same estimator ``histogram_quantile`` applies server-side,
done here so in-process callers (bench, chaos A/B, obs_report) get
percentiles without a scrape pipeline.

Thread safety: one lock per metric guards its whole series family; metric
*creation* is guarded by the registry lock. Observation cost is a dict
lookup + bisect under a short lock — noise against a multi-ms designer run.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """``count`` upper bounds growing geometrically from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"Need start > 0, factor > 1, count >= 1; got {start}, {factor}, {count}."
        )
    out = []
    bound = start
    for _ in range(count):
        out.append(bound)
        bound *= factor
    return out


# 1 ms .. ~372 s in x1.3 steps: fine enough that an interpolated p50 of a
# sub-second suggest lands within a few percent of the sample percentile.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    exponential_buckets(0.001, 1.3, 50)
)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared shell: name, help text, per-metric lock, labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def label_keys(self) -> List[LabelKey]:
        with self._lock:
            return list(self._series)


class Counter(_Metric):
    """Monotonic counter. Rendered with the ``_total`` suffix."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"Counter {self.name} cannot decrease ({amount}).")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def series_values(self) -> Dict[LabelKey, float]:
        """Every labeled series' value (sliding-window delta material)."""
        with self._lock:
            return {key: float(v) for key, v in self._series.items()}

    def reset(self) -> None:
        """Zeroes every series (in-process test/rollup convenience)."""
        with self._lock:
            for key in self._series:
                self._series[key] = 0.0

    def _render(self, lines: List[str]) -> None:
        with self._lock:
            series = sorted(self._series.items())
        if not series:
            lines.append(f"{self.name}_total 0")
            return
        for key, value in series:
            lines.append(
                f"{self.name}_total{_render_labels(key)} {_format_value(value)}"
            )


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def _render(self, lines: List[str]) -> None:
        with self._lock:
            series = sorted(self._series.items())
        for key, value in series:
            lines.append(f"{self.name}{_render_labels(key)} {_format_value(value)}")


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, num_buckets: int):
        # One slot per finite bucket plus the +Inf overflow slot.
        self.counts = [0] * (num_buckets + 1)
        self.sum = 0.0
        self.count = 0
        # Top-valued exemplars: [value, trace_id, time] triples, unordered.
        self.exemplars: List[list] = []


class Histogram(_Metric):
    """Fixed-bucket histogram with quantile estimation from the buckets.

    Observations may carry an **exemplar** ``trace_id``: the top
    :data:`MAX_EXEMPLARS` highest-valued observations per series keep
    their trace ids (OpenMetrics-style), so a p99 number links back to
    real traces. Capture is sampling-only metadata — it never changes what
    is counted — and costs one comparison when no trace id is supplied.
    """

    kind = "histogram"

    MAX_EXEMPLARS = 8

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help)
        bounds = sorted(buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS)
        if not bounds:
            raise ValueError(f"Histogram {name} needs at least one bucket.")
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in bounds)

    def observe(
        self, value: float, trace_id: Optional[str] = None, **labels: str
    ) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(len(self.buckets))
            series.counts[idx] += 1
            series.sum += value
            series.count += 1
            if trace_id is not None:
                exemplars = series.exemplars
                if len(exemplars) < self.MAX_EXEMPLARS:
                    exemplars.append([value, trace_id, time.time()])
                else:
                    low = min(range(len(exemplars)), key=lambda i: exemplars[i][0])
                    if value > exemplars[low][0]:
                        exemplars[low] = [value, trace_id, time.time()]

    def exemplars(self, **labels: str) -> List[Dict[str, object]]:
        """The series' kept exemplars, highest value first."""
        with self._lock:
            series = self._series.get(_label_key(labels))
            kept = list(series.exemplars) if series is not None else []
        kept.sort(key=lambda e: e[0], reverse=True)
        return [
            {"value": value, "trace_id": trace_id, "time": t}
            for value, trace_id, t in kept
        ]

    def series_data(self) -> Dict[LabelKey, Tuple[List[int], int, float]]:
        """Per-series ``(bucket_counts, count, sum)`` snapshot — the raw
        material for sliding-window deltas (the SLO engine)."""
        with self._lock:
            return {
                key: (list(s.counts), s.count, s.sum)
                for key, s in self._series.items()
            }

    def count(self, **labels: str) -> int:
        with self._lock:
            series = self._series.get(_label_key(labels))
            return series.count if series is not None else 0

    def sum(self, **labels: str) -> float:
        with self._lock:
            series = self._series.get(_label_key(labels))
            return series.sum if series is not None else 0.0

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        """Bucket-interpolated quantile ``q`` in [0, 100]; None when empty.

        Linear interpolation inside the crossing bucket (lower bound 0 for
        the first); observations past the last finite bound clamp to it, so
        the estimate never invents a value the buckets cannot support.
        """
        if not 0 <= q <= 100:
            raise ValueError(f"Quantile must be in [0, 100], got {q}.")
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None or series.count == 0:
                return None
            counts = list(series.counts)
            total = series.count
        rank = (q / 100.0) * total
        cumulative = 0
        for i, c in enumerate(counts):
            if cumulative + c >= rank and c > 0:
                if i >= len(self.buckets):  # +Inf overflow: clamp
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - cumulative) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cumulative += c
        return self.buckets[-1]

    def _render(self, lines: List[str]) -> None:
        with self._lock:
            series = [
                (key, list(s.counts), s.sum, s.count)
                for key, s in sorted(self._series.items())
            ]
        for key, counts, total_sum, total_count in series:
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                labels = _render_labels(key, [("le", _format_value(bound))])
                lines.append(f"{self.name}_bucket{labels} {cumulative}")
            labels = _render_labels(key, [("le", "+Inf")])
            lines.append(f"{self.name}_bucket{labels} {total_count}")
            lines.append(
                f"{self.name}_sum{_render_labels(key)} {_format_value(total_sum)}"
            )
            lines.append(f"{self.name}_count{_render_labels(key)} {total_count}")


class MetricsRegistry:
    """Named metric families; get-or-create with type conflict detection."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"Metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}."
                    )
                return existing
            metric = cls(name, help, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)  # type: ignore[return-value]

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        metric = self._get_or_create(Histogram, name, help, buckets=buckets)
        if buckets is not None and tuple(sorted(float(b) for b in buckets)) != (
            metric.buckets  # type: ignore[union-attr]
        ):
            raise ValueError(f"Histogram {name!r} re-registered with other buckets.")
        return metric  # type: ignore[return-value]

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format (0.0.4)."""
        with self._lock:
            metrics = [self._metrics[name] for name in sorted(self._metrics)]
        lines: List[str] = []
        for metric in metrics:
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            metric._render(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready nested dump: name -> {type, series{label_str: value}}."""
        out: Dict[str, dict] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            series: Dict[str, object] = {}
            for key in metric.label_keys():
                label_str = _render_labels(key) or "{}"
                if isinstance(metric, Histogram):
                    labels = dict(key)
                    series[label_str] = {
                        "count": metric.count(**labels),
                        "sum": metric.sum(**labels),
                        "p50": metric.percentile(50, **labels),
                        "p95": metric.percentile(95, **labels),
                        "p99": metric.percentile(99, **labels),
                    }
                else:
                    series[label_str] = metric.value(**dict(key))  # type: ignore[attr-defined]
            out[metric.name] = {"type": metric.kind, "series": series}
        return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry (designer-level JAX phase timings)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def set_default_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swaps the process-global registry (tests); None resets to fresh-on-use."""
    global _default_registry
    with _default_lock:
        _default_registry = registry
