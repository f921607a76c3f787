"""SLO engine: declarative objectives over sliding metric windows.

A copy of the JAX package's ``observability/slo.py`` over the port's own
``MetricsRegistry``, ``Tracer`` and flight recorder. Production serving is
operated against *objectives*, not raw counters: "99% of suggests under X
ms", "speculative hit rate above Y", "fallback rate below Z". The engine
snapshots the metrics it needs on every evaluation and differences the
snapshots at each window boundary, so cumulative counters and histograms
become windowed rates without a scrape pipeline.

Each (SLO, window) pair yields an **error-budget burn rate**: the fraction
of the window's traffic that violated the objective, divided by the
fraction the objective allows. Burn 1.0 = spending budget exactly at the
allowed rate; > 1.0 sustained = the objective is being missed. Fast and
slow windows separate a transient spike from a sustained regression.
Results are exported as ``vizier_slo_*`` gauges in the same registry (the
JAX package's names and labels, so one dashboard reads both), and surface
through ``ServingRuntime.slo_report()``.

A breach (burn over the threshold in any window, with enough samples)
triggers the **black-box dump**: the breaching SLO statuses, the latency
histogram's exemplar trace ids (with their full traces from the span ring,
when available), the flight-recorder rings and a metrics snapshot — one
JSON file that answers "why did p99 spike" after the fact.

Everything is opt-in (``VIZIER_TORCH_SLO=1``) and stdlib only; off = no
engine object, no sampling thread, zero overhead.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.utils import env as env_lib

_logger = logging.getLogger(__name__)

_SUGGEST_HIST = "vizier_suggest_latency_seconds"
_OCCUPANCY_HIST = "vizier_batch_occupancy"
_FLUSH_COUNTER = "vizier_batch_flushes"


def _parse_windows(raw: str) -> Tuple[float, ...]:
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            value = float(part)
        except ValueError:
            continue
        if value > 0:
            out.append(value)
    return tuple(out) or (60.0, 300.0)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Knobs for the SLO engine (``VIZIER_TORCH_SLO*``)."""

    # Off by default: arming SLOs starts the sampler and (optionally) the
    # background evaluator thread.
    enabled: bool = False
    # Sliding windows (seconds) every SLO is evaluated over.
    windows: Tuple[float, ...] = (60.0, 300.0)
    # Background evaluation cadence; 0 = manual ``evaluate()`` only.
    eval_interval_s: float = 1.0
    # Objective: 99% of suggests (per hop) complete under this many ms.
    suggest_p99_ms: float = 5000.0
    # Objective: speculative serve outcomes hit at least this rate
    # (evaluated only when speculative traffic exists in the window).
    speculative_hit_rate: float = 0.8
    # Objective: at most this fraction of suggests served by the
    # quasi-random reliability fallback.
    fallback_rate: float = 0.05
    # Objective: at most this fraction of suggests shed by the admission
    # controller (serving.admission; evaluated only when the
    # window saw any admission traffic).
    shed_rate: float = 0.05
    # Objective: mean batch-flush occupancy at least this many real slots
    # (padding-waste proxy; 1.0 = always satisfied, raise to enforce).
    occupancy_min: float = 1.0
    # Objective: busiest/least-busy mesh placement flush share ratio at
    # most this (skipped below two active placements).
    mesh_imbalance_max: float = 4.0
    # Breach handling: black-box dumps land here ('' = no dumps, the
    # breach still exports gauges and records a flight-recorder event).
    dump_dir: str = ""
    # A window needs at least this many observations before it can breach.
    min_samples: int = 5
    # Burn rate at or above which a window counts as breaching.
    burn_threshold: float = 1.0
    # Minimum seconds between black-box dumps for the same SLO.
    breach_cooldown_s: float = 30.0

    @classmethod
    def from_env(cls) -> "SloConfig":
        return cls(
            enabled=env_lib.env_on("VIZIER_TORCH_SLO", default="0"),
            windows=_parse_windows(env_lib.env_str("VIZIER_TORCH_SLO_WINDOWS", "60,300")),
            eval_interval_s=env_lib.env_float("VIZIER_TORCH_SLO_EVAL_INTERVAL_S", 1.0),
            suggest_p99_ms=env_lib.env_float("VIZIER_TORCH_SLO_SUGGEST_P99_MS", 5000.0),
            speculative_hit_rate=env_lib.env_float("VIZIER_TORCH_SLO_SPECULATIVE_HIT_RATE", 0.8),
            fallback_rate=env_lib.env_float("VIZIER_TORCH_SLO_FALLBACK_RATE", 0.05),
            shed_rate=env_lib.env_float("VIZIER_TORCH_SLO_SHED_RATE", 0.05),
            dump_dir=env_lib.env_str("VIZIER_TORCH_SLO_DUMP_DIR"),
        )

    def as_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["windows"] = list(self.windows)
        return out


@dataclasses.dataclass
class SloStatus:
    """One (SLO, window) evaluation result."""

    slo: str
    window_secs: float
    # The windowed value of whatever the SLO measures (p99 seconds, hit
    # rate, fallback rate, mean occupancy, imbalance ratio); None when the
    # window held no relevant traffic.
    value: Optional[float]
    threshold: float
    total: int
    bad: int
    burn_rate: Optional[float]
    breached: bool

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _Sample:
    """One point-in-time snapshot of the metrics the SLOs consume."""

    __slots__ = ("t", "counters", "hists")

    def __init__(self, t: float):
        self.t = t
        # name -> {labelkey: value}
        self.counters: Dict[str, Dict] = {}
        # name -> {labelkey: (bucket_counts, count, sum)}
        self.hists: Dict[str, Dict] = {}


_EMPTY: Dict = {}


def _delta_counter(
    new: _Sample, old: Optional[_Sample], name: str
) -> Dict[Any, float]:
    """Per-series counter increase between two samples (>= 0)."""
    new_series = new.counters.get(name, _EMPTY)
    old_series = old.counters.get(name, _EMPTY) if old is not None else _EMPTY
    return {
        key: max(0.0, value - old_series.get(key, 0.0))
        for key, value in new_series.items()
    }


def _delta_hist(
    new: _Sample, old: Optional[_Sample], name: str
) -> Dict[Any, Tuple[List[int], int, float]]:
    """Per-series histogram delta ``(bucket_counts, count, sum)``."""
    new_series = new.hists.get(name, _EMPTY)
    old_series = old.hists.get(name, _EMPTY) if old is not None else _EMPTY
    out = {}
    for key, (counts, count, total) in new_series.items():
        old_counts, old_count, old_sum = old_series.get(
            key, ([0] * len(counts), 0, 0.0)
        )
        if len(old_counts) != len(counts):  # bucket layout changed: restart
            old_counts, old_count, old_sum = [0] * len(counts), 0, 0.0
        out[key] = (
            [max(0, n - o) for n, o in zip(counts, old_counts)],
            max(0, count - old_count),
            max(0.0, total - old_sum),
        )
    return out


def _hist_quantile(
    buckets: Sequence[float], counts: Sequence[int], q: float
) -> Optional[float]:
    """Bucket-interpolated quantile of a (windowed) bucket-count vector —
    the same estimator :meth:`Histogram.percentile` applies to cumulative
    state, applied here to a delta."""
    total = sum(counts)
    if total == 0:
        return None
    rank = (q / 100.0) * total
    cumulative = 0
    for i, c in enumerate(counts):
        if cumulative + c >= rank and c > 0:
            if i >= len(buckets):
                return buckets[-1]
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            frac = (rank - cumulative) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cumulative += c
    return buckets[-1]


def _count_above(
    buckets: Sequence[float], counts: Sequence[int], threshold: float
) -> float:
    """Observations above ``threshold``, interpolating inside the crossing
    bucket (bucket-resolution, like every histogram-derived number here)."""
    above = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo = buckets[i - 1] if 0 < i <= len(buckets) else 0.0
        hi = buckets[i] if i < len(buckets) else float("inf")
        if lo >= threshold:
            above += c
        elif hi > threshold and hi != float("inf"):
            above += c * (hi - threshold) / (hi - lo)
        elif hi == float("inf") and threshold <= lo:
            above += c
    return above


class SloEngine:
    """Samples the registry, evaluates the objectives, handles breaches."""

    def __init__(
        self,
        config: SloConfig,
        registry: metrics_lib.MetricsRegistry,
        recorder=None,
    ):
        self.config = config
        self._registry = registry
        self._recorder = (
            recorder if recorder is not None else recorder_lib.get_recorder()
        )
        self._lock = threading.Lock()
        self._samples: List[_Sample] = []
        self._last_dump: Dict[str, float] = {}  # slo name -> dump time
        self.dumps: List[str] = []
        self._counter_names = (
            "vizier_serving_speculative_hits",
            "vizier_serving_speculative_misses",
            "vizier_serving_speculative_stale",
            "vizier_serving_fallbacks",
            "vizier_serving_admission_sheds",
            _FLUSH_COUNTER,
        )
        self._hist_names = (_SUGGEST_HIST, _OCCUPANCY_HIST)
        # vizier_slo_* export surface, co-located with everything else.
        self._burn = registry.gauge(
            "vizier_slo_burn_rate",
            help="Error-budget burn rate per SLO and window (1.0 = on budget).",
        )
        self._value = registry.gauge(
            "vizier_slo_value",
            help="Windowed value of what each SLO measures.",
        )
        self._breached = registry.gauge(
            "vizier_slo_breached",
            help="1 when the SLO breached in any window at last evaluation.",
        )
        self._mesh_util = registry.gauge(
            "vizier_slo_mesh_utilization",
            help="Per-placement share of windowed batch flushes.",
        )
        self._evaluations = registry.counter(
            "vizier_slo_evaluations", help="SLO engine evaluation sweeps."
        )
        self._breaches = registry.counter(
            "vizier_slo_breach_events", help="SLO breach events handled."
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------

    def _take_sample(self, now: float) -> _Sample:
        sample = _Sample(now)
        for name in self._counter_names:
            metric = self._registry.get(name)
            if isinstance(metric, metrics_lib.Counter):
                sample.counters[name] = metric.series_values()
        for name in self._hist_names:
            metric = self._registry.get(name)
            if isinstance(metric, metrics_lib.Histogram):
                sample.hists[name] = metric.series_data()
        return sample

    def _baseline(self, now: float, window: float) -> Optional[_Sample]:
        """The newest sample at least ``window`` old — or the oldest one
        when the engine has not been alive that long (partial window); None
        means "delta against zero" (everything since process start)."""
        target = now - window
        best = None
        for sample in self._samples:
            if sample.t <= target:
                best = sample
            else:
                break
        if best is None and self._samples:
            oldest = self._samples[0]
            # Within one eval of "now": no usable window yet; fall through
            # to the zero baseline so a single-evaluation run still reports.
            if oldest.t <= target or now - oldest.t >= window * 0.5:
                best = oldest
        return best

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[SloStatus]:
        """One sweep: sample, evaluate every (SLO, window), export gauges,
        and handle any breach. Thread-safe; also the background loop body."""
        now = time.time() if now is None else now
        sample = self._take_sample(now)
        with self._lock:
            statuses = self._evaluate_locked(sample, now)
            breaching = [s for s in statuses if s.breached]
            dump_path = self._handle_breaches_locked(breaching, now)
        self._export(statuses)
        self._evaluations.inc()
        if dump_path is not None:
            # Recorder/log writes outside the engine lock (leaf-lock rule).
            self._recorder.record(
                recorder_lib.FLEET,
                "slo_breach",
                slos=sorted({s.slo for s in breaching}),
                dump=dump_path or None,
            )
            self._breaches.inc()
        return statuses

    def _evaluate_locked(self, sample: _Sample, now: float) -> List[SloStatus]:
        self._samples.append(sample)
        horizon = now - max(self.config.windows) * 1.5 - 2 * max(
            1.0, self.config.eval_interval_s
        )
        while len(self._samples) > 2 and self._samples[0].t < horizon:
            self._samples.pop(0)
        statuses: List[SloStatus] = []
        for window in self.config.windows:
            base = self._baseline(now, window)
            statuses.extend(self._latency_slos(sample, base, window))
            statuses.append(self._hit_rate_slo(sample, base, window))
            statuses.append(self._fallback_slo(sample, base, window))
            statuses.append(self._shed_slo(sample, base, window))
            statuses.append(self._occupancy_slo(sample, base, window))
            statuses.append(self._mesh_slo(sample, base, window))
        return statuses

    def _status(
        self,
        slo: str,
        window: float,
        value: Optional[float],
        threshold: float,
        total: float,
        bad: float,
        allowed_bad_fraction: float,
    ) -> SloStatus:
        burn = None
        breached = False
        if total >= max(1, self.config.min_samples) and value is not None:
            bad_fraction = bad / total
            allowed = max(allowed_bad_fraction, 1e-9)
            burn = bad_fraction / allowed
            breached = burn >= self.config.burn_threshold
        return SloStatus(
            slo=slo,
            window_secs=window,
            value=value,
            threshold=threshold,
            total=int(total),
            bad=int(round(bad)),
            burn_rate=round(burn, 4) if burn is not None else None,
            breached=breached,
        )

    def _latency_slos(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> List[SloStatus]:
        """suggest p99 per hop: 99% of the window's suggests under the
        configured threshold."""
        metric = self._registry.get(_SUGGEST_HIST)
        buckets = metric.buckets if metric is not None else ()
        threshold = self.config.suggest_p99_ms / 1e3
        deltas = _delta_hist(sample, base, _SUGGEST_HIST)
        out = []
        for key, (counts, count, _sum) in sorted(deltas.items()):
            labels = dict(key)
            hop = labels.get("hop", "")
            # The admission plane splits the service hop per tenant: each
            # tenant series becomes its own p99 objective, so one hot
            # tenant's collapse cannot hide inside the fleet aggregate.
            tenant = labels.get("tenant")
            name = f"suggest_p99:{hop}" + (f":{tenant}" if tenant else "")
            p99 = _hist_quantile(buckets, counts, 99) if count else None
            bad = _count_above(buckets, counts, threshold) if count else 0.0
            out.append(
                self._status(
                    name, window, p99, threshold, count, bad,
                    allowed_bad_fraction=0.01,
                )
            )
        return out

    def _hit_rate_slo(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> SloStatus:
        hits = sum(
            _delta_counter(sample, base, "vizier_serving_speculative_hits").values()
        )
        misses = sum(
            _delta_counter(
                sample, base, "vizier_serving_speculative_misses"
            ).values()
        )
        stale = sum(
            _delta_counter(
                sample, base, "vizier_serving_speculative_stale"
            ).values()
        )
        total = hits + misses + stale
        rate = hits / total if total else None
        return self._status(
            "speculative_hit_rate", window, rate,
            self.config.speculative_hit_rate, total, misses + stale,
            allowed_bad_fraction=1.0 - self.config.speculative_hit_rate,
        )

    def _fallback_slo(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> SloStatus:
        fallbacks = sum(
            _delta_counter(sample, base, "vizier_serving_fallbacks").values()
        )
        # Request volume = the pythia hop's windowed suggest count (the hop
        # every served suggestion crosses, fallback or not).
        suggests = 0
        for key, (_counts, count, _sum) in _delta_hist(
            sample, base, _SUGGEST_HIST
        ).items():
            if dict(key).get("hop") == "pythia":
                suggests += count
        rate = fallbacks / suggests if suggests else None
        return self._status(
            "reliability_fallback_rate", window, rate,
            self.config.fallback_rate, suggests, fallbacks,
            allowed_bad_fraction=self.config.fallback_rate,
        )

    def _shed_slo(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> SloStatus:
        """Admission shed fraction: sheds over (sheds + served pythia
        suggests) in the window — the overload plane's own error budget."""
        sheds = sum(
            _delta_counter(
                sample, base, "vizier_serving_admission_sheds"
            ).values()
        )
        suggests = 0
        for key, (_counts, count, _sum) in _delta_hist(
            sample, base, _SUGGEST_HIST
        ).items():
            if dict(key).get("hop") == "pythia":
                suggests += count
        total = suggests + sheds
        rate = sheds / total if total else None
        return self._status(
            "admission_shed_rate", window, rate, self.config.shed_rate,
            total, sheds, allowed_bad_fraction=self.config.shed_rate,
        )

    def _occupancy_slo(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> SloStatus:
        """Mean real slots per flush across every bucket/device series —
        the padding-waste proxy (each padded slot is compute bought and
        thrown away)."""
        total_count, total_sum = 0, 0.0
        for _key, (_counts, count, series_sum) in _delta_hist(
            sample, base, _OCCUPANCY_HIST
        ).items():
            total_count += count
            total_sum += series_sum
        mean = total_sum / total_count if total_count else None
        # "bad" for a floor objective: the occupancy shortfall, expressed
        # as a fraction of the floor, scaled to flush count.
        bad = 0.0
        if mean is not None and self.config.occupancy_min > 0:
            shortfall = max(0.0, self.config.occupancy_min - mean)
            bad = total_count * min(1.0, shortfall / self.config.occupancy_min)
        return self._status(
            "batch_occupancy_mean", window, mean, self.config.occupancy_min,
            total_count, bad, allowed_bad_fraction=1e-9,
        )

    def _mesh_slo(
        self, sample: _Sample, base: Optional[_Sample], window: float
    ) -> SloStatus:
        """Per-placement utilization balance from windowed flush counts."""
        per_device: Dict[str, float] = {}
        for key, value in _delta_counter(
            sample, base, _FLUSH_COUNTER
        ).items():
            device = dict(key).get("device")
            if device is not None:
                per_device[device] = per_device.get(device, 0.0) + value
        total = sum(per_device.values())
        active = {d: v for d, v in per_device.items() if v > 0}
        for device, value in sorted(per_device.items()):
            self._mesh_util.set(value / total if total else 0.0, device=device)
        if len(active) < 2:
            return self._status(
                "mesh_utilization_balance", window, None,
                self.config.mesh_imbalance_max, 0, 0, 1e-9,
            )
        imbalance = max(active.values()) / min(active.values())
        bad = total if imbalance > self.config.mesh_imbalance_max else 0.0
        return self._status(
            "mesh_utilization_balance", window, imbalance,
            self.config.mesh_imbalance_max, total, bad,
            allowed_bad_fraction=1e-9,
        )

    def _export(self, statuses: List[SloStatus]) -> None:
        breached_slos: Dict[str, bool] = {}
        for status in statuses:
            window = f"{int(status.window_secs)}s"
            if status.burn_rate is not None:
                self._burn.set(status.burn_rate, slo=status.slo, window=window)
            if status.value is not None:
                self._value.set(status.value, slo=status.slo, window=window)
            breached_slos[status.slo] = (
                breached_slos.get(status.slo, False) or status.breached
            )
        for slo, breached in breached_slos.items():
            self._breached.set(1.0 if breached else 0.0, slo=slo)

    # -- breach handling -----------------------------------------------------

    def _handle_breaches_locked(
        self, breaching: List[SloStatus], now: float
    ) -> Optional[str]:
        """Returns the dump path ('' when dumps are disabled) on a breach
        worth reporting, None when nothing new breached."""
        due = [
            s
            for s in breaching
            if now - self._last_dump.get(s.slo, -1e18)
            >= self.config.breach_cooldown_s
        ]
        if not due:
            return None
        for status in due:
            self._last_dump[status.slo] = now
        if not self.config.dump_dir:
            return ""
        try:
            path = self._write_blackbox(due, now)
        except OSError as e:  # a full disk must not take serving down
            _logger.warning("SLO black-box dump failed: %s", e)
            return ""
        self.dumps.append(path)
        return path

    def _write_blackbox(self, breaching: List[SloStatus], now: float) -> str:
        """The black-box artifact: enough context to reconstruct the breach
        without the process that served it."""
        os.makedirs(self.config.dump_dir, exist_ok=True)
        exemplars: Dict[str, list] = {}
        metric = self._registry.get(_SUGGEST_HIST)
        if isinstance(metric, metrics_lib.Histogram):
            for key in metric.label_keys():
                labels = dict(key)
                kept = metric.exemplars(**labels)
                if kept:
                    exemplars[labels.get("hop", str(labels))] = kept
        trace_ids = sorted(
            {e["trace_id"] for kept in exemplars.values() for e in kept}
        )
        tracer = tracing_lib.get_tracer()
        exemplar_traces = {
            trace_id: [s.to_dict() for s in tracer.spans_for_trace(trace_id)]
            for trace_id in trace_ids
        }
        payload = {
            "version": 1,
            "time": now,
            "breaching": [s.as_dict() for s in breaching],
            "exemplars": exemplars,
            "exemplar_traces": exemplar_traces,
            "flight_recorder": self._recorder.snapshot(),
            "metrics": self._registry.snapshot(),
            "config": self.config.as_dict(),
        }
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        slug = breaching[0].slo.replace(":", "_").replace("/", "_")
        path = os.path.join(
            self.config.dump_dir,
            f"blackbox-{slug}-{stamp}-{len(self.dumps)}.json",
        )
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        return path

    # -- report / lifecycle --------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Evaluates now and returns the JSON-ready SLO report."""
        statuses = self.evaluate()
        return {
            "armed": True,
            "config": self.config.as_dict(),
            "statuses": [s.as_dict() for s in statuses],
            "breaching": sorted({s.slo for s in statuses if s.breached}),
            "dumps": list(self.dumps),
        }

    def start(self) -> bool:
        """Starts the background evaluator (idempotent; False when the
        cadence is 0 = manual-only)."""
        if self.config.eval_interval_s <= 0:
            return False
        with self._lock:
            if self._thread is not None:
                return False
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="vizier-slo-eval", daemon=True
            )
            self._thread.start()
        return True

    def close(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.config.eval_interval_s):
            try:
                self.evaluate()
            except Exception as e:  # the sweep must never kill the loop
                _logger.warning("SLO evaluation failed: %s", e)
