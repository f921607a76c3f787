"""Decomposes the DEFAULT designer's end-to-end suggest() cost at full scale.

Usage: python -m vizier_tpu_torch.tools.profile_e2e [--trials 1000] [--evals 75000]
       [--batch 25] [--repeats 2] [--dim 20] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/profile_e2e.py``, on the
same workload: ``VizierGPUCBPEBandit`` over ``--trials`` completed trials of
``--dim`` floats (20 there), the data drawn with numpy's seed 0 as there.
It runs ``update(all)``, then one first ``suggest(batch)`` that is not
counted (the process's first-use kernel build, handles, caches and graph
captures), then per repeat ``update(one fresh trial)`` + ``suggest(batch)``,
timed together, and prints a per-stage wall-clock table for each repeat and
``p50 total``, then one JSON line ``{"profile_e2e": {...}}`` with the stages.

The port's single-objective suggest after an update is the study's compute
program run alone (``UCBPEProgram.run_alone``), so the stages are hooked at
its boundaries under the JAX tool's row names:

- ``train_states_me(total)``: the host encode (``metrics.encode`` and
  ``padded_features`` nested in it, the label warp) and the train device
  phase (the ARD train and its warm seeds);
- ``suggest_batch``: the acquisition device phase (the greedy UCB-PE batch,
  ``_ucb_pe_sweeps``, and its copy to the host);
- ``all_points_data``: the completed and pending rows with room for the
  picks, ``_all_points_model_data``;
- ``decode``: ``_decode_ucb_pe``;
- ``(other/untimed)``: the rest of the call.

Each device stage is one of the designer's device phases
(``observability/device_timing.py``), timed on the host around the whole
phase, which ends synchronized with the designer's device. Beside the host
times, each repeat carries what ``device_timing`` records for those phases
(their mode, host ms and CUDA-event ms, as ``device_timing.recent()`` lists
them; no event time on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, List, Optional, Tuple
from unittest import mock

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers import gp_ucb_pe
from vizier_tpu_torch.observability import device_timing

# The table's rows, in the JAX tool's names. The nested rows are inside
# ``train_states_me(total)``; the others are top-level intervals.
TRAIN = "train_states_me(total)"
NESTED = ("metrics.encode", "padded_features")
TOP_LEVEL = (TRAIN, "suggest_batch", "all_points_data", "decode")
OTHER = "(other/untimed)"
# The device phase whose CUDA-event time sits beside each stage.
EVENT_STAGE = {
    "gp_ucb_pe.train_gp": TRAIN,
    "sparse_gp.ucb_pe_train_gp": TRAIN,
    "gp_ucb_pe.acquisition": "suggest_batch",
    "sparse_gp.ucb_pe_acquisition": "suggest_batch",
}


def _study(trials: int, dim: int, evals: int, device):
    """The DEFAULT over ``trials`` completed trials, and the numpy stream the
    fresh trials are drawn from (the JAX tool's data, seed 0)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(trials, dim))
    y = -np.sum((x - 0.5) ** 2, axis=1) + 0.1 * rng.normal(size=trials)
    problem = vz.ProblemStatement()
    for d in range(dim):
        problem.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    designer = gp_ucb_pe.VizierGPUCBPEBandit(
        problem, max_acquisition_evaluations=evals, device=device
    )
    completed = []
    for i in range(trials):
        t = vz.Trial(id=i + 1, parameters={f"x{d}": float(x[i, d]) for d in range(dim)})
        t.complete(vz.Measurement(metrics={"obj": float(y[i])}))
        completed.append(t)
    return designer, completed, rng


@contextlib.contextmanager
def _hooked_stages(designer, stage: Dict[str, float], events: Dict[str, dict]):
    """Times the port's suggest at its stage boundaries into ``stage``
    (seconds, summed over the calls). The device stages are the train and
    acquisition device phases, timed around the whole phase on the host:
    each ends synchronized (its end event, or the sync and the copy to the
    host the phase ends in), so its CUDA-event time falls inside. Each
    phase's own record (mode, host ms, event ms) goes into ``events``."""
    inside_all_points = [False]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                stage[name] = stage.get(name, 0.0) + time.perf_counter() - start
        return wrapper

    prepare = gp_ucb_pe._ucb_pe_prepare
    padded_features = designer._padded_features
    all_points = designer._all_points_model_data
    device_phase = device_timing.device_phase

    def timed_prepare(*args, **kwargs):
        # The host half of the train stage: everything but the all-points rows.
        all_before = stage.get("all_points_data", 0.0)
        start = time.perf_counter()
        out = prepare(*args, **kwargs)
        elapsed = time.perf_counter() - start
        stage[TRAIN] = stage.get(TRAIN, 0.0) + elapsed - (
            stage.get("all_points_data", 0.0) - all_before)
        return out

    def timed_features(trials, extra_rows=0):
        if inside_all_points[0]:  # counted under all_points_data
            return padded_features(trials, extra_rows)
        return timed("padded_features", padded_features)(trials, extra_rows)

    def timed_all_points(count):
        inside_all_points[0] = True
        try:
            return timed("all_points_data", all_points)(count)
        finally:
            inside_all_points[0] = False

    @contextlib.contextmanager
    def timed_phase(name, device=None, registry=None):
        start, phase = time.perf_counter(), None
        try:
            with device_phase(name, device, registry) as phase:
                yield phase
        finally:
            if name in EVENT_STAGE:
                stage[EVENT_STAGE[name]] = (
                    stage.get(EVENT_STAGE[name], 0.0) + time.perf_counter() - start)
                if phase is not None and phase.enabled:
                    events[name] = dict(stage=EVENT_STAGE[name], mode=phase.mode,
                                        host_ms=phase.host_ms, event_ms=phase.device_ms)

    with contextlib.ExitStack() as stack:
        patch = lambda target, name, new: stack.enter_context(  # noqa: E731
            mock.patch.object(target, name, new))
        patch(gp_ucb_pe, "_ucb_pe_prepare", timed_prepare)
        patch(designer._converter.metrics, "encode",
              timed("metrics.encode", designer._converter.metrics.encode))
        patch(designer, "_padded_features", timed_features)
        patch(designer, "_all_points_model_data", timed_all_points)
        patch(device_timing, "device_phase", timed_phase)
        patch(designer, "_decode_ucb_pe", timed("decode", designer._decode_ucb_pe))
        yield


def render_repeat(index: int, row: dict) -> str:
    """One repeat's stage table, as the JAX tool prints it, with each
    stage's CUDA-event time beside its host time."""
    total = row["total_ms"]
    event_by_stage = {e["stage"]: e["event_ms"] for e in row["events"].values()
                      if e["event_ms"] is not None}
    lines = [f"repeat {index}: total {total:.0f} ms"]
    stages = row["stages_ms"]
    for name in sorted(TOP_LEVEL + NESTED, key=lambda k: -stages[k]) + [OTHER]:
        event = event_by_stage.get(name)
        note = f"  events {event:9.1f} ms" if event is not None else ""
        lines.append(
            f"  {name:28s} {stages[name]:9.1f} ms ({100 * stages[name] / total:5.1f}%){note}")
    return "\n".join(lines)


def profile_suggest(trials: int = 1000, evals: int = 75_000, batch: int = 25,
                    repeats: int = 2, dim: int = 20, device="cuda",
                    ) -> Tuple[dict, List[vz.TrialSuggestion]]:
    """Runs the profile (see the module docstring), printing the JAX tool's
    lines as it goes. Returns the report and the last repeat's suggestions."""
    device = device_lib.resolve(device)
    designer, completed, rng = _study(trials, dim, evals, device)
    t0 = time.perf_counter()
    designer.update(core_lib.CompletedTrials(completed))
    update_all = time.perf_counter() - t0
    print(f"update(all {trials}): {update_all:.3f}s")

    stage: Dict[str, float] = {}
    events: Dict[str, dict] = {}
    rows = []
    with _hooked_stages(designer, stage, events):
        print("first call (not counted):", flush=True)
        t0 = time.perf_counter()
        designer.suggest(batch)
        gp_bandit._synchronize(device)
        first = time.perf_counter() - t0
        print(f"  first suggest: {first:.1f}s", flush=True)

        next_id = trials + 1
        for r in range(repeats):
            stage.clear()
            events.clear()
            fresh = vz.Trial(
                id=next_id,
                parameters={f"x{d}": float(v) for d, v in enumerate(rng.uniform(size=dim))},
            )
            fresh.complete(vz.Measurement(metrics={"obj": float(-r)}))
            next_id += 1
            t0 = time.perf_counter()
            designer.update(core_lib.CompletedTrials([fresh]))
            suggestions = designer.suggest(batch)
            gp_bandit._synchronize(device)
            total = time.perf_counter() - t0
            stages_ms = {k: stage.get(k, 0.0) * 1e3 for k in TOP_LEVEL + NESTED}
            other = total * 1e3 - sum(stages_ms[k] for k in TOP_LEVEL)
            row = dict(total_ms=total * 1e3, stages_ms={**stages_ms, OTHER: other},
                       events=dict(events))
            rows.append(row)
            print(render_repeat(r, row), flush=True)
    totals = [row["total_ms"] for row in rows]
    p50 = float(np.percentile(totals, 50))
    print(f"p50 total: {p50:.0f} ms")
    report = dict(
        config=dict(trials=trials, dim=dim, evals=evals, batch=batch, repeats=repeats),
        device=(f"cuda: {torch.cuda.get_device_name(device)}" if device.type == "cuda"
                else device.type),
        update_all_ms=update_all * 1e3, first_call_ms=first * 1e3, suggests=repeats + 1,
        repeats=rows, p50_total_ms=p50,
    )
    return report, suggestions


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--evals", type=int, default=75_000)
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    report, _ = profile_suggest(args.trials, args.evals, args.batch, args.repeats,
                                args.dim, args.device)
    print(json.dumps({"profile_e2e": report}))


if __name__ == "__main__":
    main()
