"""Speculative pre-compute A/B: suggest latency with the background
pipeline on vs off, on the canonical sequential complete -> suggest loop.

Usage: python -m vizier_tpu_torch.tools.speculative_ab [--trials 25] [--seeds 5]
       [--transport service|runtime] [--device cuda|cpu] [--out FILE]

The port's counterpart of the JAX package's ``tools/speculative_ab.py``, with
its flags, report keys and public functions. The report is printed as one
JSON line, and written to ``--out`` when given (there is no default file).

Both arms drive the SAME workload: one worker runs a study of the DEFAULT
(GP-UCB-PE) to ``--trials`` trials, completing each suggestion with a seeded
sphere objective before asking for the next. Per-study designers, budgets
and seeds are identical across arms; only the speculative engine differs:

- **baseline**: every suggest pays the full GP train + acquisition on the
  request path;
- **speculative**: each completion triggers a background pre-compute of the
  next batch; the worker's evaluation window is modelled by waiting for the
  engine to go idle before the next suggest (``--think-time`` switches to a
  fixed sleep instead).

``--transport`` picks the stack the loop drives:

- ``service`` (the default, the JAX tool's): ``VizierServicer`` ->
  ``PythiaServicer`` -> coalescer -> cached-designer policy -> the DEFAULT,
  over the port's protobuf messages;
- ``runtime``: the same policy factory and ``ServingRuntime`` through the
  loadgen's runtime transport (``loadgen/driver.py``), the servicer's order
  without protobuf, for a machine that has none.

A speculative hit is the live compute run early (same cached designer, same
generator order), so the two arms must give bit-identical suggestion
trajectories per seed, which also shows that ``VIZIER_TORCH_SPECULATIVE=0`` is
the path without the engine. Acceptance: speculative-hit suggest p50 < 10 ms,
hit rate >= 80%, bit-equal trajectories at every seed.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.serving import runtime as runtime_lib
from vizier_tpu_torch.serving import speculative as spec_lib
from vizier_tpu_torch.tools.warm_start_ab import backend, write_report

TRANSPORTS = ("service", "runtime")


def _progress(msg: str) -> None:
    print(f"[speculative_ab] {msg}", file=sys.stderr, flush=True)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    rank = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _pcts_ms(values):
    values = sorted(values)
    return {
        "p50_ms": round(_percentile(values, 50) * 1e3, 3),
        "p95_ms": round(_percentile(values, 95) * 1e3, 3),
        "p99_ms": round(_percentile(values, 99) * 1e3, 3),
        "max_ms": round((values[-1] if values else 0.0) * 1e3, 3),
        "samples": len(values),
    }


def _study_config(dim: int) -> vz.StudyConfig:
    config = vz.StudyConfig(algorithm="DEFAULT")
    for d in range(dim):
        config.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    config.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    return config


def _sphere(values) -> float:
    return -sum((v - 0.3) ** 2 for v in values)


def _seeded_factory(runtime, device, seed: int, acquisition_evals: int):
    """The service's real policy factory with the run's designer seed (and an
    optional trimmed acquisition budget) injected through its kwargs hook, so
    both arms of a seed share the exact same designer configuration."""
    from vizier_tpu_torch.service import policy_factory as policy_factory_lib

    factory = policy_factory_lib.DefaultPolicyFactory(serving_runtime=runtime, device=device)
    original_kwargs = factory._gp_designer_kwargs

    def seeded_kwargs():
        kwargs = original_kwargs()
        kwargs["rng_seed"] = seed
        if acquisition_evals:
            kwargs["max_acquisition_evaluations"] = acquisition_evals
        return kwargs

    factory._gp_designer_kwargs = seeded_kwargs
    return factory


def _runtime(speculative: bool, device) -> runtime_lib.ServingRuntime:
    return runtime_lib.ServingRuntime(
        speculative=spec_lib.SpeculativeConfig(speculative=speculative), device=device)


class _ServiceStack:
    """The in-process service stack: VizierServicer -> PythiaServicer."""

    def __init__(self, speculative: bool, acquisition_evals: int, seed: int, dim: int,
                 study_name: str, device):
        from vizier_tpu_torch.service import proto_converters as pc
        from vizier_tpu_torch.service import pythia_service, vizier_service
        from vizier_tpu_torch.service.protos import vizier_service_pb2

        self._pb2 = vizier_service_pb2
        self.servicer = vizier_service.VizierServicer()
        self.pythia = pythia_service.PythiaServicer(self.servicer, device=device)
        self.pythia.serving_runtime.shutdown()
        self.pythia._serving = _runtime(speculative, device)
        self.pythia._policy_factory = _seeded_factory(
            self.pythia.serving_runtime, device, seed, acquisition_evals)
        self.pythia._bind_speculative()
        self.servicer.set_pythia(self.pythia)
        self.runtime = self.pythia.serving_runtime
        self._study = study_name
        self.servicer.CreateStudy(vizier_service_pb2.CreateStudyRequest(
            parent="owners/ab", study=pc.study_to_proto(_study_config(dim), study_name)))

    def suggest(self):
        """(trial, parameter values in order, hit) of one ``suggest(1)``."""
        op = self.servicer.SuggestTrials(self._pb2.SuggestTrialsRequest(
            parent=self._study, suggestion_count=1, client_id="worker"))
        if op.error:
            raise RuntimeError(f"suggest failed: {op.error}")
        trial = op.response.trials[0]
        hit = any(kv.key == spec_lib.SPECULATIVE_KEY
                  and kv.string_value == spec_lib.SPECULATIVE_HIT_VALUE
                  for kv in trial.metadata)
        return trial, [(p.name, p.value.double_value) for p in trial.parameters], hit

    def complete(self, trial, objective: float) -> None:
        request = self._pb2.CompleteTrialRequest(name=trial.name)
        metric = request.final_measurement.metrics.add()
        metric.name, metric.value = "obj", objective
        self.servicer.CompleteTrial(request)

    def shutdown(self) -> None:
        self.pythia.shutdown()


class _Factory:
    """What the runtime transport binds: the seeded factory over its runtime."""

    def __init__(self, device, seed: int, acquisition_evals: int):
        self._args = (device, seed, acquisition_evals)
        self._factory = None

    def bind_runtime(self, runtime) -> None:
        self._factory = _seeded_factory(runtime, *self._args)

    def __call__(self, problem, algorithm, supporter, study_name):
        return self._factory(problem, algorithm, supporter, study_name)


class _RuntimeStack:
    """The runtime transport: one ``ServingRuntime`` served in the Pythia
    servicer's order, each study's trials in an ``InRamPolicySupporter``."""

    def __init__(self, speculative: bool, acquisition_evals: int, seed: int, dim: int,
                 study_name: str, device):
        from vizier_tpu_torch.loadgen import driver, models

        self._driver = driver
        self.runtime = _runtime(speculative, device)
        factory = _Factory(device, seed, acquisition_evals)
        self._target = driver._RuntimeTarget(
            None, self.runtime.reliability, factory, device, runtime=self.runtime)
        spec = models.StudySpec(
            index=0, name=study_name, tenant="ab", kind="gp_ucb_pe", algorithm="DEFAULT",
            budget=0, preseed=0, arrival_s=0.0, seed=seed)
        self._client = self._target.open_study(
            spec, _study_config(dim), self.runtime.reliability, None)

    def suggest(self):
        (trial,) = self._client.get_suggestions(1)
        values = list(trial.parameters.as_dict().items())
        return trial, values, self._driver._is_speculative_hit(trial.metadata)

    def complete(self, trial, objective: float) -> None:
        self._client.complete_trial(trial.id, vz.Measurement(metrics={"obj": objective}))

    def shutdown(self) -> None:
        self._target.shutdown()


def _run_arm(
    *,
    speculative: bool,
    seed: int,
    dim: int,
    trials: int,
    warmup: int,
    think_time: float,
    acquisition_evals: int,
    transport: str = "service",
    device="cuda",
) -> dict:
    study_name = f"owners/ab/studies/{'spec' if speculative else 'base'}-{seed}"
    stack_type = _ServiceStack if transport == "service" else _RuntimeStack
    stack = stack_type(speculative, acquisition_evals, seed, dim, study_name, device)
    engine = stack.runtime.speculative_engine
    latencies, hits, trajectory, best = [], [], [], []
    best_so_far = float("-inf")
    try:
        for step in range(trials):
            t0 = time.perf_counter()
            trial, values, hit = stack.suggest()
            elapsed = time.perf_counter() - t0
            if step >= warmup:
                latencies.append(elapsed)
                hits.append(hit)
            trajectory.append(tuple(sorted((name, round(v, 12)) for name, v in values)))
            objective = _sphere(v for _, v in values)
            best_so_far = max(best_so_far, objective)
            best.append(best_so_far)
            stack.complete(trial, objective)
            # The evaluation window: long enough for the pre-compute to land
            # (wait_idle), or a fixed think time if asked.
            if engine is not None:
                if think_time > 0:
                    time.sleep(think_time)
                else:
                    engine.wait_idle(300.0)
        stats = {k: v for k, v in stack.runtime.snapshot().items()
                 if k.startswith("speculative_")}
    finally:
        stack.shutdown()
    hit_lat = [l for l, h in zip(latencies, hits) if h]
    miss_lat = [l for l, h in zip(latencies, hits) if not h]
    return {
        "seed": seed,
        "suggest": _pcts_ms(latencies),
        "hit_suggest": _pcts_ms(hit_lat),
        "miss_suggest": _pcts_ms(miss_lat),
        "hits": sum(hits),
        "measured": len(hits),
        "stats": stats,
        "trajectory": trajectory,
        "best_curve": [round(b, 9) for b in best],
    }


def _ranksum_p(a, b) -> float:
    """Two-sided rank-sum p-value (scipy's ``ranksums``)."""
    from scipy import stats as sps

    return float(sps.ranksums(a, b).pvalue)


def run(args) -> dict:
    """Both arms at every seed, and the summary the JAX tool writes."""
    device = device_lib.resolve(args.device)
    if args.transport not in TRANSPORTS:
        raise ValueError(f"transport {args.transport!r}; expected one of {TRANSPORTS}")
    arms = {"baseline": [], "speculative": []}
    bit_equal, t_start = [], time.time()
    for seed in range(1, args.seeds + 1):
        common = dict(seed=seed, dim=args.dim, trials=args.trials, warmup=args.warmup,
                      think_time=args.think_time, acquisition_evals=args.acquisition_evals,
                      transport=args.transport, device=device)
        base = _run_arm(speculative=False, **common)
        spec = _run_arm(speculative=True, **common)
        equal = base["trajectory"] == spec["trajectory"]
        bit_equal.append(equal)
        arms["baseline"].append(base)
        arms["speculative"].append(spec)
        _progress(
            f"[seed {seed}] baseline p50 {base['suggest']['p50_ms']:.0f} ms | speculative "
            f"hit p50 {spec['hit_suggest']['p50_ms']:.2f} ms | hits "
            f"{spec['hits']}/{spec['measured']} | bit-equal {equal}")

    hits_total = sum(r["hits"] for r in arms["speculative"])
    measured_total = sum(r["measured"] for r in arms["speculative"])
    base_final = [r["best_curve"][-1] for r in arms["baseline"]]
    spec_final = [r["best_curve"][-1] for r in arms["speculative"]]
    hit_p50s = [r["hit_suggest"]["p50_ms"] for r in arms["speculative"]]
    hit_p99s = [r["hit_suggest"]["p99_ms"] for r in arms["speculative"]]
    base_p50s = [r["suggest"]["p50_ms"] for r in arms["baseline"]]
    base_p99s = [r["suggest"]["p99_ms"] for r in arms["baseline"]]
    return {
        "workload": {
            "trials": args.trials,
            "seeds": args.seeds,
            "dim": args.dim,
            "warmup_excluded": args.warmup,
            "algorithm": "DEFAULT (GP-UCB-PE)",
            "acquisition_evals": args.acquisition_evals,
            "evaluation_model": (
                f"sleep {args.think_time}s" if args.think_time > 0
                else "wait_idle (evaluation outlasts pre-compute)"
            ),
            "backend": backend(device),
        },
        "speculative_config": spec_lib.SpeculativeConfig(speculative=True).as_dict(),
        "baseline_suggest_p50_ms": round(sum(base_p50s) / len(base_p50s), 3),
        "baseline_suggest_p99_ms": round(max(base_p99s), 3),
        "speculative_hit_p50_ms": round(sum(hit_p50s) / len(hit_p50s), 4),
        "speculative_hit_p99_ms": round(max(hit_p99s), 4),
        "speedup_p50": round(
            (sum(base_p50s) / len(base_p50s)) / max(sum(hit_p50s) / len(hit_p50s), 1e-9), 1),
        "hit_rate": round(hits_total / max(measured_total, 1), 4),
        "bit_identical_trajectories": f"{sum(bit_equal)}/{len(bit_equal)}",
        "regret_parity": {
            "baseline_final_best": base_final,
            "speculative_final_best": spec_final,
            "ranksum_p": round(_ranksum_p(base_final, spec_final), 4),
        },
        "acceptance": {
            "hit_p50_under_10ms": all(p < 10.0 for p in hit_p50s),
            "hit_rate_ge_80pct": hits_total / max(measured_total, 1) >= 0.80,
            "bit_equal_all_seeds": all(bit_equal),
        },
        "per_seed": {
            arm: [{k: v for k, v in row.items() if k != "trajectory"} for row in rows]
            for arm, rows in arms.items()
        },
        "wall_seconds": round(time.time() - t_start, 1),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3,
                    help="suggests excluded from latency stats (first uses)")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="fixed evaluation sleep instead of wait_idle")
    ap.add_argument("--acquisition-evals", type=int, default=1000,
                    help="acquisition sweep budget (0 = designer default)")
    ap.add_argument("--transport", choices=TRANSPORTS, default="service",
                    help="service (protobuf servicers, the default) or runtime (no protobuf)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    write_report(run(args), args.out)


if __name__ == "__main__":
    main()
