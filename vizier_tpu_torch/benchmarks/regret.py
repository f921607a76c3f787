"""The DEFAULT designer's regret on shifted BBOB, held to the JAX package's.

    python -m vizier_tpu_torch.benchmarks.regret [--mode lockstep|sequential]
        [--trials 150] [--batch 10] [--evals 25000] [--seeds 1 2 3 4 5]
        [--device cuda] [--out FILE]

The loop of the repo's ``tools/budget_policy_ab.py`` (its ``first_pick_full``
policy) on the port: for each of Sphere20d, Rastrigin20d and Branin2d
(``experimenter_factory.shifted_bbob_instance``) and each seed, a
``VizierGPUCBPEBandit`` built exactly as that loop builds it (``rng_seed`` =
seed, ``max_acquisition_evaluations``, ``num_seed_trials=5``,
``acquisition_budget_policy="first_pick_full"``) takes rounds of ``suggest``,
``to_trial``, ``evaluate`` and ``update(CompletedTrials)`` until it has
``trials`` trials. A run's final regret is its best value minus the
function's optimum.

Two modes:

- ``sequential``: one study after another, each through
  ``BenchmarkState.from_designer_factory`` (``InRamDesignerPolicy`` on an
  ``InRamPolicySupporter``) and ``BenchmarkRunner([GenerateAndEvaluate])``.
- ``lockstep``: function after function, every seed's round-r suggest is
  submitted at once, one thread per study, to one ``BatchExecutor`` (8
  slots, a 2 s window): a function's seeds share a padding bucket, so each
  round is one flush, one device program for all of them. The seed round
  (no completed trials) is unbatchable and runs on each study's thread. On
  the CPU a flush slot equals its study run alone, so the two modes give
  the same trials.

The JSON report has the schema of the repo's ``budget_ab_r5.json`` (``seeds``,
``trials``, ``batch``, ``evals``, ``per_run``, ``median_final_regret``) plus
the device, the wall time per run and per round, and per function the
executor's flushes, occupancy, fallbacks and slot errors, the float64
refactors of ``gp.posterior_cholesky``, and K1/K2 launches by mode. :func:`parity` holds
the runs to that file's ``first_pick_full`` rows: an exact one-sided
Mann-Whitney test per function (the port's regrets greater than the
reference's), and for Branin, whose reference is rounded to 4 places and
mostly 0.0, the port's median against ``BRANIN_MEDIAN_LIMIT``. The command
exits 0 when every gate holds, 1 when one fails, and 2 when the run's seeds,
trials, batch or evals are not the reference's, so that no gate applies.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import stats as scipy_stats

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.benchmarks.analyzers import convergence_curve
from vizier_tpu_torch.benchmarks.experimenters import base, experimenter_factory
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob, multiobjective
from vizier_tpu_torch.benchmarks.runners import benchmark_runner, benchmark_state
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.designers import eagle_strategy, evolution, gp_bandit, gp_ucb_pe
from vizier_tpu_torch.designers import random as random_designer
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.pyvizier import base_study_config, parameter_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.serving import stats as stats_lib

FUNCTIONS: Tuple[Tuple[str, int], ...] = (("Sphere", 20), ("Rastrigin", 20), ("Branin", 2))
# The optimum value of each objective (a shift moves the argmin, not the
# minimum); Branin's in the BBOB frame is 0.397887 (synthetic/bbob.py).
OPTIMA = {"Sphere": 0.0, "Rastrigin": 0.0, "Branin": 0.3978873577}
METRIC = "bbob_eval"
POLICY = "first_pick_full"
REFERENCE = pathlib.Path(__file__).resolve().parents[2] / "budget_ab_r5.json"
# Gates: the one-sided exact p-value below which the port's regrets count as
# greater than the reference's (5 against 5: the smallest p is 1/252), and
# Branin's median final regret (the reference's worst run is 3e-4).
P_LIMIT = 0.01
BRANIN_MEDIAN_LIMIT = 1e-3
# The executor of the lockstep mode, as the serving phases run it.
LOCKSTEP_BATCH = 8
LOCKSTEP_WINDOW_MS = 2000.0


def make_designer(problem, seed: int, evals: int, device="cuda") -> gp_ucb_pe.VizierGPUCBPEBandit:
    """The designer of ``tools/budget_policy_ab.py``'s ``first_pick_full`` run."""
    return gp_ucb_pe.VizierGPUCBPEBandit(
        problem,
        rng_seed=seed,
        max_acquisition_evaluations=evals,
        num_seed_trials=5,
        acquisition_budget_policy=POLICY,
        device=device,
    )


@dataclasses.dataclass
class Run:
    """One (function, seed) study: its trials and the wall time of each round."""

    fn: str
    dim: int
    seed: int
    trials: List[trial_.Trial] = dataclasses.field(default_factory=list)
    round_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return f"{self.fn}{self.dim}d"

    @property
    def regret(self) -> float:
        best = min(t.final_measurement.metrics[METRIC].value for t in self.trials)
        return best - OPTIMA[self.fn]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_suggestions(trials: Sequence[trial_.Trial], problem, label: str) -> None:
    """Every suggested parameter finite and inside its bounds (a feasible
    value for a categorical or discrete one)."""
    finite_domain = (parameter_config.ParameterType.CATEGORICAL,
                     parameter_config.ParameterType.DISCRETE)
    for t in trials:
        for config in problem.search_space.parameters:
            v = t.parameters.get_value(config.name)
            if config.type in finite_domain:
                ok = v in config.feasible_values
            else:
                v = float(v)
                ok = math.isfinite(v) and config.bounds[0] <= v <= config.bounds[1]
            if not ok:
                raise AssertionError(f"{label}: {config.name}={v!r} is not a feasible value")


class _RoundClock(benchmark_runner.BenchmarkSubroutine):
    """Records the wall time of each runner round (after the device is done)."""

    def __init__(self, run: Run, device):
        self._run, self._device = run, device
        self._last = time.perf_counter()

    def run(self, state: benchmark_state.BenchmarkState) -> None:
        _sync(self._device)
        now = time.perf_counter()
        self._run.round_s.append(now - self._last)
        self._last = now


def run_sequential(fn: str, dim: int, seeds, trials: int, batch: int, evals: int,
                   device) -> Tuple[List[Run], dict]:
    """Each seed's study alone, through the benchmark runner."""
    runs: List[Run] = []
    for seed in seeds:
        run = Run(fn, dim, seed)
        exp = experimenter_factory.shifted_bbob_instance(fn, seed, dim=dim)
        state = benchmark_state.BenchmarkState.from_designer_factory(
            exp, lambda problem, seed: make_designer(problem, seed, evals, device), seed=seed)
        runner = benchmark_runner.BenchmarkRunner(
            [benchmark_runner.GenerateAndEvaluate(batch), _RoundClock(run, device)],
            num_repeats=trials // batch)
        runner.run(state)
        run.trials = state.algorithm.supporter.GetTrials(
            status_matches=trial_.TrialStatus.COMPLETED)
        check_suggestions(run.trials, exp.problem_statement(), f"{run.name} seed {seed}")
        runs.append(run)
    return runs, {}


_EXECUTOR_FIELDS = ("batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors")


def make_executor() -> Tuple[batch_executor.BatchExecutor, stats_lib.ServingStats]:
    """The lockstep mode's executor and the counters it keeps."""
    serving_stats = stats_lib.ServingStats()
    executor = batch_executor.BatchExecutor(
        max_batch_size=LOCKSTEP_BATCH, max_wait_ms=LOCKSTEP_WINDOW_MS, stats=serving_stats)
    return executor, serving_stats


def run_lockstep(fn: str, dim: int, seeds, trials: int, batch: int, evals: int, device,
                 executor: batch_executor.BatchExecutor,
                 serving_stats: stats_lib.ServingStats) -> Tuple[List[Run], dict]:
    """Every seed's study advances one round at a time: the round's suggests
    are submitted at once, one thread per study, to ``executor`` (which
    counts into ``serving_stats``), where they share a bucket and flush
    together."""
    runs, studies = [], []
    for seed in seeds:
        exp = experimenter_factory.shifted_bbob_instance(fn, seed, dim=dim)
        runs.append(Run(fn, dim, seed))
        studies.append((exp, make_designer(exp.problem_statement(), seed, evals, device)))
    rounds = []
    while len(runs[0].trials) < trials:
        before = serving_stats.snapshot()
        results: List[Optional[list]] = [None] * len(runs)
        errors: List[BaseException] = []
        barrier = threading.Barrier(len(runs))

        def suggest(i: int) -> None:
            try:
                barrier.wait()
                results[i] = executor.suggest(studies[i][1], batch)
            except BaseException as e:  # raised below, on the main thread
                errors.append(e)

        start = time.perf_counter()
        threads = [threading.Thread(target=suggest, args=(i,)) for i in range(len(runs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync(device)
        wall = time.perf_counter() - start
        if errors:
            raise errors[0]
        delta = {k: serving_stats.get(k) - before[k] for k in _EXECUTOR_FIELDS}
        rounds.append(dict(trials=len(runs[0].trials), wall_s=wall, **delta))
        for run, (exp, designer), suggestions in zip(runs, studies, results):
            new = [s.to_trial(len(run.trials) + i + 1) for i, s in enumerate(suggestions)]
            check_suggestions(new, exp.problem_statement(), f"{run.name} seed {run.seed}")
            exp.evaluate(new)
            designer.update(core_lib.CompletedTrials(new))
            run.trials.extend(new)
            run.round_s.append(wall)
        if len({len(run.trials) for run in runs}) != 1:
            raise AssertionError("the studies fell out of lockstep")
    totals = {k: sum(r[k] for r in rounds) for k in _EXECUTOR_FIELDS}
    totals["occupancy"] = totals["batched_suggests"] / max(totals["batch_flushes"], 1)
    return runs, dict(executor=dict(rounds=rounds, **totals))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _launches() -> Dict[str, Dict[str, int]]:
    return {name: dict(m) for name, m in kernels.LAUNCHES_BY_MODE.items()}


def _minus(after: Dict[str, Dict[str, int]], before: Dict[str, Dict[str, int]]):
    return {name: {m: n - before[name][m] for m, n in modes.items()}
            for name, modes in after.items()}


def run(mode: str, functions=FUNCTIONS, seeds=(1, 2, 3, 4, 5), trials: int = 150,
        batch: int = 10, evals: int = 25_000, device="cuda") -> dict:
    """One mode's runs, function after function, as a report
    (``budget_ab_r5.json``'s schema, and per function its wall time, float64
    refactors, K1/K2 launches by mode and, in lockstep, the executor's
    rounds)."""
    executor, serving_stats = make_executor() if mode == "lockstep" else (None, None)
    kernels.reset_launch_counts()
    start = time.perf_counter()
    runs: List[Run] = []
    by_function = {}
    try:
        for fn, dim in functions:
            refactors, launches = dict(gp_lib.FLOAT64_REFACTORS), _launches()
            t0 = time.perf_counter()
            if mode == "lockstep":
                fn_runs, extra = run_lockstep(fn, dim, seeds, trials, batch, evals, device,
                                              executor, serving_stats)
            elif mode == "sequential":
                fn_runs, extra = run_sequential(fn, dim, seeds, trials, batch, evals, device)
            else:
                raise ValueError(f"mode must be 'lockstep' or 'sequential', got {mode!r}")
            _sync(device)
            by_function[fn_runs[0].name] = dict(
                wall_s=time.perf_counter() - t0,
                float64_refactors={k: gp_lib.FLOAT64_REFACTORS[k] - refactors[k]
                                   for k in refactors},
                launches_by_mode=_minus(_launches(), launches), **extra)
            runs.extend(fn_runs)
    finally:
        if executor is not None:
            executor.close()
    wall = time.perf_counter() - start
    per_run: Dict[str, List[float]] = {}
    for r in runs:
        per_run.setdefault(f"{r.name}:{POLICY}", []).append(r.regret)
    device_info = {"type": torch.device(device).type}
    if device_info["type"] == "cuda":
        device_info.update(card=card_line(), kind=torch.cuda.get_device_name(0))
    return dict(
        seeds=list(seeds), trials=trials, batch=batch, evals=evals,
        per_run=per_run,
        median_final_regret={k: float(np.median(v)) for k, v in per_run.items()},
        mode=mode,
        device=device_info,
        wall_s=wall,
        run_wall_s={f"{r.name}:{r.seed}": sum(r.round_s) for r in runs},
        round_wall_s={f"{r.name}:{r.seed}": r.round_s for r in runs},
        launches_by_mode=_launches(),
        by_function=by_function,
    )


class NotComparable(ValueError):
    """The report was not run at the reference's configuration."""


def parity(report: dict, reference_path=REFERENCE) -> Dict[str, dict]:
    """Each function's runs against the reference's ``first_pick_full`` rows.

    ``passed`` is the gate: for Branin the port's median within
    ``BRANIN_MEDIAN_LIMIT``; for the others the exact one-sided Mann-Whitney
    p-value (port greater than reference) at least ``P_LIMIT``. Raises
    ``NotComparable`` unless the report's seeds, trials, batch and evals are
    the reference's.
    """
    reference_file = json.loads(pathlib.Path(reference_path).read_text())
    differ = {key: (report.get(key), reference_file[key])
              for key in ("seeds", "trials", "batch", "evals")
              if report.get(key) != reference_file[key]}
    if differ:
        raise NotComparable(f"(run, reference) differ at {differ}: no parity gate applies")
    reference = reference_file["per_run"]
    out = {}
    for key, port in report["per_run"].items():
        ref = reference[key]
        port_median = float(np.median(port))
        p = float(scipy_stats.mannwhitneyu(port, ref, alternative="greater", method="exact").pvalue)
        if key.startswith("Branin"):
            gate, passed = f"median <= {BRANIN_MEDIAN_LIMIT}", port_median <= BRANIN_MEDIAN_LIMIT
        else:
            gate, passed = f"p >= {P_LIMIT}", p >= P_LIMIT
        out[key] = dict(port=port, reference=ref, port_median=port_median,
                        reference_median=float(np.median(ref)), p=p, gate=gate, passed=passed)
    return out


# -- the GP-bandit, mixed-space and two-objective configs of regret_suite.py --
#
# The repo's ``regret_suite.py`` runs these through the JAX package's runner
# (``BenchmarkState.from_designer_factory``, ``BenchmarkRunner([
# GenerateAndEvaluate(batch)], num_repeats=trials // batch)``); here the
# port's runner drives the port's designers with the same settings.


def _run_suite(experimenter, designer_factory, trials: int, batch: int, seed: Optional[int]):
    state = benchmark_state.BenchmarkState.from_designer_factory(
        experimenter, designer_factory, seed=seed)
    benchmark_runner.BenchmarkRunner(
        [benchmark_runner.GenerateAndEvaluate(batch)], num_repeats=max(trials // batch, 1)
    ).run(state)
    completed = state.algorithm.supporter.GetTrials(status_matches=trial_.TrialStatus.COMPLETED)
    check_suggestions(completed, experimenter.problem_statement(), f"seed {seed}")
    return completed


def branin_gp_ucb(seed: int, trials: int = 32, batch: int = 2, evals: int = 10_000,
                  device="cuda") -> float:
    """GAUSSIAN_PROCESS_BANDIT on Branin in the BBOB frame: the best value."""
    exp = base.NumpyExperimenter(bbob.Branin, base.bbob_problem(2, metric_name=METRIC))
    completed = _run_suite(exp, lambda p, seed=None: gp_bandit.VizierGPBandit(
        p, rng_seed=seed or 0, max_acquisition_evaluations=evals, num_seed_trials=5,
        device=device), trials, batch, seed)
    return min(t.final_measurement.metrics[METRIC].value for t in completed)


def mixed_problem() -> base_study_config.ProblemStatement:
    """The README's mixed space: a log-scaled float, an integer and a
    categorical, accuracy to MAXIMIZE."""
    problem = base_study_config.ProblemStatement()
    root = problem.search_space.root
    root.add_float_param("lr", 1e-4, 1e-1, scale_type=parameter_config.ScaleType.LOG)
    root.add_int_param("layers", 1, 8)
    root.add_categorical_param("opt", ["adam", "sgd", "rmsprop"])
    problem.metric_information.append(base_study_config.MetricInformation(
        name="acc", goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE))
    return problem


class MixedExperimenter(base.Experimenter):
    """regret_suite.py's mixed-space objective (optimum 1.05 at lr = 1e-2,
    4 layers, adam)."""

    def evaluate(self, suggestions):
        for t in suggestions:
            lr = t.parameters.get_value("lr")
            layers = t.parameters.get_value("layers")
            opt = t.parameters.get_value("opt")
            acc = (1.0 - (np.log10(lr) + 2.0) ** 2 * 0.2 - 0.03 * abs(layers - 4)
                   + (0.05 if opt == "adam" else 0.0))
            t.complete(trial_.Measurement(metrics={"acc": acc}))

    def problem_statement(self):
        return mixed_problem()


def mixed_default_ucbpe(seed: int, trials: int = 30, batch: int = 3, evals: int = 5_000,
                        device="cuda") -> float:
    """The DEFAULT designer on the mixed space: the best accuracy."""
    completed = _run_suite(MixedExperimenter(), lambda p, seed=None: gp_ucb_pe.VizierGPUCBPEBandit(
        p, rng_seed=seed or 0, max_acquisition_evaluations=evals, num_seed_trials=5,
        device=device), trials, batch, seed)
    return max(t.final_measurement.metrics["acc"].value for t in completed)


def zdt1_gp_hv_ucb(trials: int = 60, batch: int = 5, evals: int = 10_000, dimension: int = 6,
                   device="cuda") -> Tuple[float, List[trial_.Trial]]:
    """GAUSSIAN_PROCESS_BANDIT (HV-scalarized UCB) on ZDT1: the final
    hypervolume against the reference point (-1.1, -6.0) of the negated
    objectives, and the completed trials. As in regret_suite.py the factory
    is called without a seed (rng_seed 0)."""
    exp = multiobjective.MultiObjectiveExperimenter.zdt("zdt1", dimension=dimension)
    completed = _run_suite(exp, lambda p: gp_bandit.VizierGPBandit(
        p, rng_seed=0, max_acquisition_evaluations=evals, num_seed_trials=5, device=device),
        trials, batch, seed=None)
    curve = convergence_curve.HypervolumeCurveConverter(
        list(exp.problem_statement().metric_information),
        reference_point=np.array([-1.1, -6.0], dtype=np.float32)).convert(completed)
    return float(curve.ys[0, -1]), completed


# -- regret_suite.py's baselines: Random, Eagle and NSGA2 ---------------------
#
# Each with the seed passed to the designer (regret_suite.py fixes Eagle's and
# NSGA2's at 0), held to the JAX package's 5-seed runs of the same configs,
# ``BASELINES_REFERENCE``, by the same exact one-sided rank test.

BASELINES_REFERENCE = pathlib.Path(__file__).resolve().parents[2] / (
    "regret_suite_baselines_5seed.json")
ZDT1_REFERENCE_POINT = (-1.1, -6.0)


def branin_random(seed: int, trials: int = 32, batch: int = 2) -> float:
    """RANDOM_SEARCH on Branin in the BBOB frame: the best value."""
    exp = base.NumpyExperimenter(bbob.Branin, base.bbob_problem(2, metric_name=METRIC))
    completed = _run_suite(exp, lambda p, seed=None: random_designer.RandomDesigner(
        p.search_space, seed=seed), trials, batch, seed)
    return min(t.final_measurement.metrics[METRIC].value for t in completed)


def eagle_20d_bbob(fn: str, seed: int, trials: int = 200, batch: int = 10) -> float:
    """EAGLE_STRATEGY on a 20-D BBOB function ("Sphere", "Rastrigin"): the
    best value."""
    exp = base.NumpyExperimenter(bbob.BBOB_FUNCTIONS[fn], base.bbob_problem(20))
    completed = _run_suite(exp, lambda p, seed=None: eagle_strategy.EagleStrategyDesigner(
        p, seed=seed), trials, batch, seed)
    return min(t.final_measurement.metrics[METRIC].value for t in completed)


def hypervolume_2d(points: np.ndarray, reference: Sequence[float]) -> float:
    """The exact hypervolume of ``[N, 2]`` all-MAXIMIZE points above
    ``reference`` (float64; rows not above it in both coordinates add
    nothing)."""
    shifted = np.asarray(points, np.float64) - np.asarray(reference, np.float64)
    shifted = shifted[np.all(shifted > 0.0, axis=1)]
    if not len(shifted):
        return 0.0
    order = np.argsort(-shifted[:, 0], kind="stable")
    x = shifted[order, 0]
    y = np.maximum.accumulate(shifted[order, 1])
    widths = x - np.append(x[1:], 0.0)
    return float(np.sum(widths * y))


def zdt1_nsga2(seed: int, trials: int = 60, batch: int = 5, population_size: int = 20,
               dimension: int = 6, device="cuda") -> Tuple[float, List[trial_.Trial]]:
    """NSGA2 on ZDT1: the exact hypervolume of the completed trials' negated
    objectives against ``ZDT1_REFERENCE_POINT``, and the completed trials."""
    exp = multiobjective.MultiObjectiveExperimenter.zdt("zdt1", dimension=dimension)
    completed = _run_suite(exp, lambda p, seed=None: evolution.NSGA2Designer(
        p, population_size=population_size, seed=seed, device=device), trials, batch, seed)
    metrics = base_study_config.MetricsConfig(exp.problem_statement().metric_information)
    points = converters.MetricsEncoder(metrics).encode(completed)
    return hypervolume_2d(points, ZDT1_REFERENCE_POINT), completed


# The baselines of ``BASELINES_REFERENCE``: name -> (run(seed, device) ->
# value, the direction in which the port's values would be worse).
BASELINES = {
    "branin_random": (lambda seed, device: branin_random(seed), "greater"),
    "eagle_20d_bbob_Sphere": (lambda seed, device: eagle_20d_bbob("Sphere", seed), "greater"),
    "eagle_20d_bbob_Rastrigin": (lambda seed, device: eagle_20d_bbob("Rastrigin", seed),
                                 "greater"),
    "zdt1_nsga2": (lambda seed, device: zdt1_nsga2(seed, device=device)[0], "less"),
}


def baseline_parity(values: Dict[str, List[float]],
                    reference_path=BASELINES_REFERENCE) -> Dict[str, dict]:
    """Each baseline's per-seed values against the reference's: the exact
    one-sided Mann-Whitney p-value that the port's are worse (greater
    regret, smaller hypervolume); ``passed`` when p >= ``P_LIMIT``."""
    reference = json.loads(pathlib.Path(reference_path).read_text())
    out = {}
    for name, port in values.items():
        worse = BASELINES[name][1]
        ref = reference["configs"][name]["per_seed"]
        p = float(scipy_stats.mannwhitneyu(port, ref, alternative=worse, method="exact").pvalue)
        out[name] = dict(port=port, reference=ref, p=p, gate=f"p >= {P_LIMIT}",
                         passed=p >= P_LIMIT,
                         max_abs_diff=max(abs(a - b) for a, b in zip(port, ref)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("lockstep", "sequential"), default="lockstep")
    parser.add_argument("--trials", type=int, default=150)
    parser.add_argument("--batch", type=int, default=10)
    parser.add_argument("--evals", type=int, default=25_000)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="where to write the JSON report")
    args = parser.parse_args(argv)
    report = run(args.mode, FUNCTIONS, args.seeds, args.trials, args.batch, args.evals,
                 args.device)
    try:
        report["parity"] = parity(report)
    except NotComparable as e:
        report["parity"] = None
        print(f"not at the reference's configuration, {e}")
    for key, row in (report["parity"] or {}).items():
        print(f"{key}: port {[round(v, 4) for v in row['port']]} (median "
              f"{row['port_median']:.6g}), reference {row['reference']} (median "
              f"{row['reference_median']:.6g}), one-sided exact p {row['p']:.4f}, gate "
              f"{row['gate']}: {'passed' if row['passed'] else 'FAILED'}")
    text = json.dumps(report)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    if report["parity"] is None:
        return 2
    return 0 if all(row["passed"] for row in report["parity"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
