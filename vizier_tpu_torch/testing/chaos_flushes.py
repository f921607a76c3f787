"""Chaos strikes through the port's batch executor, on any device.

A harness of the port's own (the JAX package keeps these cases in its
executor tests), shared by the CPU tests, the card's tests and
``chip_smoke.py``. GP-bandit designers with a seeded frontier are wrapped in
``ChaosDesigner`` and sent through one ``BatchExecutor``:

- :func:`per_slot_strike`: a flush of three where the first slot's
  ``finalize`` strikes; that slot alone degrades (``FailedSuggestError``)
  and the other two slots' suggestions equal those of the same flush with
  nothing struck.
- :func:`device_program_strike`: a flush of two whose device program
  strikes; both slots recover through the executor's whole-batch
  sequential fallback, each equal to its study's own ``suggest`` after the
  flush's prepare.

In both the executor's counters equal the monkey's injected strikes.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.serving.stats import ServingStats
from vizier_tpu_torch.testing import chaos
from vizier_tpu_torch.testing import failing

_DIM = 3
_TRIALS = 12


def _problem() -> vz.ProblemStatement:
    problem = vz.ProblemStatement()
    for j in range(_DIM):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return problem


def designer(device, seed: int) -> gp_bandit.VizierGPBandit:
    """A GP bandit on ``device`` that has seen ``_TRIALS`` seeded trials."""
    d = gp_bandit.VizierGPBandit(
        _problem(), device=device, rng_seed=seed, ard_restarts=2,
        ard_optimizer=lbfgs.AdamOptimizer(maxiter=10, device=device),
        max_acquisition_evaluations=100,
    )
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(_TRIALS):
        x = rng.uniform(size=_DIM)
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(_DIM)})
        t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.4) ** 2))}))
        trials.append(t)
    d.update(vz.CompletedTrials(trials))
    return d


def _unstruck(designer_: chaos.ChaosDesigner) -> None:
    """Lets the designer's prepare and device program pass unstruck (per-test
    instance patches, as the JAX package's chaos tests make them)."""
    designer_.batch_prepare = lambda count=None: designer_._inner_program(count).prepare(
        designer_._inner, count or 1)
    designer_.batch_execute = lambda items, pad_to=None, placement=None: (
        designer_._inner_program().device_program(items, pad_to=pad_to, placement=placement))


def _flush(executor: BatchExecutor, designers, count: int = 1):
    """Submits ``designers`` one after another (each waits until the one
    before it is queued, so the slot order is the list's) and joins them."""
    results, errors = [None] * len(designers), [None] * len(designers)

    def run(i):
        try:
            results[i] = executor.suggest(designers[i], count)
        except BaseException as e:  # noqa: BLE001 - the caller reads it
            errors[i] = e

    threads = []
    for i in range(len(designers)):
        threads.append(threading.Thread(target=run, args=(i,)))
        threads[-1].start()
        deadline = time.monotonic() + 60.0
        while (i + 1 < len(designers) and time.monotonic() < deadline
               and sum(executor.pending_counts().values()) < i + 1):
            time.sleep(0.002)
    for t in threads:
        t.join(timeout=600)
    return results, errors


def _params(suggestions):
    return [s.parameters.as_dict() for s in suggestions]


def per_slot_strike(device, seeds=(51, 52, 53)) -> dict:
    """The per-slot case; raises AssertionError on any departure."""
    outcomes = {}
    for struck in (False, True):
        monkey = chaos.ChaosMonkey(seed=0, failure_prob=1.0 if struck else 0.0)
        calm = chaos.ChaosMonkey(seed=0, failure_prob=0.0)
        wrapped = [chaos.ChaosDesigner(designer(device, s), monkey if i == 0 else calm)
                   for i, s in enumerate(seeds)]
        for d in wrapped:
            _unstruck(d)  # only the first slot's finalize can strike
        stats = ServingStats()
        executor = BatchExecutor(max_batch_size=len(seeds), max_wait_ms=60_000, stats=stats)
        try:
            results, errors = _flush(executor, wrapped)
        finally:
            executor.close()
        outcomes[struck] = (results, errors, stats.snapshot(), monkey.counts())
    base_results, base_errors, base_stats, _ = outcomes[False]
    results, errors, snap, counts = outcomes[True]
    if any(base_errors) or base_stats["batched_suggests"] != len(seeds):
        raise AssertionError(f"the unstruck flush failed: {base_errors} {base_stats}")
    if not isinstance(errors[0], failing.FailedSuggestError) or any(errors[1:]):
        raise AssertionError(f"not exactly the struck slot degraded: {errors}")
    faults = counts["designer.batch_finalize"]["faults"]
    if (faults != 1 or snap["batch_flushes"] != 1 or snap["batch_slot_errors"] != faults
            or snap["batched_suggests"] != len(seeds) - faults or snap["batch_fallbacks"]):
        raise AssertionError(f"counters {snap} against strikes {counts}")
    return dict(faults=faults, counters=snap, errors=[repr(e) for e in errors],
                equal=[_params(results[i]) == _params(base_results[i])
                       for i in range(1, len(seeds))])


def _suggest_after_prepare(designer_):
    """The study's sequential suggest once its flush's prepare has drawn
    from its seed stream: what the sequential fallback computes."""
    from vizier_tpu_torch.compute import registry

    program, _ = registry.resolve(designer_, 1)
    program.prepare(designer_, 1)
    return designer_.suggest(1)


def device_program_strike(device, seeds=(61, 62)) -> dict:
    """The device-program case; raises AssertionError on any departure."""
    monkey = chaos.ChaosMonkey(seed=0, failure_prob=1.0)
    wrapped = [chaos.ChaosDesigner(designer(device, s), monkey) for s in seeds]
    for d in wrapped:
        # Prepare and the sequential suggest pass; the first slot's device
        # program (the flush's) strikes.
        d.batch_prepare = (lambda d_: lambda count=None: d_._inner_program(count).prepare(
            d_._inner, count or 1))(d)
        d.suggest = d._inner.suggest
    alone = [_suggest_after_prepare(designer(device, s)) for s in seeds]
    stats = ServingStats()
    executor = BatchExecutor(max_batch_size=len(seeds), max_wait_ms=60_000, stats=stats)
    try:
        results, errors = _flush(executor, wrapped)
    finally:
        executor.close()
    snap, counts = stats.snapshot(), monkey.counts()
    if any(errors):
        raise AssertionError(f"a slot was lost after the device-program strike: {errors}")
    faults = counts["designer.batch_execute"]["faults"]
    if faults != 1 or snap["batch_fallbacks"] != len(seeds) or snap["batched_suggests"]:
        raise AssertionError(f"counters {snap} against strikes {counts}")
    return dict(faults=faults, counters=snap,
                equal=[_params(r) == _params(a) for r, a in zip(results, alone)])
