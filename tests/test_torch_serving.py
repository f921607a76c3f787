"""The port's serving path on the CPU: executor, config, factory, policy.

Mirrors the JAX package's ``tests/parallel/test_batch_executor.py`` (the
executor's mechanics, with stub programs) and
``tests/serving/test_batching_integration.py`` (concurrent studies sharing
one flush through ``CachedDesignerStatePolicy`` and ``InRamPolicySupporter``),
and holds the port's ``ServingConfig``, ``ServingStats`` and policy factory
to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.serving import config as jserving_config
from vizier_tpu.serving import stats as jserving_stats
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.algorithms import designer_policy
from vizier_tpu_torch.compute import ir
from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor, BatchSlotError
from vizier_tpu_torch.pythia import local_policy_supporters, policy as policy_lib
from vizier_tpu_torch.pyvizier import study_config
from vizier_tpu_torch.service import policy_factory
from vizier_tpu_torch.serving import config as serving_config
from vizier_tpu_torch.serving import policy as serving_policy
from vizier_tpu_torch.serving import runtime as serving_runtime
from vizier_tpu_torch.serving import stats as serving_stats


# -- the executor, with stub programs ------------------------------------------


def _stub_suggestion(value):
    return vz.TrialSuggestion(parameters={"x": float(value)})


class _StubProgram(ir.DesignerProgram):
    kind = "stub"

    def bucket_key(self, designer, count):
        if not designer.batchable:
            return None
        return ir.BucketKey("stub", 8, 1, 0, 1, count, statics=(designer.group,))

    def prepare(self, designer, count):
        if designer.fail_prepare:
            raise RuntimeError("prepare exploded")
        return dict(designer=designer, count=count, value=designer.value)

    def device_program(self, items, pad_to=None):
        d0 = items[0]["designer"]
        d0.pad_to.append(pad_to)
        if d0.fail_execute:
            raise RuntimeError("device program exploded")
        return [dict(value=item["value"]) for item in items]

    def finalize(self, designer, item, output):
        designer.batched = True
        value = float("nan") if designer.nan else output["value"]
        return [_stub_suggestion(value)] * item["count"]


_PROGRAM = _StubProgram()


class _Stub:
    """A designer whose compute is the stub program."""

    def __init__(self, value, group="g", batchable=True, fail_prepare=False, fail_execute=False,
                 nan=False):
        self.value, self.group, self.batchable = value, group, batchable
        self.fail_prepare, self.fail_execute, self.nan = fail_prepare, fail_execute, nan
        self.sequential_calls = 0
        self.batched = False
        self.pad_to = []

    def compute_program(self, count):
        key = _PROGRAM.bucket_key(self, count)
        return None if key is None else (_PROGRAM, key)

    def suggest(self, count=1):
        self.sequential_calls += 1
        return [_stub_suggestion(self.value)] * (count or 1)


def _run_concurrent(executor, designers, count=1):
    results, errors = [None] * len(designers), [None] * len(designers)

    def run(i):
        try:
            results[i] = executor.suggest(designers[i], count)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(designers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results, errors


def test_full_flush_batches_demuxes_and_pads():
    stats = serving_stats.ServingStats()
    ex = BatchExecutor(max_batch_size=3, max_wait_ms=5000, stats=stats, metrics=stats.registry)
    try:
        designers = [_Stub(v) for v in (0.1, 0.2, 0.3)]
        results, errors = _run_concurrent(ex, designers)
        assert errors == [None, None, None]
        for d, r in zip(designers, results):
            assert r[0].parameters.as_dict()["x"] == pytest.approx(d.value)
            assert d.batched and d.sequential_calls == 0
        snap = stats.snapshot()
        assert snap["batch_flushes"] == 1 and snap["batched_suggests"] == 3
        text = stats.registry.prometheus_text()
        assert "vizier_batch_occupancy" in text and 'reason="full"' in text
        assert sum((d.pad_to for d in designers), []) == [3]
    finally:
        ex.close()


@pytest.mark.parametrize("pad_partial", [True, False])
def test_a_partial_flush_pads_to_the_batch_size(pad_partial):
    ex = BatchExecutor(max_batch_size=4, max_wait_ms=300, pad_partial=pad_partial)
    try:
        designers = [_Stub(v) for v in (0.1, 0.2)]
        _, errors = _run_concurrent(ex, designers)
        assert errors == [None, None]
        assert sum((d.pad_to for d in designers), []) == [4 if pad_partial else None]
    finally:
        ex.close()


def test_a_timed_out_singleton_takes_the_sequential_path():
    stats = serving_stats.ServingStats()
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=10, stats=stats)
    try:
        d = _Stub(0.7)
        assert ex.suggest(d, 1)[0].parameters.as_dict()["x"] == pytest.approx(0.7)
        assert d.sequential_calls == 1 and not d.batched
        assert stats.snapshot()["batch_flushes"] == 1
    finally:
        ex.close()


def test_lone_slots_run_on_the_scheduler_and_later_arrivals_flush_together():
    """A lone slot's suggest runs on the scheduler thread (the port keeps
    every computation of the executor on one thread); the requests that
    arrive while it runs wait, and flush together after it."""
    stats = serving_stats.ServingStats()
    ex = BatchExecutor(max_batch_size=4, max_wait_ms=10, stats=stats)
    threads = {}

    class _Slow(_Stub):
        def suggest(self, count=1):
            threads["alone"] = threading.current_thread().name
            time.sleep(0.5)
            return super().suggest(count)

    try:
        first, later = _Slow(0.5), [_Stub(v) for v in (0.1, 0.2, 0.3)]
        t = threading.Thread(target=ex.suggest, args=(first, 1))
        t.start()
        time.sleep(0.1)
        _, errors = _run_concurrent(ex, later)
        t.join(timeout=30)
        assert errors == [None, None, None]
        assert threads["alone"] == "vizier-torch-batch-executor"
        assert first.sequential_calls == 1 and not first.batched
        assert all(d.batched and d.sequential_calls == 0 for d in later)
        snap = stats.snapshot()
        assert snap["batch_flushes"] == 2 and snap["batched_suggests"] == 3
    finally:
        ex.close()


def test_unbatchable_and_different_buckets_run_alone():
    ex = BatchExecutor(max_batch_size=2, max_wait_ms=50)
    try:
        lone = _Stub(0.4, batchable=False)
        assert len(ex.suggest(lone, 2)) == 2 and lone.sequential_calls == 1
        a, b = _Stub(0.1, group="g1"), _Stub(0.2, group="g2")
        _, errors = _run_concurrent(ex, [a, b])
        assert errors == [None, None]
        assert a.sequential_calls == 1 and b.sequential_calls == 1
    finally:
        ex.close()


def test_slot_isolation_prepare_fault_and_non_finite_result():
    stats = serving_stats.ServingStats()
    ex = BatchExecutor(max_batch_size=4, max_wait_ms=5000, stats=stats)
    try:
        good = [_Stub(0.1), _Stub(0.2)]
        designers = good + [_Stub(0.9, fail_prepare=True), _Stub(0.5, nan=True)]
        _, errors = _run_concurrent(ex, designers)
        assert errors[:2] == [None, None] and all(d.batched for d in good)
        assert isinstance(errors[2], RuntimeError)
        assert isinstance(errors[3], BatchSlotError) and "TRANSIENT" in str(errors[3])
        snap = stats.snapshot()
        assert snap["batch_slot_errors"] == 2 and snap["batched_suggests"] == 2
    finally:
        ex.close()


def test_a_failed_device_program_falls_back_per_slot_and_is_counted():
    stats = serving_stats.ServingStats()
    ex = BatchExecutor(max_batch_size=2, max_wait_ms=5000, stats=stats)
    try:
        designers = [_Stub(0.3, fail_execute=True), _Stub(0.6, fail_execute=True)]
        results, errors = _run_concurrent(ex, designers)
        assert errors == [None, None]
        for d, r in zip(designers, results):
            assert r[0].parameters.as_dict()["x"] == pytest.approx(d.value)
            assert d.sequential_calls == 1
        assert stats.snapshot()["batch_fallbacks"] == 2
    finally:
        ex.close()


def test_close_drains_pending():
    ex = BatchExecutor(max_batch_size=8, max_wait_ms=60_000)
    d = _Stub(0.8)
    out = [None]
    t = threading.Thread(target=lambda: out.__setitem__(0, ex.suggest(d, 1)))
    t.start()
    for _ in range(400):
        if ex.pending_counts():
            break
        time.sleep(0.005)
    ex.close()
    t.join(timeout=30)
    assert out[0] is not None and out[0][0].parameters.as_dict()["x"] == 0.8


def test_planes_that_are_not_ported_raise():
    # Every plane is ported, the multi-host coordinator seam too: a
    # coordinator without its process count and rank is an explicit init
    # that fails, and raises from the executor and from a batching runtime.
    from vizier_tpu_torch.parallel.mesh import MeshConfig

    coordinator = MeshConfig(enabled=True, coordinator_address="localhost:1234")
    with pytest.raises(ValueError, match="rendezvous"):
        BatchExecutor(mesh=coordinator, device="cpu")
    BatchExecutor(mesh=MeshConfig(enabled=True), device="cpu").close()
    # Prewarm and the compile cache are ported: both configs build.
    assert serving_config.ServingConfig(batching_prewarm=True).batching_prewarm
    assert serving_config.ServingConfig(
        compilation_cache_dir="/tmp/cache").compilation_cache_dir == "/tmp/cache"
    with pytest.raises(ValueError, match="rendezvous"):
        serving_runtime.ServingRuntime(serving_config.ServingConfig(batching=True),
                                       mesh=coordinator, device="cpu")
    # The ported planes build: an executor with fair-share admission, and a
    # runtime with speculation, admission and the SLO engine armed.
    from vizier_tpu_torch.observability import slo as slo_lib
    from vizier_tpu_torch.serving import admission as admission_lib
    from vizier_tpu_torch.serving import speculative as speculative_lib

    controller = admission_lib.AdmissionController(admission_lib.AdmissionConfig(enabled=True))
    BatchExecutor(admission=controller).close()
    rt = serving_runtime.ServingRuntime(
        serving_config.ServingConfig(batching=False),
        speculative=speculative_lib.SpeculativeConfig(speculative=True),
        admission=admission_lib.AdmissionConfig(enabled=True),
        slo=slo_lib.SloConfig(enabled=True, eval_interval_s=0.0),
    )
    assert rt.speculative_engine is not None and rt.admission is not None
    assert rt.slo_engine is not None and rt.slo_report()["armed"]
    rt.shutdown()


def test_the_suggest_latency_histogram_counts_what_the_jax_runtimes_counts():
    """The same observations into both runtimes: the accessor returns the
    histogram they land in, with the same series, counts, sums and p50."""
    from vizier_tpu.serving import runtime as jserving_runtime

    runtimes = [jserving_runtime.ServingRuntime(jserving_config.ServingConfig(batching=False)),
                serving_runtime.ServingRuntime(serving_config.ServingConfig(batching=False))]
    rng = np.random.default_rng(0)
    observations = [(hop, float(s)) for hop, s in zip(
        rng.choice(["service", "pythia"], size=40), rng.exponential(0.05, size=40))]
    try:
        for rt in runtimes:
            for hop, seconds in observations:
                rt.observe_suggest_latency(hop, seconds, trace_id=f"t{seconds:.6f}")
        jhist, thist = (rt.suggest_latency_histogram() for rt in runtimes)
        assert thist is runtimes[1]._suggest_latency
        assert thist.name == jhist.name == "vizier_suggest_latency_seconds"
        assert thist.series_data() == jhist.series_data()
        for hop in ("service", "pythia"):
            want = sum(h == hop for h, _ in observations)
            assert thist.count(hop=hop) == jhist.count(hop=hop) == want
            assert thist.sum(hop=hop) == jhist.sum(hop=hop)
            assert thist.percentile(50, hop=hop) == jhist.percentile(50, hop=hop)
    finally:
        for rt in runtimes:
            rt.shutdown()


# -- config and stats against the JAX package ------------------------------------


def test_serving_config_defaults_equal_the_jax_packages():
    assert dataclasses.asdict(serving_config.ServingConfig()) == dataclasses.asdict(
        jserving_config.ServingConfig())
    assert dataclasses.asdict(serving_config.ServingConfig.disabled()) == dataclasses.asdict(
        jserving_config.ServingConfig.disabled())


def test_serving_config_reads_the_ports_switches(monkeypatch):
    monkeypatch.setenv("VIZIER_TORCH_BATCHING", "0")
    monkeypatch.setenv("VIZIER_TORCH_BATCH_MAX_SIZE", "4")
    monkeypatch.setenv("VIZIER_BATCHING", "1")
    cfg = serving_config.ServingConfig.from_env()
    assert not cfg.batching and cfg.batch_max_size == 4 and cfg.designer_cache


def test_serving_stats_vocabulary_equals_the_jax_packages():
    assert serving_stats.ServingStats.FIELDS == jserving_stats.ServingStats.FIELDS


# -- the policy factory ----------------------------------------------------------


def _config(algorithm="DEFAULT", dims=2, metadata=None):
    cfg = study_config.StudyConfig(algorithm=algorithm)
    for j in range(dims):
        cfg.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    cfg.metric_information.append(vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    for key, value in (metadata or {}).items():
        cfg.metadata.ns("gp_ucb_pe")[key] = value
    return cfg


def _supporter(cfg, seed, n, guid):
    supporter = local_policy_supporters.InRamPolicySupporter(cfg, study_guid=guid)
    rng = np.random.default_rng(seed)
    trials = []
    for _ in range(n):
        x = rng.uniform(size=2)
        t = vz.Trial(parameters={"x0": float(x[0]), "x1": float(x[1])})
        t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.5) ** 2))}))
        trials.append(t)
    supporter.AddTrials(trials)
    return supporter


@pytest.mark.parametrize("algorithm,cls", [
    ("DEFAULT", gp_ucb_pe.VizierGPUCBPEBandit), ("GP_UCB_PE", gp_ucb_pe.VizierGPUCBPEBandit),
    ("ALGORITHM_UNSPECIFIED", gp_ucb_pe.VizierGPUCBPEBandit), (None, gp_ucb_pe.VizierGPUCBPEBandit),
    ("GAUSSIAN_PROCESS_BANDIT", gp_bandit.VizierGPBandit),
])
def test_the_factory_routes_the_gp_algorithms_through_the_designer_cache(algorithm, cls):
    runtime = serving_runtime.ServingRuntime(serving_config.ServingConfig(batching=False))
    factory = policy_factory.DefaultPolicyFactory(runtime, device="cpu")
    cfg = _config(algorithm or "DEFAULT")
    policy = factory(cfg, algorithm, _supporter(cfg, 0, 3, "s"), "s")
    assert isinstance(policy, serving_policy.CachedDesignerStatePolicy)
    designer = policy._designer_factory(cfg.to_problem())
    assert type(designer) is cls
    assert designer.device == torch.device("cpu") and designer.warm_ard_restarts == 1
    assert designer.use_warm_start_ard and designer.surrogate == runtime.surrogates


def test_the_factory_without_a_runtime_is_stateless_and_honors_the_metadata():
    cfg = _config(metadata={"acquisition_budget_policy": "per_pick",
                            "max_acquisition_evaluations": "300"})
    factory = policy_factory.DefaultPolicyFactory(device="cpu")
    policy = factory(cfg, "DEFAULT", _supporter(cfg, 0, 3, "s"), "s")
    assert isinstance(policy, designer_policy.DesignerPolicy)
    designer = policy._designer_factory(cfg.to_problem())
    assert designer.acquisition_budget_policy == "per_pick"
    assert designer.max_acquisition_evaluations == 300
    with pytest.raises(ValueError):
        factory(_config(metadata={"acquisition_budget_policy": "all_at_once"}), "DEFAULT",
                _supporter(cfg, 0, 3, "s"), "s")


def test_quasi_random_search_and_unported_algorithms():
    cfg = _config("QUASI_RANDOM_SEARCH")
    supporter = _supporter(cfg, 0, 0, "q")
    factory = policy_factory.DefaultPolicyFactory(device="cpu")
    policy = factory(cfg, "QUASI_RANDOM_SEARCH", supporter, "q")
    trials = supporter.SuggestTrials(policy, 3)
    assert len(trials) == 3
    # Served since the algorithms slice; PYGLOVE since the benchmark slice's
    # second part, for a study whose primary tuner registered a generator.
    for name in ("NSGA2", "CMA_ES", "EAGLE_STRATEGY", "RANDOM_SEARCH"):
        assert isinstance(factory(cfg, name, supporter, "q"), policy_lib.Policy)
    with pytest.raises(ValueError, match="No PyGlove generator registered for study 'q'"):
        factory(cfg, "PYGLOVE", supporter, "q")
    with pytest.raises(ValueError):
        factory(cfg, "NO_SUCH_ALGORITHM", supporter, "q")


# -- concurrent studies through CachedDesignerStatePolicy --------------------------


def _cheap_designer(problem):
    return gp_ucb_pe.VizierGPUCBPEBandit(
        problem, device="cpu", ard_restarts=2, max_acquisition_evaluations=200,
        warm_ard_restarts=1, warm_start_min_trials=0,
    )


def _serve_round(runtime, studies, concurrent):
    def one(i):
        cfg, supporter, name = studies[i]
        policy = serving_policy.CachedDesignerStatePolicy(
            supporter, _cheap_designer, runtime, name, use_seeding=True)
        return policy.suggest(policy_lib.SuggestRequest(
            study_descriptor=supporter.study_descriptor(), count=2)).suggestions

    if not concurrent:
        return [one(i) for i in range(len(studies))]
    out = [None] * len(studies)
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, one(i)))
               for i in range(len(studies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def _studies(tag):
    out = []
    for i in range(3):
        cfg = _config()
        out.append((cfg, _supporter(cfg, i, 12 + i, f"{tag}-{i}"), f"{tag}-{i}"))
    return out


def test_concurrent_studies_share_one_flush_and_match_batching_off():
    batched = serving_runtime.ServingRuntime(
        serving_config.ServingConfig(batch_max_size=3, batch_max_wait_ms=5000.0))
    alone = serving_runtime.ServingRuntime(serving_config.ServingConfig(batching=False))
    try:
        got = _serve_round(batched, _studies("b"), concurrent=True)
        want = _serve_round(alone, _studies("a"), concurrent=False)
    finally:
        batched.shutdown()
        alone.shutdown()
    snap = batched.snapshot()
    assert snap["batch_flushes"] == 1 and snap["batched_suggests"] == 3
    assert snap["batch_fallbacks"] == 0 and snap["batch_slot_errors"] == 0
    assert snap["cold_trains"] == 3 and snap["cached_studies"] == 3
    assert alone.batch_executor is None and alone.snapshot()["batch_flushes"] == 0
    assert [[s.parameters.as_dict() for s in r] for r in got] == [
        [s.parameters.as_dict() for s in r] for r in want]


def test_warm_start_state_round_trips_through_the_designer_cache():
    runtime = serving_runtime.ServingRuntime(serving_config.ServingConfig(batching=False))
    (cfg, supporter, name), = _studies("w")[:1]
    policy = serving_policy.CachedDesignerStatePolicy(supporter, _cheap_designer, runtime, name)
    request = lambda: policy_lib.SuggestRequest(study_descriptor=supporter.study_descriptor(), count=2)  # noqa: E731
    trials = supporter.AddSuggestions(policy.suggest(request()).suggestions)
    entry = runtime.designer_cache.peek(name)
    warm = entry.warm_params
    assert warm is not None and runtime.snapshot()["cold_trains"] == 1
    for k, v in entry.designer.warm_start_state()[0].items():
        assert torch.equal(v, warm[0][k])
    fresh = _cheap_designer(cfg.to_problem())
    fresh.set_warm_start_state(warm)
    for k, v in fresh.warm_start_state()[0].items():
        assert torch.equal(v, warm[0][k])
    for t in trials:
        t.complete(vz.Measurement(metrics={"y": 0.0}))
    policy.suggest(request())
    assert runtime.snapshot()["warm_trains"] == 1 and runtime.snapshot()["cache_hits"] == 1
    assert runtime.invalidate_study(name) and runtime.designer_cache.peek(name) is None
