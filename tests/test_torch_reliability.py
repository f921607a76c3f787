"""The port's reliability layer and runtime on the CPU, held to the JAX package.

Mirrors the JAX package's ``tests/reliability/`` for the pieces the port
copies: the circuit breaker's transitions under an injected clock, the retry
schedule, deadline budgets and their wire form, the seeded quasi-random
fallback (the same points as the JAX package's for the same study name,
problem and frontier), the request coalescer (N threads on one key make one
computation) and the serving runtime's guarded suggest, breakers and config
turnover.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import threading
import time

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.reliability import breaker as jbreaker
from vizier_tpu.reliability import config as jconfig
from vizier_tpu.reliability import deadline as jdeadline
from vizier_tpu.reliability import errors as jerrors
from vizier_tpu.reliability import fallback as jfallback
from vizier_tpu.reliability import retry as jretry
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch import reliability
from vizier_tpu_torch.reliability import breaker as breaker_lib
from vizier_tpu_torch.reliability import config as config_lib
from vizier_tpu_torch.reliability import deadline as deadline_lib
from vizier_tpu_torch.reliability import errors as errors_lib
from vizier_tpu_torch.reliability import fallback as fallback_lib
from vizier_tpu_torch.reliability import retry as retry_lib
from vizier_tpu_torch.serving import coalescer as coalescer_lib
from vizier_tpu_torch.serving import config as serving_config
from vizier_tpu_torch.serving import runtime as runtime_lib
from vizier_tpu_torch.serving import stats as stats_lib


class _Clock:
    def __init__(self, now: float = 100.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


# -- breaker ---------------------------------------------------------------------

# Each step: ("allow" | "success" | "failure" | "advance", seconds).
_BREAKER_SCENARIOS = {
    "opens_at_threshold": [("failure", 0), ("allow", 0), ("failure", 0), ("failure", 0),
                           ("allow", 0)],
    "window_slides": [("failure", 0), ("advance", 40), ("failure", 0), ("advance", 30),
                      ("failure", 0), ("allow", 0), ("failure", 0), ("allow", 0)],
    "success_clears": [("failure", 0), ("failure", 0), ("success", 0), ("failure", 0),
                       ("failure", 0), ("allow", 0)],
    "half_open_then_close": [("failure", 0)] * 3 + [
        ("allow", 0), ("advance", 29), ("allow", 0), ("advance", 2), ("allow", 0), ("allow", 0),
        ("success", 0), ("allow", 0)],
    "half_open_probe_fails": [("failure", 0)] * 3 + [
        ("advance", 31), ("allow", 0), ("failure", 0), ("allow", 0), ("advance", 31),
        ("allow", 0), ("success", 0)],
    "straggler_while_open": [("failure", 0)] * 3 + [("failure", 0), ("advance", 31),
                                                    ("allow", 0)],
}


def _run_breaker(module, steps):
    clock = _Clock()
    transitions = []
    breaker = module.CircuitBreaker(
        failure_threshold=3, window_secs=60.0, cooldown_secs=30.0, half_open_probes=1,
        time_fn=clock, on_transition=lambda old, new: transitions.append((old, new)))
    trace = []
    for op, arg in steps:
        if op == "advance":
            clock.now += arg
        elif op == "allow":
            trace.append(breaker.allow())
        else:
            getattr(breaker, f"record_{op}")()
        trace.append(breaker.state)
    return trace, transitions


@pytest.mark.parametrize("scenario", sorted(_BREAKER_SCENARIOS))
def test_breaker_transitions_equal_the_jax_packages(scenario):
    steps = _BREAKER_SCENARIOS[scenario]
    assert _run_breaker(breaker_lib, steps) == _run_breaker(jbreaker, steps)


def test_breaker_registry_counts_transitions_and_drops_a_study():
    clock = _Clock()
    stats = stats_lib.ServingStats()
    registry = breaker_lib.CircuitBreakerRegistry(
        failure_threshold=2, cooldown_secs=5.0, time_fn=clock, stats=stats)
    a, b = registry.get("a"), registry.get("b")
    a.record_failure()
    a.record_failure()
    assert registry.states() == {"a": "open", "b": "closed"} and registry.open_count() == 1
    clock.now += 6
    assert a.allow() and a.state == "half_open"
    a.record_success()
    snap = stats.snapshot()
    assert (snap["breaker_open_transitions"], snap["breaker_half_open_transitions"],
            snap["breaker_close_transitions"]) == (1, 1, 1)
    assert registry.invalidate("b") and not registry.invalidate("b")
    assert registry.get("b") is not b


# -- retry ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("jitter", [True, False])
def test_retry_delays_equal_the_jax_packages(seed, jitter):
    kwargs = dict(max_attempts=6, base_delay_secs=0.1, max_delay_secs=1.0, jitter=jitter)
    ours = retry_lib.RetryPolicy(rng=random.Random(seed), **kwargs)
    theirs = jretry.RetryPolicy(rng=random.Random(seed), **kwargs)
    assert list(ours.delays()) == list(theirs.delays())


def test_retry_call_sleeps_the_schedule_and_honours_the_hint():
    slept = []
    policy = retry_lib.RetryPolicy(max_attempts=4, rng=random.Random(3), sleep_fn=slept.append)
    expected = [policy.delay_for_attempt(a) for a in range(2)]
    policy.rng = random.Random(3)
    calls = iter([errors_lib.TransientError("TRANSIENT: one"),
                  errors_lib.TransientError("TRANSIENT: RESOURCE_EXHAUSTED retry_after_ms=750"),
                  "done"])

    def fn():
        item = next(calls)
        if isinstance(item, BaseException):
            raise item
        return item

    retries = []
    assert policy.call(fn, on_retry=lambda e, a: retries.append(a)) == "done"
    assert retries == [0, 1]
    assert slept == [expected[0], max(expected[1], 0.75)]
    with pytest.raises(ValueError):
        policy.call(lambda: (_ for _ in ()).throw(ValueError("permanent")))


def test_retry_from_config_and_config_defaults_equal_the_jax_packages(monkeypatch):
    assert dataclasses.asdict(config_lib.ReliabilityConfig()) == dataclasses.asdict(
        jconfig.ReliabilityConfig())
    assert dataclasses.asdict(config_lib.ReliabilityConfig.disabled()) == dataclasses.asdict(
        jconfig.ReliabilityConfig.disabled())
    assert retry_lib.RetryPolicy.from_config(config_lib.ReliabilityConfig.disabled()).max_attempts == 1
    monkeypatch.setenv("VIZIER_TORCH_RELIABILITY_BREAKER", "0")
    monkeypatch.setenv("VIZIER_RELIABILITY", "0")
    cfg = config_lib.ReliabilityConfig.from_env()
    assert cfg.enabled and not cfg.breaker_on and cfg.fallback_on


# -- deadline ---------------------------------------------------------------------


@pytest.mark.parametrize("wire", [0.0, 2.5, -0.5])
def test_deadline_from_wire_equals_the_jax_packages(wire):
    ours, theirs = _Clock(), _Clock()
    a = deadline_lib.Deadline.from_wire(wire, clock=ours)
    b = jdeadline.Deadline.from_wire(wire, clock=theirs)
    for step in (0.0, 1.0, 2.0):
        ours.now += step
        theirs.now += step
        assert (a.is_set, a.expired, a.remaining(), a.wire_budget()) == (
            b.is_set, b.expired, b.remaining(), b.wire_budget())
        if a.expired:
            with pytest.raises(errors_lib.DeadlineExceededError) as got:
                a.check("dispatch")
            with pytest.raises(jerrors.DeadlineExceededError) as want:
                b.check("dispatch")
            assert str(got.value) == str(want.value)
            assert errors_lib.has_transient_marker(str(got.value))


def test_deadline_from_budget_and_none():
    clock = _Clock()
    assert not deadline_lib.Deadline.from_budget(0.0, clock=clock).is_set
    d = deadline_lib.Deadline.from_budget(3.0, clock=clock)
    clock.now += 1.0
    assert d.remaining() == pytest.approx(2.0) and not d.expired
    assert deadline_lib.Deadline.none().remaining() == float("inf")


# -- fallback ---------------------------------------------------------------------


def _problem(module, conditional=False):
    config = module.StudyConfig(algorithm="DEFAULT")
    root = config.search_space.root
    if conditional:
        sel = root.add_categorical_param("model", ["a", "b"])
        sel.select_values(["a"]).add_float_param("lr", 1e-4, 1e-1, scale_type=module.ScaleType.LOG)
        sel.select_values(["b"]).add_int_param("depth", 1, 8)
    else:
        root.add_float_param("x", -2.0, 3.0)
        root.add_float_param("lr", 1e-4, 1e-1, scale_type=module.ScaleType.LOG)
        root.add_int_param("n", 1, 9)
        root.add_discrete_param("d", [0.5, 1.5, 4.0])
        root.add_categorical_param("c", ["p", "q", "r"])
    config.metric_information.append(
        module.MetricInformation(name="obj", goal=module.ObjectiveMetricGoal.MAXIMIZE))
    return config.to_problem()


@pytest.mark.parametrize("conditional", [False, True], ids=["flat", "conditional"])
@pytest.mark.parametrize("max_trial_id", [0, 17])
def test_fallback_suggestions_equal_the_jax_packages(conditional, max_trial_id):
    kwargs = dict(study_name="owners/o/studies/s", max_trial_id=max_trial_id, reason="r")
    ours = fallback_lib.suggest_fallback(_problem(vz, conditional), 4, **kwargs)
    theirs = jfallback.suggest_fallback(_problem(jvz, conditional), 4, **kwargs)
    assert [s.parameters.as_dict() for s in ours] == [s.parameters.as_dict() for s in theirs]
    for s, t in zip(ours, theirs):
        assert reliability.is_fallback_suggestion(s.metadata)
        assert dict(s.metadata.ns("reliability")) == dict(t.metadata.ns("reliability"))


# -- coalescer --------------------------------------------------------------------


def _concurrent(n, fn):
    results, errors = [None] * n, [None] * n
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results, errors


@pytest.mark.parametrize("threads", [2, 16])
def test_n_threads_on_one_key_make_one_computation(threads):
    """More threads than cores, with a short switch interval: a lost update
    in the coalescer's map would show as a second computation."""
    stats = stats_lib.ServingStats()
    coalescer = coalescer_lib.RequestCoalescer(stats=stats)
    calls = []

    def compute():
        calls.append(1)
        time.sleep(0.3)
        return [1, 2, 3]

    key = coalescer_lib.suggest_key("s", "h", "DEFAULT", 5, 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results, errors = _concurrent(
            threads, lambda i: coalescer.coalesce(key, compute, clone=list))
    finally:
        sys.setswitchinterval(interval)
    assert errors == [None] * threads and calls == [1]
    assert all(r == [1, 2, 3] for r in results)
    snap = stats.snapshot()
    assert snap["coalesced_requests"] == threads - 1 and snap["coalesced_computations"] == 1
    assert coalescer.inflight_keys() == ()
    # After the leader finished, the same key computes afresh.
    assert coalescer.coalesce(key, compute) == [1, 2, 3] and calls == [1, 1]


def test_a_leaders_error_reaches_every_waiter_and_other_keys_do_not_coalesce():
    coalescer = coalescer_lib.RequestCoalescer()

    def boom():
        time.sleep(0.2)
        raise RuntimeError("leader failed")

    _, errors = _concurrent(4, lambda i: coalescer.coalesce("k", boom))
    assert all(isinstance(e, RuntimeError) for e in errors)
    calls = []
    _concurrent(3, lambda i: coalescer.coalesce(
        coalescer_lib.suggest_key("s", "h", "DEFAULT", i, 1), lambda: calls.append(i)))
    assert sorted(calls) == [0, 1, 2]


# -- runtime: guarded suggest, breakers, turnover ---------------------------------


def _runtime(**reliability_kwargs):
    return runtime_lib.ServingRuntime(
        serving_config.ServingConfig(batching=False),
        reliability=config_lib.ReliabilityConfig(**reliability_kwargs))


def _stamped(reason):
    return fallback_lib.suggest_fallback(
        _problem(vz), 2, study_name="s", max_trial_id=3, reason=reason)


def _fail():
    raise RuntimeError("designer exploded")


def test_guarded_suggest_degrades_opens_short_circuits_and_half_opens():
    rt = _runtime(breaker_cooldown_secs=0.2)
    calls = []

    def failing():
        calls.append(1)
        _fail()

    for _ in range(3):
        out = rt.guarded_suggest("s", failing, _stamped)
        assert out.decision is None and len(out.fallbacks) == 2 and out.error is None
        assert out.fallbacks[0].metadata.ns("reliability")["fallback_reason"] == (
            "designer_error:RuntimeError")
    out = rt.guarded_suggest("s", failing, _stamped)
    assert len(calls) == 3 and out.fallbacks[0].metadata.ns("reliability")[
        "fallback_reason"] == "circuit_open"
    time.sleep(0.25)
    out = rt.guarded_suggest("s", lambda: "decision", _stamped)
    assert out.decision == "decision" and rt.breakers.get("s").state == "closed"
    snap = rt.snapshot()
    assert (snap["designer_failures"], snap["fallbacks"], snap["breaker_short_circuits"]) == (
        3, 8, 1)
    assert snap["open_breakers"] == 0
    rt.shutdown()


def test_guarded_suggest_deadline_order_and_fallback_off():
    rt = _runtime(fallback=False)
    clock = _Clock()
    expired = deadline_lib.Deadline(clock.now - 1.0, clock)
    calls = []
    out = rt.guarded_suggest("s", lambda: calls.append(1), _stamped, expired)
    assert isinstance(out.error, errors_lib.DeadlineExceededError) and not calls
    assert rt.breakers.get("s").state == "closed"
    # A budget spent by the computation counts against the breaker.
    deadline = deadline_lib.Deadline(clock.now + 1.0, clock)

    def slow():
        clock.now += 2.0
        return "late"

    out = rt.guarded_suggest("t", slow, _stamped, deadline)
    assert isinstance(out.error, errors_lib.DeadlineExceededError) and out.decision is None
    out = rt.guarded_suggest("u", _fail, _stamped)
    assert isinstance(out.error, RuntimeError) and not out.fallbacks
    for _ in range(2):
        rt.guarded_suggest("u", _fail, _stamped)
    out = rt.guarded_suggest("u", lambda: "x", _stamped)
    assert isinstance(out.error, errors_lib.CircuitOpenError)
    assert errors_lib.has_transient_marker(str(out.error))
    assert rt.snapshot()["deadline_exceeded"] == 2
    rt.shutdown()


def test_a_failing_fallback_is_a_transient_error():
    rt = _runtime()

    def broken(reason):
        raise ValueError("no space")

    out = rt.guarded_suggest("s", _fail, broken)
    assert isinstance(out.error, errors_lib.TransientError)
    assert "FALLBACK_FAILED (designer_error:RuntimeError)" in str(out.error)
    rt.shutdown()


def test_config_turnover_and_invalidation_drop_the_breaker_and_designer():
    rt = _runtime(breaker_failure_threshold=1)
    rt.designer_cache.get_or_create("s", lambda: object())
    rt.guarded_suggest("s", _fail, _stamped)
    assert rt.breakers.states() == {"s": "open"}
    assert not rt.note_study_config("s", "h1")
    assert not rt.note_study_config("s", "h1") and "s" in rt.designer_cache
    assert rt.note_study_config("s", "h2")
    assert "s" not in rt.designer_cache and rt.breakers.states() == {}
    assert rt.snapshot()["cache_invalidations_config"] == 1
    rt.guarded_suggest("s", _fail, _stamped)
    assert rt.breakers.states() == {"s": "open"}
    rt.invalidate_study("s")
    assert rt.breakers.states() == {}
    rt.shutdown()


def test_planes_the_port_does_not_have_are_refused(monkeypatch):
    # The mesh and its multi-host seam are ported: a coordinator without its
    # process count and rank is an explicit init that fails, and raises.
    from vizier_tpu_torch.parallel.mesh import MeshConfig

    with pytest.raises(ValueError, match="rendezvous"):
        runtime_lib.ServingRuntime(
            mesh=MeshConfig(enabled=True, coordinator_address="localhost:1234"), device="cpu")
    rt = runtime_lib.ServingRuntime(mesh=MeshConfig(enabled=True), device="cpu")
    assert [p.label() for p in rt.batch_executor.placements()] == ["mesh0"]
    rt.shutdown()
    # Prewarm and the compile cache are ported: both configs build.
    assert serving_config.ServingConfig(batching_prewarm=True).batching_prewarm
    assert serving_config.ServingConfig(
        compilation_cache_dir="/tmp/cache").compilation_cache_dir == "/tmp/cache"
    # The flight recorder is ported: the switch builds a working recorder.
    monkeypatch.setenv("VIZIER_TORCH_FLIGHT_RECORDER", "1")
    from vizier_tpu_torch.observability import flight_recorder

    previous = flight_recorder.set_recorder(None)
    try:
        rt = runtime_lib.ServingRuntime(serving_config.ServingConfig(batching=False))
        assert rt.flight_recorder.enabled
        rt.flight_recorder.record("s", "probe")
        assert [e["kind"] for e in rt.flight_recorder.ring("s")] == ["probe"]
        rt.shutdown()
    finally:
        flight_recorder.set_recorder(previous)
