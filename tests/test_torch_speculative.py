"""The port's speculative pre-compute on the CPU, held to the JAX package's.

- the engine, scenario for scenario in both packages over a scripted compute
  path: park then one-shot hit, count reconciliation, superseded mid-flight,
  invalidated mid-flight, stale by age, a crossover of the surrogate, a
  failed or fallback-stamped compute, the idle-window gate, shutdown; the
  same outcomes, slots and counters in both;
- the designers' exact→sparse crossover fires the installed listener in
  both packages at the same trial count;
- the serving stack: through the port's in-process ``VizierServicer`` and
  ``PythiaServicer`` (``device="cpu"``) on a 4-D study, every completion
  triggers a pre-compute, and every later suggest is a stamped hit whose
  suggestions equal, float for float, what the same stack with speculation
  off serves at the same frontier; deleting the study never serves its
  predecessor's batch;
- the protobuf-free entries the card drives (``bind_speculative``,
  ``speculative_suggest``, ``accept_guarded``, ``stamp_speculative_hit``,
  ``admitted_suggest``) around a ``CachedDesignerStatePolicy``, and the
  servicer's proto accept and stamp held equal to the runtime's;
- a surrogate crossover forgets the study's recent counts in both
  packages.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_bandit as jgp_bandit
from vizier_tpu.serving import designer_cache as jcache
from vizier_tpu.serving import runtime as jruntime
from vizier_tpu.serving import speculative as jspeculative
from vizier_tpu.serving import stats as jstats
from vizier_tpu.surrogates import config as jsurrogates
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch import reliability
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers import gp_ucb_pe
from vizier_tpu_torch.optimizers import lbfgs
from vizier_tpu_torch.pythia import local_policy_supporters
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.serving import admission
from vizier_tpu_torch.serving import config as serving_config
from vizier_tpu_torch.serving import designer_cache
from vizier_tpu_torch.serving import policy as serving_policy
from vizier_tpu_torch.serving import runtime as runtime_lib
from vizier_tpu_torch.serving import speculative
from vizier_tpu_torch.serving import stats
from vizier_tpu_torch.surrogates import config as surrogates

JAX = types.SimpleNamespace(spec=jspeculative, cache=jcache, stats=jstats, surrogates=jsurrogates,
                            runtime=jruntime)
PORT = types.SimpleNamespace(spec=speculative, cache=designer_cache, stats=stats,
                             surrogates=surrogates, runtime=runtime_lib)


class _Response:
    """Stands in for a suggest response (opaque to the engine)."""

    def __init__(self, batch, error=""):
        self.batch = batch
        self.error = error


class _FakeExecutor:
    def __init__(self, live=0):
        self.live = live

    def live_pending(self):
        return self.live


class _Harness:
    """A bound engine over a real designer cache and a scripted frontier."""

    def __init__(self, pkg, config=None, executor=None, time_fn=None):
        self.pkg = pkg
        self.stats = pkg.stats.ServingStats()
        self.cache = pkg.cache.DesignerStateCache(stats=self.stats)
        self.engine = pkg.spec.SpeculativeEngine(
            config or pkg.spec.SpeculativeConfig(speculative=True), cache=self.cache,
            stats=self.stats, executor=executor, time_fn=time_fn or time.monotonic)
        self.frontier = ([], [], 0)
        self.computes = 0
        self.started = threading.Event()
        self.release = threading.Event()
        self.release.set()
        self.result = lambda study, count: _Response([f"{study}#{count}"] * count)
        self.engine.bind(fingerprint_fn=self._fingerprint, compute_fn=self._compute,
                         accept_fn=self._accept)

    def _fingerprint(self, study):
        completed, active, max_id = self.frontier
        return self.pkg.spec.make_fingerprint(b"cfg", completed, active), max_id

    def _compute(self, study, count, max_trial_id):
        assert self.pkg.spec.in_speculative_compute()
        self.computes += 1
        self.started.set()
        assert self.release.wait(timeout=30.0)
        return self.result(study, count)

    @staticmethod
    def _accept(response):
        if response is None or response.error or not response.batch:
            return None
        return len(response.batch)

    def fp(self):
        completed, active, _ = self.frontier
        return self.pkg.spec.make_fingerprint(b"cfg", completed, active)

    def entry(self, study="s"):
        return self.cache.get_or_create(study, lambda: object())

    def counters(self):
        return {k[len("speculative_"):]: v for k, v in self.stats.snapshot().items()
                if k.startswith("speculative_")}

    def slot(self, study="s"):
        entry = self.cache.peek(study, touch=False)
        slot = getattr(entry, "speculative", None)
        return None if slot is None else (slot.fingerprint.completed_ids, slot.count,
                                          slot.response.batch)


def _serve(h, count=1):
    response, outcome = h.engine.try_serve("s", count, h.fp())
    return outcome, None if response is None else response.batch


def _park_and_hit(h):
    h.entry()
    h.frontier = ([1], [], 1)
    assert h.engine.notify_completion("s") and h.engine.wait_idle(10.0)
    parked = h.slot()
    return parked, _serve(h), _serve(h)


def _count_reconciliation(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.engine.note_live_suggest("s", 3)
    h.engine.note_live_suggest("s", 1)
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    return _serve(h, 4), h.slot(), _serve(h, 2)


def _superseded(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.release.clear()
    h.engine.notify_completion("s")
    assert h.started.wait(10.0)
    h.frontier = ([1, 2], [], 2)
    h.engine.notify_completion("s")
    mid = h.slot()
    h.release.set()
    assert h.engine.wait_idle(10.0)
    return mid, h.slot(), h.computes, _serve(h)


def _invalidated_mid_flight(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.release.clear()
    h.engine.notify_completion("s")
    assert h.started.wait(10.0)
    h.engine.invalidate("s", reason="delete_study")
    h.release.set()
    assert h.engine.wait_idle(10.0)
    return h.slot(), _serve(h)


def _stale(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    parked = h.slot()
    h.clock[0] = 6.0
    return parked, _serve(h), h.slot()


def _crossover(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    parked = h.slot()
    designer = types.SimpleNamespace()
    h.pkg.surrogates.install_crossover_listener(
        designer, lambda old, new: h.engine.invalidate("s", reason=f"crossover:{old}->{new}"))
    h.pkg.surrogates.fire_crossover_hook(designer, "exact", "sparse")
    broken = types.SimpleNamespace()
    h.pkg.surrogates.install_crossover_listener(broken, lambda old, new: 1 / 0)
    h.pkg.surrogates.fire_crossover_hook(broken, "sparse", "exact")  # swallowed
    return parked, h.slot(), _serve(h)


def _failures(h):
    h.entry()
    h.frontier = ([1], [], 1)
    out = []
    for result in (lambda s, c: 1 / 0, lambda s, c: _Response([], error="TRANSIENT: x"),
                   lambda s, c: _Response([])):
        h.result = result
        h.engine.notify_completion("s")
        assert h.engine.wait_idle(10.0)
        out.append(h.slot())
    h.engine._fingerprint_fn, original = (lambda study: 1 / 0), h.engine._fingerprint_fn
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    h.engine._fingerprint_fn = original
    h.result = lambda study, count: _Response(["ok"])
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    return out, _serve(h)


def _no_entry(h):
    h.frontier = ([1], [], 1)
    h.engine.notify_completion("nobody")
    assert h.engine.wait_idle(10.0)
    return h.computes


def _gate(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.executor.live = 3
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    busy = (h.computes, h.slot())
    h.executor.live = 0
    h.engine.notify_completion("s")
    assert h.engine.wait_idle(10.0)
    return busy, h.computes, _serve(h)


def _shutdown(h):
    h.entry()
    h.frontier = ([1], [], 1)
    h.release.clear()
    h.engine.notify_completion("s")
    assert h.started.wait(10.0)
    h.engine.notify_completion("t")
    closer = threading.Thread(target=h.engine.close)
    closer.start()
    time.sleep(0.05)
    h.release.set()
    closer.join(10.0)
    alive = [t.name for t in h.engine._threads if t.is_alive()]
    return h.slot(), alive, h.engine.notify_completion("s")


_SCENARIOS = {
    "park_and_hit": (_park_and_hit, {}),
    "count_reconciliation": (_count_reconciliation, {}),
    "superseded": (_superseded, {}),
    "invalidated_mid_flight": (_invalidated_mid_flight, {}),
    "stale": (_stale, {"max_speculation_age_s": 5.0}),
    "crossover": (_crossover, {}),
    "failures": (_failures, {}),
    "no_entry": (_no_entry, {}),
    "gate": (_gate, {"admission_max_wait_s": 0.05}),
    "shutdown": (_shutdown, {}),
}


def _run(pkg, name):
    scenario, config = _SCENARIOS[name]
    clock = [0.0]
    executor = _FakeExecutor() if name == "gate" else None
    h = _Harness(pkg, config=pkg.spec.SpeculativeConfig(speculative=True, **config),
                 executor=executor, time_fn=(lambda: clock[0]) if name == "stale" else None)
    h.clock, h.executor = clock, executor
    try:
        out = scenario(h)
    finally:
        h.engine.close()
    return out, h.counters()


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_engine_scenario_equals_the_jax_packages(name):
    ours = _run(PORT, name)
    assert ours == _run(JAX, name)
    out, counters = ours
    if name == "park_and_hit":
        assert out[1] == ("hit", ["s#1"]) and out[2][0] == "miss" and counters["hits"] == 1
    if name in ("superseded",):
        assert out[1][0] == (1, 2) and out[2] == 2 and out[3][0] == "hit"
    if name in ("invalidated_mid_flight", "crossover"):
        assert out[-2] is None and out[-1][0] == "miss"
    if name == "stale":
        assert out[1] == ("stale", None) and out[2] is None and counters["stale"] == 1
    if name == "failures":
        assert out[0] == [None, None, None] and out[1] == ("hit", ["ok"])
        assert counters["errors"] == 4
    if name == "gate":
        assert out[0] == (0, None) and out[1] == 1 and out[2][0] == "hit"
    if name == "shutdown":
        assert out == (None, [], False)


def test_a_live_miss_supersedes_the_studys_queued_and_running_jobs():
    """The port's departure from the JAX engine: a live request that misses
    computes the frontier its study's job was enqueued for, so that job is
    superseded. A queued one never runs; a running one parks nothing."""
    h = _Harness(PORT)
    try:
        h.entry("s")
        h.entry("t")
        h.frontier = ([1], [], 1)
        h.release.clear()
        h.engine.notify_completion("s")
        assert h.started.wait(10.0)  # s's job runs on the one worker
        h.engine.notify_completion("t")  # t's waits behind it
        assert h.engine.try_serve("t", 1, h.fp()) == (None, "miss")
        assert h.engine.try_serve("s", 1, h.fp()) == (None, "miss")
        h.release.set()
        assert h.engine.wait_idle(10.0)
        assert h.computes == 1 and h.slot("s") is None and h.slot("t") is None
        counters = h.counters()
        assert counters["cancelled"] == 2 and counters["misses"] == 2
        assert counters["hits"] == 0
    finally:
        h.engine.close()


def test_config_and_fingerprint_equal_the_jax_packages(monkeypatch):
    assert not speculative.SpeculativeConfig.from_env().speculative
    monkeypatch.setenv("VIZIER_TORCH_SPECULATIVE", "1")
    monkeypatch.setenv("VIZIER_TORCH_SPECULATIVE_WORKERS", "2")
    monkeypatch.setenv("VIZIER_TORCH_SPECULATIVE_ON_FILL", "1")
    monkeypatch.setenv("VIZIER_SPECULATIVE", "0")
    cfg = speculative.SpeculativeConfig.from_env()
    assert cfg.as_dict() == jspeculative.SpeculativeConfig(
        speculative=True, workers=2, speculate_on_fill=True).as_dict()
    with pytest.raises(ValueError):
        speculative.SpeculativeConfig(workers=0)
    a = speculative.make_fingerprint(b"cfg", [3, 1, 2], [7, 5])
    b = jspeculative.make_fingerprint(b"cfg", [2, 3, 1], [5, 7])
    assert (a.config_digest, a.completed_ids, a.active_ids) == (
        b.config_digest, b.completed_ids, b.active_ids)
    assert a != speculative.make_fingerprint(b"cfg", [1, 2, 3], [])


def _crossing_designer(pkg_vz, module):
    problem = pkg_vz.ProblemStatement()
    for j in range(2):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(pkg_vz.MetricInformation(
        name="y", goal=pkg_vz.ObjectiveMetricGoal.MAXIMIZE))
    surrogate = module.surrogate_config_lib.SurrogateConfig(
        sparse_threshold_trials=6, hysteresis_trials=2)
    kwargs = {"device": "cpu"} if module is gp_bandit else {}
    designer = module.VizierGPBandit(problem, surrogate=surrogate, **kwargs)
    calls = []
    module.surrogate_config_lib.install_crossover_listener(
        designer, lambda old, new: calls.append((len(designer._trials), old, new)))
    rng = np.random.default_rng(0)
    for n in range(8):
        trial = pkg_vz.Trial(id=n + 1, parameters={f"x{j}": float(rng.uniform()) for j in range(2)})
        trial.complete(pkg_vz.Measurement(metrics={"y": float(rng.normal())}))
        designer._trials.append(trial)
        designer._refresh_surrogate_mode()
    return calls


def test_designer_crossover_fires_the_listener_as_the_jax_designer_does():
    ours = _crossing_designer(vz, gp_bandit)
    assert ours == _crossing_designer(jvz, jgp_bandit) == [(6, "exact", "sparse")]


# -- the serving stack -------------------------------------------------------------------

_STEPS = 4
_DESIGNER = dict(max_acquisition_evaluations=200, ard_restarts=2, warm_start_min_trials=0,
                 rng_seed=7, device="cpu")


class _FastFactory:
    """The DEFAULT as the policy factory builds it, with small budgets."""

    def __init__(self, runtime):
        self._runtime = runtime

    def __call__(self, problem, algorithm, supporter, study_name):
        def designer(p, **_):
            cfg = self._runtime.config
            return gp_ucb_pe.VizierGPUCBPEBandit(
                p, ard_optimizer=lbfgs.AdamOptimizer(maxiter=10, device="cpu"),
                use_warm_start_ard=cfg.warm_start, warm_ard_restarts=cfg.warm_ard_restarts,
                **_DESIGNER)

        return serving_policy.CachedDesignerStatePolicy(
            supporter, designer, self._runtime, study_name, use_seeding=True)


def _stack(speculative_on: bool):
    from vizier_tpu_torch.service import pythia_service, vizier_service

    servicer = vizier_service.VizierServicer()
    pythia = pythia_service.PythiaServicer(servicer, device="cpu")
    if speculative_on:
        pythia._serving = runtime_lib.ServingRuntime(
            speculative=speculative.SpeculativeConfig(speculative=True))
    pythia._policy_factory = _FastFactory(pythia.serving_runtime)
    pythia._bind_speculative()
    servicer.set_pythia(pythia)
    return servicer, pythia


def _drive(servicer, pythia, study_name, steps=_STEPS):
    """A sequential suggest → complete loop; ``wait_idle`` models an
    evaluation that outlasts the pre-compute. Returns each suggestion's
    parameters and whether it carried the hit stamp."""
    from vizier_tpu_torch.service import proto_converters as pc
    from vizier_tpu_torch.service.protos import vizier_service_pb2

    config = vz.StudyConfig(algorithm="DEFAULT")
    for d in range(4):
        config.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    config.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    servicer.CreateStudy(vizier_service_pb2.CreateStudyRequest(
        parent="owners/o", study=pc.study_to_proto(config, study_name)))
    engine = pythia.serving_runtime.speculative_engine
    trajectory, stamped = [], []
    for _ in range(steps):
        op = servicer.SuggestTrials(vizier_service_pb2.SuggestTrialsRequest(
            parent=study_name, suggestion_count=1, client_id="worker"))
        assert not op.error, op.error
        trial = op.response.trials[0]
        trajectory.append(tuple(sorted((p.name, p.value.double_value) for p in trial.parameters)))
        stamped.append(any(kv.key == speculative.SPECULATIVE_KEY
                           and kv.string_value == speculative.SPECULATIVE_HIT_VALUE
                           for kv in trial.metadata))
        request = vizier_service_pb2.CompleteTrialRequest(name=trial.name)
        metric = request.final_measurement.metrics.add()
        metric.name = "obj"
        metric.value = -sum((p.value.double_value - 0.3) ** 2 for p in trial.parameters)
        servicer.CompleteTrial(request)
        if engine is not None:
            assert engine.wait_idle(120.0)
    return trajectory, stamped


def test_hits_equal_the_live_compute_float_for_float():
    off_servicer, off_pythia = _stack(False)
    try:
        assert off_pythia.serving_runtime.speculative_engine is None
        baseline, off_stamps = _drive(off_servicer, off_pythia, "owners/o/studies/base")
    finally:
        off_pythia.shutdown()
    assert not any(off_stamps)
    on_servicer, on_pythia = _stack(True)
    try:
        speculated, on_stamps = _drive(on_servicer, on_pythia, "owners/o/studies/spec")
        counters = {k: v for k, v in on_pythia.serving_stats().items()
                    if k.startswith("speculative_")}
        lanes = on_pythia.serving_runtime.metrics.get("vizier_batch_flushes").series_values()
    finally:
        on_pythia.shutdown()
    # Suggest 0 is the seeding stage (no cache entry yet) and suggest 1
    # computes live (the entry is born there); every later one is a hit,
    # float for float the batch the live compute gives at that frontier.
    assert speculated == baseline
    assert on_stamps == [False, False] + [True] * (_STEPS - 2)
    assert counters["speculative_hits"] == _STEPS - 2
    assert counters["speculative_errors"] == 0
    assert sum(lanes.values()) >= _STEPS - 1


def test_delete_study_never_serves_the_predecessors_batch():
    from vizier_tpu_torch.service.protos import vizier_service_pb2

    servicer, pythia = _stack(True)
    name = "owners/o/studies/reused"
    try:
        _drive(servicer, pythia, name, 3)
        entry = pythia.serving_runtime.designer_cache.peek(name)
        assert entry is not None and entry.speculative is not None
        servicer.DeleteStudy(vizier_service_pb2.DeleteStudyRequest(name=name))
        assert pythia.serving_runtime.designer_cache.peek(name) is None
        _, stamps = _drive(servicer, pythia, name, 2)
        assert not any(stamps)
    finally:
        pythia.shutdown()
    assert not any(t.name.startswith("vizier-torch-speculative") and t.is_alive()
                   for t in threading.enumerate())


# -- the protobuf-free entries the card drives ----------------------------------------------


def _study(n=8, seed=0):
    config = vz.StudyConfig(algorithm="DEFAULT")
    for d in range(4):
        config.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    config.metric_information.append(vz.MetricInformation(name="obj"))
    supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid="s")
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t = vz.Trial(parameters={f"x{d}": float(rng.uniform()) for d in range(4)})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        supporter.AddTrials([t])
    return config, supporter


def _proto_free(rt, config, supporter, name):
    """Live, fingerprint, accept and stamp as the card's phase binds them."""
    factory = _FastFactory(rt)

    def fallback(reason):
        return reliability.suggest_fallback(
            config.to_problem(), 2, study_name=name,
            max_trial_id=supporter.study_descriptor().max_trial_id, reason=reason)

    def live(count=2):
        descriptor = supporter.study_descriptor()
        return rt.admitted_suggest(name, lambda: rt.guarded_suggest(
            name, lambda: factory(config, "DEFAULT", supporter, name).suggest(
                policy_lib.SuggestRequest(study_descriptor=descriptor, count=count)),
            fallback), fallback)

    def frontier():
        trials = supporter.GetTrials()
        completed = [t.id for t in trials if t.status == vz.TrialStatus.COMPLETED]
        active = [t.id for t in trials if t.status == vz.TrialStatus.ACTIVE]
        return speculative.make_fingerprint(repr(config).encode(), completed, active)

    rt.bind_speculative(lambda study: (frontier(), supporter.study_descriptor().max_trial_id),
                        lambda study, count, max_id: live(count), runtime_lib.accept_guarded)

    def suggest():
        return rt.speculative_suggest(name, 2, frontier, live,
                                      runtime_lib.stamp_speculative_hit,
                                      lambda out: out.error is None)

    return suggest


def test_proto_free_speculative_entries_serve_a_stamped_hit():
    name = "owners/a/studies/s"
    rt = runtime_lib.ServingRuntime(
        serving_config.ServingConfig(),
        speculative=speculative.SpeculativeConfig(speculative=True))
    config, supporter = _study()
    suggest = _proto_free(rt, config, supporter, name)
    try:
        first = suggest()
        assert first.decision is not None and len(first.suggestions) == 2
        supporter.AddTrials([s.to_trial() for s in first.suggestions])
        for t in supporter.GetTrials(status_matches=vz.TrialStatus.ACTIVE):
            t.complete(vz.Measurement(metrics={"obj": 0.5}))
            supporter.AddTrials([t])
        rt.notify_trial_event(name)
        assert rt.speculative_engine.wait_idle(60.0)
        parked = rt.designer_cache.peek(name).speculative
        assert parked is not None and runtime_lib.accept_guarded(parked.response) == 2
        hit = suggest()
        assert all(s.metadata.ns("serving").get("speculative") == "hit" for s in hit.suggestions)
        assert [s.parameters.as_dict() for s in hit.suggestions] == [
            s.parameters.as_dict() for s in parked.response.suggestions]
        assert not any(s.metadata.ns("serving").get("speculative")
                       for s in parked.response.suggestions)
        counters = rt.snapshot()
        assert counters["speculative_hits"] == 1 and counters["speculative_errors"] == 0
        # A moved frontier refuses the (new) parked batch.
        rt.notify_trial_event(name)
        assert rt.speculative_engine.wait_idle(60.0)
        t = vz.Trial(parameters={f"x{d}": 0.1 for d in range(4)})
        t.complete(vz.Measurement(metrics={"obj": 0.0}))
        supporter.AddTrials([t])
        _, outcome = rt.speculative_engine.try_serve(
            name, 2, speculative.make_fingerprint(repr(config).encode(), [1], []))
        assert outcome == "miss" and rt.designer_cache.peek(name).speculative is None
    finally:
        rt.shutdown()


def _metadata_items(metadata):
    return sorted((str(ns), key, value) for ns, key, value in metadata.all_items())


@pytest.mark.parametrize("case", ["served", "fallback", "empty", "error"])
def test_the_servicers_accept_and_stamp_equal_the_runtimes(case):
    """``PythiaServicer`` vets and stamps proto responses by the runtime's
    rules: on the same response both accept the same batch size and serve
    the same stamped prefix."""
    from vizier_tpu_torch.service import proto_converters as pc
    from vizier_tpu_torch.service import pythia_service
    from vizier_tpu_torch.service.protos import pythia_service_pb2

    suggestions = [] if case == "empty" else [
        vz.TrialSuggestion({"x": 0.25 * i}, metadata=vz.Metadata({"user": f"k{i}"}))
        for i in range(3)]
    if case == "fallback":
        suggestions[1].metadata.ns("reliability")["fallback"] = "quasi_random"
    error = ValueError("boom") if case == "error" else None
    outcome = (runtime_lib.GuardedSuggestion(error=error) if error else
               runtime_lib.GuardedSuggestion(decision=policy_lib.SuggestDecision(suggestions)))
    proto = pythia_service_pb2.PythiaSuggestResponse()
    if error:
        proto.error = reliability.format_op_error(error)
    for s in suggestions:
        proto.suggestions.add().CopyFrom(pc.trial_suggestion_to_proto(s))

    accepted = runtime_lib.accept_guarded(outcome)
    assert pythia_service.PythiaServicer._speculative_accept(proto) == accepted
    assert accepted == (3 if case == "served" else None)
    if accepted is None:
        return
    for count in (1, 3):
        ours = runtime_lib.stamp_speculative_hit(outcome, count).suggestions
        served = pythia_service.PythiaServicer._stamp_speculative(proto, count).suggestions
        assert len(ours) == len(served) == count
        for s, t in zip(ours, served):
            assert pc.trial_suggestion_to_proto(s).parameters == t.parameters
            assert _metadata_items(s.metadata) == _metadata_items(
                pc.metadata_from_key_values(t.metadata))
            assert s.metadata.ns("serving").get("speculative") == "hit"
    assert "serving" not in [str(ns) for ns, _, _ in suggestions[0].metadata.all_items()]


def test_proto_free_admission_sheds_and_degrades():
    rt = runtime_lib.ServingRuntime(
        serving_config.ServingConfig(batching=False),
        admission=admission.AdmissionConfig(enabled=True, max_inflight=1, min_decisions=2,
                                            weights=(("low", 0.5),)))
    config, supporter = _study()
    computed = []
    try:
        def fallback(reason):
            return reliability.suggest_fallback(config.to_problem(), 2, study_name="x",
                                                max_trial_id=8, reason=reason)

        inner = []

        def live():
            # While tenant a holds the only slot, other tenants shed.
            inner.append(rt.admitted_suggest("owners/b/studies/s", None, fallback))
            inner.append(rt.admitted_suggest("owners/b/studies/s", None, fallback))
            inner.append(rt.admitted_suggest("owners/low/studies/s", None, fallback))
            computed.append(1)
            return runtime_lib.GuardedSuggestion(decision="a's")

        out = rt.admitted_suggest("owners/a/studies/s", live, fallback)
        assert out.decision == "a's" and computed == [1]
        shed = [o.error for o in inner[:2]]
        assert all(isinstance(e, admission.AdmissionShedError) for e in shed)
        assert "retry_after_ms=50" in str(shed[0]) and reliability.is_transient_exception(shed[0])
        degraded = inner[2]
        assert degraded.error is None and len(degraded.fallbacks) == 2
        for s in degraded.fallbacks:
            assert s.metadata.ns("admission").get("degraded") == "quasi_random"
            assert reliability.is_fallback_suggestion(s.metadata)
        snap = rt.admission_snapshot()
        assert snap["sheds_by_tenant"] == {"b": {"inflight_total": 2}}
        assert snap["degraded_by_tenant"] == {"low": 1} and snap["inflight"] == {}
        assert rt.breakers.states() == {}
    finally:
        rt.shutdown()


@pytest.mark.parametrize("default_count", [1, 5])
def test_a_crossover_speculates_the_default_count_as_the_jax_engine_does(default_count):
    """A surrogate crossover through the runtime's ``speculative_invalidate``
    forgets the study's recent request counts in both packages, so the next
    job speculates ``default_count``; a deployment whose clients ask for 5
    sets ``default_count=5`` (as the card's planes phase does)."""
    counts = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        h = _Harness(pkg, config=pkg.spec.SpeculativeConfig(
            speculative=True, default_count=default_count))
        try:
            h.entry()
            h.engine.note_live_suggest("s", 5)
            rt = types.SimpleNamespace(speculative_engine=h.engine)
            pkg.runtime.ServingRuntime.speculative_invalidate(rt, "s", "crossover:exact->sparse")
            h.frontier = ([1], [], 1)
            h.engine.notify_completion("s")
            assert h.engine.wait_idle(10.0)
            counts[name] = h.slot()[1]
        finally:
            h.engine.close()
    assert counts == {"port": default_count, "jax": default_count}
