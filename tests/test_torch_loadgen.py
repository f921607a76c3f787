"""The loadgen engine's models, overlay and report, held to the JAX package's.

- Every preset (``smoke_config``, ``hot_tenant_config``, ``soak_config``) at
  several seeds expands to the JAX package's ``Scenario``: the same
  ``as_dict()`` and fingerprint, summary, parity cohort and crossover
  studies, objectives and preseeded points. So do the samplers
  (``zipf_budgets``, ``arrival_times``, ``weighted_choice``), the event
  tracks (default and parsed) and ``from_env`` (the JAX package's
  ``VIZIER_LOADGEN_*`` switches against the port's
  ``VIZIER_TORCH_LOADGEN_*``).
- ``scenario_env`` maps each plane onto the port's switch: the JAX overlay
  with every ``VIZIER_*`` name under ``VIZIER_TORCH_*``.
- ``build_report``, ``diff_reports``, ``render_diff`` and ``render_verdict``
  give equal JSON and text on one synthetic set of driver records built in
  both packages; ``ranksum_p`` equal; ``ChaosMonkey`` gives the same strike
  schedule for a seed.
- The mesh plane runs on the placements its devices give: one on the CPU
  or one card, more on more devices (with the tests' 8 CPU entries).
- ``LoadgenPolicyFactory`` builds the service's policies on ``device="cpu"``
  with the scenario's per-study seeds and economics, and wraps GP designers
  in ``ChaosDesigner`` when given a monkey.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import sys

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.loadgen import driver as jdriver
from vizier_tpu.loadgen import models as jmodels
from vizier_tpu.loadgen import report as jreport
from vizier_tpu.testing import chaos as jchaos
from vizier_tpu_torch.loadgen import driver
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.loadgen import report
from vizier_tpu_torch.testing import chaos

_PRESETS = ("smoke_config", "hot_tenant_config", "soak_config")
_SEEDS = (0, 1, 7, 2024)


def _both(preset: str, **overrides):
    return (
        getattr(jmodels, preset)(**overrides),
        getattr(models, preset)(**overrides),
    )


# -- scenario expansion ------------------------------------------------------


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("preset", _PRESETS)
def test_preset_expands_to_the_jax_scenario(preset, seed):
    jconfig, config = _both(preset, seed=seed)
    assert config.as_dict() == jconfig.as_dict()
    jscenario, scenario = jmodels.build_scenario(jconfig), models.build_scenario(config)
    assert scenario.as_dict() == jscenario.as_dict()
    assert scenario.fingerprint() == jscenario.fingerprint()
    assert scenario.summary() == jscenario.summary()
    assert scenario.total_trials == jscenario.total_trials
    assert scenario.kinds_present() == jscenario.kinds_present()
    assert [s.index for s in scenario.parity_cohort()] == [
        s.index for s in jscenario.parity_cohort()]
    assert [s.index for s in scenario.crossover_studies()] == [
        s.index for s in jscenario.crossover_studies()]


@pytest.mark.parametrize("preset", _PRESETS)
def test_objectives_and_preseeds_equal(preset):
    jscenario = jmodels.build_scenario(getattr(jmodels, preset)(seed=3))
    scenario = models.build_scenario(getattr(models, preset)(seed=3))
    rng = random.Random(5)
    for jspec, spec in list(zip(jscenario.studies, scenario.studies))[:64]:
        assert scenario.optimum(spec) == jscenario.optimum(jspec)
        assert scenario.preseed_points(spec) == jscenario.preseed_points(jspec)
        params = {f"x{d}": rng.random() for d in range(scenario.config.dim)}
        assert scenario.objective(spec, params) == jscenario.objective(jspec, params)


def test_soak_fingerprint_constant():
    """The fingerprint the card's loadgen phase requires (chip_smoke.py's
    ``_SOAK_FINGERPRINT``) is the JAX package's live expansion."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    expected = jmodels.build_scenario(jmodels.soak_config()).fingerprint()
    assert chip_smoke._SOAK_FINGERPRINT == expected
    assert models.build_scenario(models.soak_config()).fingerprint() == expected


@pytest.mark.parametrize("seed", (0, 11))
def test_samplers_equal(seed):
    budgets = [
        m.zipf_budgets(random.Random(seed), 500, alpha=1.1, lo=1, hi=16)
        for m in (jmodels, models)
    ]
    assert budgets[0] == budgets[1]
    jconfig, config = _both("smoke_config", arrival_rate_per_s=80.0, burst_factor=6.0)
    assert models.arrival_times(random.Random(seed), config, 300) == jmodels.arrival_times(
        random.Random(seed), jconfig, 300)
    pairs = (("a", 3.0), ("b", 1.0), ("c", 0.5))
    assert [models.weighted_choice(random.Random(seed), pairs) for _ in range(50)] == [
        jmodels.weighted_choice(random.Random(seed), pairs) for _ in range(50)]


@pytest.mark.parametrize(
    "overrides",
    [
        dict(),
        dict(replicas=3),
        dict(target="inprocess"),
        dict(target="shared_compute"),
        dict(chaos_fault_prob=0.0, replicas=4),
    ],
    ids=["two_replicas", "severity", "inprocess", "shared_compute", "no_chaos"],
)
def test_default_event_tracks_equal(overrides):
    jconfig, config = _both("smoke_config", **overrides)
    for total in (1, 12, 400):
        assert [e.as_dict() for e in models.default_event_track(config, total)] == [
            e.as_dict() for e in jmodels.default_event_track(jconfig, total)]


def test_parsed_event_track_equal():
    track = "kill_replica:owner:0@0.4,revive_replica:owner:0@0.7,chaos_on@0.5,chaos_off@0.6"
    jconfig, config = _both("soak_config", seed=2)
    assert [e.as_dict() for e in models.parse_event_track(track, config)] == [
        e.as_dict() for e in jmodels.parse_event_track(track, jconfig)]
    with pytest.raises(ValueError):
        models.parse_event_track("kill_replica", config)
    with pytest.raises(ValueError):
        models.EventSpec(1, "explode")


def test_from_env_under_the_two_prefixes(monkeypatch):
    values = {"SEED": "9", "SCALE": "0.5", "STUDIES": "40", "TARGET": "inprocess",
              "EVENTS": "chaos_on@0.2,chaos_off@0.3"}
    for key, value in values.items():
        monkeypatch.setenv(f"VIZIER_LOADGEN_{key}", value)
        monkeypatch.setenv(f"VIZIER_TORCH_LOADGEN_{key}", value)
    config, jconfig = models.ScenarioConfig.from_env(), jmodels.ScenarioConfig.from_env()
    assert config.as_dict() == jconfig.as_dict()
    assert config.seed == 9 and config.total_studies == 20 and len(config.events) == 2
    assert models.ScenarioConfig.from_env(seed=4).as_dict() == jmodels.ScenarioConfig.from_env(
        seed=4).as_dict()
    monkeypatch.delenv("VIZIER_TORCH_LOADGEN_SEED")
    assert models.ScenarioConfig.from_env().seed == 0


@pytest.mark.parametrize(
    "overrides",
    [dict(target="warp"), dict(min_trials=0), dict(kind_mix=()), dict(kind_mix=(("nope", 1.0),))],
    ids=["target", "trials", "empty_mix", "unknown_kind"],
)
def test_config_validation_equal(overrides):
    with pytest.raises(ValueError) as jerr:
        jmodels.ScenarioConfig(**overrides)
    with pytest.raises(ValueError) as err:
        models.ScenarioConfig(**overrides)
    assert str(err.value) == str(jerr.value)


def test_registered_kinds_and_owner_names():
    assert models.registered_gp_kinds() == jmodels.registered_gp_kinds()
    assert models.KIND_TO_ALGORITHM == jmodels.KIND_TO_ALGORITHM
    assert models.tenant_owner("hot") == jmodels.tenant_owner("hot")
    assert models.owner_tenant("loadgen-hot") == "hot" == jmodels.owner_tenant("loadgen-hot")
    assert models.PlaneConfig.all_on().as_dict() == jmodels.PlaneConfig.all_on().as_dict()
    assert models.PlaneConfig.gated_off().as_dict() == jmodels.PlaneConfig.gated_off().as_dict()


# -- the planes' switches ------------------------------------------------------


@pytest.mark.parametrize(
    "preset,overrides",
    [
        ("smoke_config", {}),
        ("hot_tenant_config", {}),
        ("soak_config", {}),
        ("soak_config", {"planes": jmodels.PlaneConfig.gated_off()}),
    ],
    ids=["smoke", "hot_tenant", "soak", "gated_off"],
)
def test_scenario_env_maps_each_plane_onto_the_port_switch(preset, overrides):
    jconfig = getattr(jmodels, preset)(**overrides)
    if overrides:
        overrides = {"planes": models.PlaneConfig(**overrides["planes"].as_dict())}
    config = getattr(models, preset)(**overrides)
    expected = {
        name.replace("VIZIER_", "VIZIER_TORCH_", 1): value
        for name, value in jdriver.scenario_env(jconfig).items()
    }
    assert driver.scenario_env(config) == expected


def test_loadgen_reliability_equal():
    assert dataclasses.asdict(driver.loadgen_reliability()) == dataclasses.asdict(
        jdriver.loadgen_reliability())


def _stamp_of_a_built_executor(config, num_devices=0):
    """The stamp read off an executor built as the runtime builds it."""
    from vizier_tpu_torch.parallel import batch_executor, mesh as mesh_lib

    executor = batch_executor.BatchExecutor(
        mesh=mesh_lib.MeshConfig(enabled=True, num_devices=num_devices), device="cpu")
    try:
        return driver.mesh_stamp(config, "cpu", executor)
    finally:
        executor.close()


def test_mesh_runs_as_one_placement():
    """The JAX acceptance soak arms the mesh on one host device, which builds
    one placement; the port's CPU is one device too, and its stamp reads the
    placements off the run's executor."""
    config = models.soak_config()
    assert driver.mesh_stamp(models.smoke_config(), "cpu", None) == {
        "armed": False, "placements": 0}
    assert _stamp_of_a_built_executor(config) == {"armed": True, "placements": 1, "device": "cpu"}
    # A run with no executor in this process builds no placement here.
    assert driver.mesh_stamp(config, "cpu", None) == {"armed": True, "placements": 0, "device": "cpu"}
    scenario = models.build_scenario(models.smoke_config(
        num_studies=3, kind_mix=(("random", 1.0), ("gp_bandit", 1.0)),
        planes=models.PlaneConfig(batching=True, speculative=False, mesh=True, slo=False)))
    engine = driver.run(scenario, device="cpu", transport="runtime")
    assert engine.mesh == {"armed": True, "placements": 1, "device": "cpu"}
    assert engine.lost_studies() == [] and engine.errored_studies() == []


def test_a_mesh_armed_scenario_runs_on_every_placement_it_builds(monkeypatch):
    """On more devices (the tests' 8 CPU entries), capped at 2 by the mesh's
    switch, the runtime's executor builds two placements and serves the
    scenario through their workers."""
    import torch_mesh_devices

    torch_mesh_devices.patch_devices(monkeypatch)
    monkeypatch.setenv("VIZIER_TORCH_MESH_DEVICES", "2")
    config = models.soak_config()
    assert _stamp_of_a_built_executor(config, num_devices=2) == {
        "armed": True, "placements": 2, "device": "cpu"}
    scenario = models.build_scenario(models.smoke_config(
        num_studies=3, kind_mix=(("random", 1.0), ("gp_ucb_pe", 1.0)),
        planes=models.PlaneConfig(batching=True, speculative=False, mesh=True, slo=False)))
    engine = driver.run(scenario, device="cpu", transport="runtime")
    assert engine.mesh == {"armed": True, "placements": 2, "device": "cpu"}
    assert engine.lost_studies() == [] and engine.errored_studies() == []


def test_a_mesh_armed_scenario_runs_on_subprocess_replicas():
    """The subprocess target's runtimes live in its replica processes, so the
    driver holds a detached runtime with no executor: the run completes and
    its stamp reports no placement in the driver's process."""
    scenario = models.build_scenario(models.smoke_config(
        num_studies=2, target="subprocess", replicas=1, kind_mix=(("random", 1.0),),
        planes=models.PlaneConfig(batching=True, speculative=False, mesh=True, slo=False)))
    engine = driver.run(scenario, device="cpu")
    assert engine.mesh == {"armed": True, "placements": 0, "device": "cpu"}
    assert engine.lost_studies() == [] and engine.errored_studies() == []


# -- the report ----------------------------------------------------------------


def _records(pkg, scenario, *, arm="engine", lost=(), fallbacks=0, hits=0, errors=(),
             events=(), stats=None, admission=None, slo=None, latency=0.002):
    """One synthetic arm, built in ``pkg`` (either package's driver module)."""
    records, outcomes = [], {}
    for spec in scenario.studies:
        completed = spec.budget
        outcomes[spec.index] = pkg.StudyOutcome(
            spec=spec,
            completed=completed,
            expected=spec.budget,
            listed_completed=0 if spec.index in lost else spec.preseed + completed,
            trajectory=tuple(((("x0", 0.1 * (i + 1)), ("x1", 0.2)),) for i in range(completed)),
            best_curve=tuple(-1.0 + 0.01 * i + 0.001 * spec.index for i in range(completed)),
            error="boom" if spec.index in errors else None,
        )
        for step in range(spec.budget):
            records.append(pkg.RequestRecord(
                spec.index, spec.kind, spec.tenant, "suggest",
                latency * (1 + step + spec.index % 3),
                trace_id=f"t{spec.index}-{step}",
                fallback=fallbacks > 0 and step == 0,
                speculative_hit=hits > 0 and step == 0,
                degraded=spec.index % 5 == 1 and step == 0,
                error=("TRANSIENT: RESOURCE_EXHAUSTED: shed" if spec.index in errors else None),
            ))
            records.append(pkg.RequestRecord(
                spec.index, spec.kind, spec.tenant, "complete", 0.001, trace_id=f"t{spec.index}-{step}"))
    return pkg.SoakResult(
        arm=arm,
        scenario_fingerprint=scenario.fingerprint(),
        records=records,
        outcomes=outcomes,
        events_fired=[dict(e) for e in events],
        serving_stats=dict(stats or {"failovers": 1, "restored_studies": 2, "cold_trains": 3}),
        slo=dict(slo or {"armed": True, "breaching": [], "evaluations": 2}),
        wall_s=1.5,
        admission=dict(admission or {"enabled": False}),
    )


_ADMISSION = {"enabled": True, "sheds_by_tenant": {"prod": {"tenant_cap": 2}},
              "admits_by_tenant": {"prod": 30, "batch": 9}, "degraded_by_tenant": {"dev": 1}}
_VARIANTS = {
    "clean": dict(),
    "lost_and_errored": dict(lost=(0,), errors=(2,)),
    "fallbacks_and_hits": dict(fallbacks=1, hits=1),
    "events": dict(events=({"kind": "kill_replica", "fired_at": 3, "replica": "replica-0"},
                           {"kind": "chaos_on", "fired_at": 4, "skipped": "x"})),
    "admission": dict(admission=_ADMISSION),
    "slo_breach": dict(slo={"armed": True, "breaching": ["suggest_p99:pythia"], "evaluations": 1}),
}


def _report_pair(name, *, preset="smoke_config", config_overrides=None, arms=True):
    overrides = dict(num_studies=10, **(config_overrides or {}))
    jscenario = jmodels.build_scenario(getattr(jmodels, preset)(**overrides))
    scenario = models.build_scenario(getattr(models, preset)(**overrides))
    kwargs = _VARIANTS[name]
    out = []
    for pkg, rep, sc in ((jdriver, jreport, jscenario), (driver, report, scenario)):
        engine = _records(pkg, sc, **kwargs)
        reference = gated = None
        if arms:
            cohort = {s.index for s in sc.parity_cohort()}
            reference = _records(pkg, sc, arm="reference")
            gated = _records(pkg, sc, arm="gated_off")
            for arm in (reference, gated):
                arm.outcomes = {i: o for i, o in arm.outcomes.items() if i in cohort}
        out.append(rep.build_report(sc, engine, reference, gated, stamps={"who": "x"}))
    return out


@pytest.mark.parametrize("name", sorted(_VARIANTS))
@pytest.mark.parametrize(
    "preset,config_overrides",
    [("smoke_config", None), ("soak_config", None), ("smoke_config", {"target": "subprocess"})],
    ids=["smoke", "soak_planes", "subprocess"],
)
def test_report_equal_on_the_same_records(name, preset, config_overrides):
    jrep, rep = _report_pair(name, preset=preset, config_overrides=config_overrides)
    assert json.dumps(rep, sort_keys=True) == json.dumps(jrep, sort_keys=True)
    assert report.render_verdict(rep) == jreport.render_verdict(jrep)


def test_report_without_arms_equal():
    jrep, rep = _report_pair("clean", arms=False)
    assert rep == jrep
    assert not rep["ok"]


@pytest.mark.parametrize("latency_ratio", (0.0, 1.5))
def test_diff_equal(latency_ratio):
    before = _report_pair("clean")
    after = _report_pair("lost_and_errored")
    admission = _report_pair("admission")
    for a, b in ((0, 1), (1, 0)):
        for pair in ((before, after), (before, admission), (admission, before)):
            jdiff = jreport.diff_reports(pair[a][0], pair[b][0], latency_ratio=latency_ratio)
            diff = report.diff_reports(pair[a][1], pair[b][1], latency_ratio=latency_ratio)
            assert diff == jdiff
            assert report.render_diff(diff) == jreport.render_diff(jdiff)


@pytest.mark.parametrize("seed", (0, 3))
def test_ranksum_equal(seed):
    rng = random.Random(seed)
    a = [rng.gauss(0, 1) for _ in range(9)]
    b = [rng.gauss(0.5, 1) for _ in range(7)]
    assert report.ranksum_p(a, b) == jreport.ranksum_p(a, b)
    assert report.ranksum_p([], b) == jreport.ranksum_p([], b) == 1.0


# -- the chaos monkey ----------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 5, 99))
def test_chaos_monkey_strike_schedule_equal(seed):
    def schedule(pkg):
        slept = []
        monkey = pkg.ChaosMonkey(seed=seed, failure_prob=0.3, latency_prob=0.2,
                                 latency_secs=0.5, sleep_fn=slept.append)
        faults = []
        for i in range(200):
            try:
                monkey.strike(f"site{i % 3}")
                faults.append(False)
            except pkg.InjectedFaultError:
                faults.append(True)
        return faults, monkey.counts(), monkey.total_faults(), len(slept)

    assert schedule(chaos) == schedule(jchaos)
    with pytest.raises(ValueError):
        chaos.ChaosMonkey(failure_prob=1.5)


# -- the policy factory -------------------------------------------------------


def test_policy_factory_routes_with_the_scenario_economics():
    from vizier_tpu_torch.pythia import local_policy_supporters
    from vizier_tpu_torch.serving import ServingRuntime

    scenario = models.build_scenario(models.smoke_config())
    spec = next(s for s in scenario.studies if s.kind == "gp_bandit")
    config = driver._study_config(spec, 2)
    supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid=spec.name)
    runtime = ServingRuntime()
    try:
        factory = driver.LoadgenPolicyFactory(scenario, device="cpu")
        factory.bind_runtime(runtime)
        factory._local.gp_kwargs = factory._gp_overrides(spec.name)
        kwargs = factory._base._gp_designer_kwargs()
        assert kwargs["rng_seed"] == spec.seed and kwargs["device"] == "cpu"
        assert kwargs["max_acquisition_evaluations"] == 50 and kwargs["ard_restarts"] == 2
        assert kwargs["ard_optimizer"].maxiter == 10 and kwargs["warm_start_min_trials"] == 0
        factory._local.gp_kwargs = None
        policy = factory(config.to_problem(), "GAUSSIAN_PROCESS_BANDIT", supporter, spec.name)
        assert type(policy).__name__ == "CachedDesignerStatePolicy"
        random_spec = next(s for s in scenario.studies if s.kind == "random")
        policy = factory(config.to_problem(), "RANDOM_SEARCH", supporter, random_spec.name)
        assert type(policy).__name__ == "DesignerPolicy"

        monkey = chaos.ChaosMonkey(seed=0, failure_prob=0.0)
        chaotic = driver.LoadgenPolicyFactory(scenario, device="cpu", chaos=monkey)
        chaotic.bind_runtime(runtime)
        policy = chaotic(config.to_problem(), "GAUSSIAN_PROCESS_BANDIT", supporter, spec.name)
        designer = policy._designer_factory(config.to_problem())
        assert isinstance(designer, chaos.ChaosDesigner)
        assert type(designer._inner).__name__ == "VizierGPBandit"
    finally:
        runtime.shutdown()


# -- the runtime transport: the servicer's order ---------------------------------


class _SlowPolicyFactory:
    """A factory whose policy counts its computations and takes ``secs``
    over each, for the runtime transport's order tests."""

    should_be_cached = True

    def __init__(self, secs: float):
        self.secs = secs
        self.computations = 0

    def bind_runtime(self, serving_runtime):
        del serving_runtime

    def __call__(self, problem, algorithm, supporter, study_name):
        del problem, algorithm, supporter, study_name
        return self

    def suggest(self, request):
        import time

        from vizier_tpu_torch import pyvizier as vz
        from vizier_tpu_torch.pythia import policy as policy_lib

        self.computations += 1
        time.sleep(self.secs)
        return policy_lib.SuggestDecision(
            [vz.TrialSuggestion(parameters={"x0": 0.5, "x1": 0.5})] * request.count
        )


def _runtime_target(monkeypatch, secs: float, reliability):
    scenario = models.build_scenario(models.smoke_config(num_studies=2))
    monkeypatch.setenv("VIZIER_TORCH_SERVING_COALESCING", "1")
    factory = _SlowPolicyFactory(secs)
    target = driver._RuntimeTarget(scenario, reliability, factory, "cpu")
    spec = scenario.studies[0]
    target.open_study(spec, driver._study_config(spec, scenario.config.dim), reliability, None)
    return target, target._study(spec.name), factory


def test_runtime_transport_coalesces_as_the_servicer(monkeypatch):
    """Two concurrent suggests against one frontier run one designer
    computation through ``ServingRuntime.serve_suggest``'s coalescer, as the
    servicer's do; each caller gets its own trials."""
    import threading
    import time

    from vizier_tpu_torch.reliability import deadline

    target, study, factory = _runtime_target(monkeypatch, 0.4, driver.loadgen_reliability())
    try:
        out = []
        threads = [threading.Thread(target=lambda: out.append(
            target.suggest(study, 1, deadline.Deadline.none()))) for _ in range(2)]
        threads[0].start()
        time.sleep(0.1)
        threads[1].start()
        for t in threads:
            t.join()
        stats = target.serving_stats()
        assert factory.computations == 1
        assert stats["coalesced_requests"] == 1 and stats["coalesced_computations"] == 1
        assert sorted(t.id for trials in out for t in trials) == [1, 2]
    finally:
        target.shutdown()


def test_runtime_transport_carries_the_client_deadline(monkeypatch):
    """The runtime client sends the reliability's default deadline as the
    request's wire budget: a computation that outlasts it completes the op
    with the typed deadline error, counted as the servicer counts it."""
    from vizier_tpu_torch.reliability import errors

    reliability = dataclasses.replace(
        driver.loadgen_reliability(), default_deadline_secs=0.3, retry_max_attempts=1)
    target, study, factory = _runtime_target(monkeypatch, 0.6, reliability)
    try:
        client = driver._RuntimeClient(target, study, reliability, seed=0)
        with pytest.raises(errors.DeadlineExceededError):
            client.get_suggestions(1)
        assert factory.computations == 1
        assert target.serving_stats()["deadline_exceeded"] == 1
    finally:
        target.shutdown()


def test_runtime_transport_sends_a_spent_budget_negative(monkeypatch):
    """A budget already spent when the request is sent travels negative (0
    would mean no deadline): the typed deadline error, before any designer
    computation, as the servicer sheds the service client's."""
    from vizier_tpu_torch.reliability import deadline as deadline_lib
    from vizier_tpu_torch.reliability import errors

    target, study, factory = _runtime_target(monkeypatch, 0.0, driver.loadgen_reliability())
    try:
        spent = deadline_lib.Deadline.from_budget(1e-6)
        while not spent.expired:
            pass
        with pytest.raises(errors.DeadlineExceededError):
            target.suggest(study, 1, spent)
        assert factory.computations == 0
        assert target.serving_stats()["deadline_exceeded"] == 1
    finally:
        target.shutdown()
