"""The port's mini-soak on the CPU, held to the JAX package's.

The smoke scenario end to end through the port's REAL stack on
``device="cpu"``: every registered compute-IR program kind gets traffic
(exact + sparse GP-bandit, exact + sparse UCB-PE, with a surrogate
crossover mid-run), a 2-replica WAL-backed tier takes a kill AND a revive,
batching + SLO planes armed; then the sequential reference and gated-off
arms, asserted through the port's report. Against the JAX package's smoke
soak on the same scenario: the random and quasi-random studies' trajectories
are equal (both packages draw with ``np.random.default_rng(seed)`` and the
same Halton sequence), and the GP cohort's final bests pass the report's
rank-sum. Also: the runtime transport (no protobuf) on the smoke scenario,
the severity track on a 3-replica tier, the soak command line, and, marked
``slow`` as the JAX package's chaos soak is, a chaos soak with transport
faults on the replica tier and designer faults on the runtime transport.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.loadgen import driver as jdriver
from vizier_tpu.loadgen import models as jmodels
from vizier_tpu.service import vizier_client as jvizier_client
from vizier_tpu_torch.loadgen import driver
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.loadgen import report
from vizier_tpu_torch.loadgen import soak
from vizier_tpu_torch.service import vizier_client


@pytest.fixture(scope="module", autouse=True)
def _fast_polling():
    saved = (vizier_client.environment_variables.polling_delay_secs,
             jvizier_client.environment_variables.polling_delay_secs)
    vizier_client.environment_variables.polling_delay_secs = 0.005
    jvizier_client.environment_variables.polling_delay_secs = 0.005
    yield
    (vizier_client.environment_variables.polling_delay_secs,
     jvizier_client.environment_variables.polling_delay_secs) = saved


@pytest.fixture(scope="module")
def soak_arms():
    scenario = models.build_scenario(models.smoke_config())
    engine = driver.run(scenario, arm="engine", device="cpu")
    reference = driver.run_reference(scenario, device="cpu")
    gated = driver.run_gated_off(scenario, device="cpu")
    return scenario, engine, reference, gated


@pytest.fixture(scope="module")
def soak_report(soak_arms):
    scenario, engine, reference, gated = soak_arms
    return report.build_report(scenario, engine, reference, gated)


@pytest.fixture(scope="module")
def jax_engine():
    return jdriver.run(jmodels.build_scenario(jmodels.smoke_config()), arm="engine")


class TestMiniSoak:
    def test_all_assertions_pass(self, soak_report):
        failed = [a for a in soak_report["assertions"] if not a["ok"]]
        assert soak_report["ok"], failed
        assert {a["name"] for a in soak_report["assertions"]} == {
            "zero_lost_studies", "all_kinds_served", "all_events_fired", "failover_complete",
            "fallback_rate_bounded", "slo_evaluated", "regret_parity",
            "bit_identical_when_gated"}

    def test_all_program_kinds_served(self, soak_arms, soak_report):
        _, engine, _, _ = soak_arms
        served = {
            kind
            for kind, row in soak_report["outcomes"]["by_kind"].items()
            if row["suggests"] - row["errors"] > 0
        }
        assert set(models.GP_KINDS) <= served
        stats = engine.serving_stats
        assert stats.get("cold_trains", 0) + stats.get("warm_trains", 0) > 0
        assert stats.get("sparse_suggests", 0) > 0
        assert stats.get("surrogate_crossovers", 0) >= 1

    def test_kill_and_revive_fired_and_failed_over(self, soak_arms):
        _, engine, _, _ = soak_arms
        fired = {e["kind"] for e in engine.events_fired}
        assert {"kill_replica", "revive_replica"} <= fired
        assert int(engine.serving_stats.get("failovers", 0)) >= 1

    def test_zero_lost_studies(self, soak_arms):
        _, engine, _, _ = soak_arms
        assert engine.lost_studies() == []
        assert engine.errored_studies() == []
        for outcome in engine.outcomes.values():
            assert outcome.completed == outcome.expected
            assert outcome.listed_completed == outcome.spec.preseed + outcome.completed

    def test_gated_off_is_bit_identical_to_reference(self, soak_report):
        bit = soak_report["bit_identity"]
        assert bit["identical"], bit["mismatched"]
        assert bit["studies_compared"] >= 4

    def test_outcomes_recorded_with_trace_ids(self, soak_arms):
        _, engine, _, _ = soak_arms
        kinds = engine.recorder_event_kinds
        assert kinds.get("loadgen_outcome", 0) >= sum(
            o.completed for o in engine.outcomes.values())
        assert kinds.get("replica_failover", 0) >= 1
        suggests = [r for r in engine.records if r.op == "suggest"]
        assert suggests and all(r.trace_id for r in suggests)

    def test_report_renders_and_serializes(self, soak_report):
        assert "soak: PASS" in report.render_verdict(soak_report)
        assert json.loads(json.dumps(soak_report))["version"] == report.REPORT_VERSION


class TestAgainstTheJaxSoak:
    def test_same_scenario(self, soak_arms, jax_engine):
        _, engine, _, _ = soak_arms
        assert engine.scenario_fingerprint == jax_engine.scenario_fingerprint
        assert engine.lost_studies() == jax_engine.lost_studies() == []

    def test_random_and_quasi_random_trajectories_equal(self, soak_arms, jax_engine):
        scenario, engine, _, _ = soak_arms
        baseline = [s.index for s in scenario.studies if s.kind in ("random", "quasi_random")]
        assert baseline
        for index in baseline:
            assert engine.outcomes[index].trajectory == jax_engine.outcomes[index].trajectory
            assert engine.outcomes[index].best_curve == jax_engine.outcomes[index].best_curve

    def test_gp_cohort_held_by_the_rank_sum(self, soak_arms, jax_engine):
        scenario, engine, _, _ = soak_arms
        gp = [s.index for s in scenario.studies if s.kind in models.GP_KINDS]
        port_best = [engine.outcomes[i].final_best for i in gp]
        jax_best = [jax_engine.outcomes[i].final_best for i in gp]
        assert report.ranksum_p(port_best, jax_best) >= scenario.config.parity_alpha


def test_runtime_transport_smoke():
    """No protobuf on the path: every assertion that needs no replica
    passes, the replica events are recorded as skipped."""
    scenario = models.build_scenario(models.smoke_config())
    arms = [fn(scenario, device="cpu", transport="runtime")
            for fn in (driver.run, driver.run_reference, driver.run_gated_off)]
    rep = report.build_report(scenario, *arms)
    verdicts = {a["name"]: a["ok"] for a in rep["assertions"]}
    assert verdicts.pop("all_events_fired") is False
    assert verdicts.pop("failover_complete") is False
    assert all(verdicts.values()), rep["assertions"]
    assert {e["skipped"] for e in arms[0].events_fired} == {"no replica tier"}
    assert arms[0].serving_stats["surrogate_crossovers"] >= 1
    # The GP designers are wrapped; no window is open, so nothing strikes.
    counts = arms[0].chaos_counts
    assert counts["designer.suggest"]["calls"] >= 4
    assert all(c["faults"] == 0 for c in counts.values())


def test_severity_track_zero_lost():
    config = models.smoke_config(
        name="severity", replicas=3, num_studies=12, max_trials=4,
        kind_mix=(("random", 4.0), ("quasi_random", 2.0)),
        planes=models.PlaneConfig(batching=False, speculative=False, mesh=False, slo=False),
    )
    scenario = models.build_scenario(config)
    kinds = [e.kind for e in scenario.events]
    assert kinds == ["multi_kill", "wal_corrupt", "rolling_restart"]
    result = driver.run(scenario, arm="engine", device="cpu")
    fired = {e["kind"]: e for e in result.events_fired}
    assert set(fired) == set(kinds)
    for event in result.events_fired:
        assert "error" not in event and "skipped" not in event, event
    assert len(fired["multi_kill"]["replicas"]) == 2
    assert fired["wal_corrupt"]["corruption"]["log_bytes"] > 64
    restarted = fired["rolling_restart"]
    assert sorted(restarted["revived_first"] + restarted["restarted"]) == [
        f"replica-{i}" for i in range(3)]
    assert result.lost_studies() == [] and result.errored_studies() == []
    assert result.serving_stats["failovers"] >= 3
    assert result.serving_stats["recovery_sources"].get("standby", 0) >= 1


def test_soak_command_line(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert soak.main(["--smoke", "--device", "cpu", "--transport", "runtime",
                      "--skip-reference", "--out", str(out)]) == 1
    written = json.loads(out.read_text())
    assert written["stamps"]["device"] == "cpu"
    assert written["stamps"]["transport"] == "runtime"
    assert written["stamps"]["compute_programs"] == list(models.registered_gp_kinds())
    assert written["scenario"]["fingerprint"] == models.build_scenario(
        models.smoke_config()).fingerprint()
    assert soak.main(["--diff", str(out), str(out)]) == 0
    assert "soak diff: OK" in capsys.readouterr().out
    # More mesh devices than the run has are capped: the CPU is one placement.
    soak.main(["--smoke", "--device", "cpu", "--transport", "runtime", "--skip-reference",
               "--studies", "3", "--mesh-devices", "2", "--out", str(out)])
    assert json.loads(out.read_text())["stamps"]["mesh"] == {
        "armed": True, "placements": 1, "device": "cpu"}


@pytest.mark.slow
def test_chaos_soak_failover_and_designer_faults():
    """The port's long chaos soak: a 3-replica tier under the severity
    track with a transport-fault window at 30%, every study completing
    through the client's retries and the tier's failovers; then the runtime
    transport with the same window striking the GP designers, where every
    fallback is one injected designer fault."""
    config = models.smoke_config(
        name="chaos", replicas=3, num_studies=32, max_trials=6, chaos_fault_prob=0.3,
        kind_mix=(("random", 3.0), ("quasi_random", 1.0), ("gp_bandit", 1.0),
                  ("gp_ucb_pe", 1.0)),
    )
    scenario = models.build_scenario(config)
    assert {"chaos_on", "chaos_off", "multi_kill", "rolling_restart"} <= {
        e.kind for e in scenario.events}
    engine = driver.run(scenario, device="cpu")
    assert engine.lost_studies() == [] and engine.errored_studies() == []
    assert sum(c["faults"] for c in engine.chaos_counts.values()) >= 1
    assert engine.serving_stats["failovers"] >= 3
    for event in engine.events_fired:
        assert "error" not in event and "skipped" not in event, event

    # The runtime transport, with the window over most of the run.
    windowed = dataclasses.replace(
        config, events=models.parse_event_track("chaos_on@0.05,chaos_off@0.95", config))
    runtime = driver.run(models.build_scenario(windowed), device="cpu", transport="runtime")
    assert runtime.lost_studies() == [] and runtime.errored_studies() == []
    faults = {site: c["faults"] for site, c in runtime.chaos_counts.items()}
    stats = runtime.serving_stats
    fallbacks = sum(1 for r in runtime.records if r.op == "suggest" and r.fallback)
    designer_faults = sum(faults.get(f"designer.{s}", 0)
                          for s in ("suggest", "batch_prepare", "batch_finalize"))
    assert designer_faults >= 1 and fallbacks >= 1
    assert stats["designer_failures"] == designer_faults
    assert stats["fallbacks"] == stats["designer_failures"] + stats["breaker_short_circuits"]
    assert fallbacks <= stats["fallbacks"]
    assert stats["batch_slot_errors"] == (faults.get("designer.batch_prepare", 0)
                                          + faults.get("designer.batch_finalize", 0))
