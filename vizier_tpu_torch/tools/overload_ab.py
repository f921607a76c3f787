"""Hot-tenant overload A/B: the admission plane ON vs OFF.

Usage: python -m vizier_tpu_torch.tools.overload_ab [--studies N] [--seed 0]
       [--budget-ms MS] [--transport service|runtime] [--device cuda|cpu]
       [--out FILE]

The port's counterpart of the JAX package's ``tools/overload_ab.py``, with
its flags, report keys, assertions and public functions. The report is
printed as one JSON line, and written to ``--out`` when given (there is no
default file); the tool exits 1 when an assertion fails.

Drives the loadgen ``hot_tenant`` scenario (``loadgen.models.hot_tenant_config``:
one Zipf-head tenant floods the serving tier with GP compute at a saturating
open-loop rate, real arrival pacing, while three light tenants run occasional
GP studies) through the serving stack twice:

- **ON**: the scenario's planes, admission armed (``VIZIER_TORCH_ADMISSION=1``:
  per-tenant in-flight caps, weighted deficit-round-robin flush selection,
  deadline-aware shedding, and the healthy -> shedding -> degraded state
  machine; the hot tenant's sub-floor weight routes it to stamped
  quasi-random under sustained saturation);
- **OFF**: the identical workload with the plane gated off.

Before them a closed-loop warmup arm (unmeasured) pays every layout's first
use; after them the parity cohort's sequential reference and gated-off arms
check that the off switch is the path without admission.

Assertions: ON loses and errors no study; the light tenants' suggest p99 is
within the SLO budget; sheds are nonzero and confined to the hot tenant; no
shed trips a circuit breaker; OFF's light p99 is past the budget; the
gated-off arm is bit-identical to the reference.

``--transport`` is ``service`` (the default, the JAX tool's: the in-process
Vizier service over the port's protobuf messages) or ``runtime`` (one
``ServingRuntime`` through the loadgen's runtime transport, no protobuf).
``--budget-ms`` sets the light-tenant p99 budget: the scenario's 1 000 ms
was set between the two arms' light p99 where one GP compute takes ~80 ms.
The scenario stretches its first GP study across the sparse threshold (64
trials) so the crossover gets traffic, though the A/B's GP stays exact: 63
sequential computes in every arm that runs the study. ``--no-crossover-study``
keeps that study at the scenario's 3 trials, a cut in depth where one
compute takes seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.loadgen import driver as driver_lib
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.loadgen import report as report_lib
from vizier_tpu_torch.tools.warm_start_ab import write_report

LIGHT = ("light-a", "light-b", "light-c")


def _progress(msg: str) -> None:
    print(f"[overload_ab] {msg}", file=sys.stderr, flush=True)


def _suggest_latencies_ms(result, tenants):
    return sorted(
        r.latency_s * 1e3
        for r in result.records
        if r.op == "suggest" and r.error is None and r.tenant in tenants
    )


def _p99_ms(values):
    if not values:
        return 0.0
    rank = 0.99 * (len(values) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(values) - 1)
    frac = rank - lo
    return round(values[lo] * (1 - frac) + values[hi] * frac, 3)


def _arm_summary(result):
    outcomes = report_lib._outcome_tables(result)
    light = _suggest_latencies_ms(result, set(LIGHT))
    hot = _suggest_latencies_ms(result, {"hot"})
    stats = {
        k: v
        for k, v in sorted(result.serving_stats.items())
        if isinstance(v, int) and v
    }
    return {
        "wall_s": result.wall_s,
        "lost_studies": result.lost_studies(),
        "errored_studies": result.errored_studies(),
        "light_suggest_p99_ms": _p99_ms(light),
        "light_suggests": len(light),
        "hot_suggest_p99_ms": _p99_ms(hot),
        "hot_suggests": len(hot),
        "by_tenant": outcomes["by_tenant"],
        "admission": result.admission,
        "open_loop_capped": result.open_loop_capped,
        "breaker_transitions": stats.get("breaker_open_transitions", 0),
        "serving_stats": stats,
        "slo_breaching": sorted(result.slo.get("breaching", []))
        if result.slo.get("armed")
        else [],
    }


def scenario_config(args) -> models.ScenarioConfig:
    """``hot_tenant_config()`` with the command line's overrides."""
    overrides = {"seed": args.seed}
    if args.studies:
        overrides["num_studies"] = args.studies
    if args.budget_ms:
        overrides["p99_budget_ms"] = args.budget_ms
    if args.no_crossover_study:
        overrides["ensure_crossover"] = False
    return models.hot_tenant_config(**overrides)


def run(args) -> dict:
    """The A/B's report; ``report["ok"]`` is whether every assertion held."""
    device = device_lib.resolve(args.device)
    transport = args.transport
    if transport == "service":
        from vizier_tpu_torch.service import vizier_client

        vizier_client.environment_variables.polling_delay_secs = 0.005

    config = scenario_config(args)
    scenario = models.build_scenario(config)
    budget_ms = config.p99_budget_ms
    _progress(
        f"hot_tenant scenario: {len(scenario.studies)} studies / {scenario.total_trials} "
        f"trials, open-loop time_scale={config.time_scale}, light-p99 budget {budget_ms} ms, "
        f"transport {transport}")

    def drive(scenario_, arm):
        return driver_lib.run(scenario_, arm=arm, device=device, transport=transport)

    t0 = time.time()
    # Warmup arm (unmeasured): the same workload once, closed-loop, so every
    # layout's first use (kernel build, graph captures) is paid before the
    # measured arms, which then compare serving behaviour alone.
    warm_config = dataclasses.replace(
        config,
        time_scale=0.0,
        planes=dataclasses.replace(config.planes, admission=False, slo=False),
    )
    warm = drive(models.build_scenario(warm_config), "warmup")
    _progress(f"warmup arm done in {warm.wall_s}s")

    on = drive(scenario, "admission_on")
    _progress(f"ON arm done in {on.wall_s}s")

    off = drive(models.build_scenario(dataclasses.replace(
        config, planes=dataclasses.replace(config.planes, admission=False))), "admission_off")
    _progress(f"OFF arm done in {off.wall_s}s")

    # VIZIER_TORCH_ADMISSION=0 bit-identity: the gated-off engine arm must
    # replay the cohort exactly as the sequential reference does.
    reference = driver_lib.run_reference(scenario, device=device, transport=transport)
    gated = driver_lib.run_gated_off(scenario, device=device, transport=transport)
    bit = report_lib._bit_identity_section(gated, reference)
    _progress(f"bit-identity cohort: {bit['studies_compared']} studies, "
              f"identical={bit['identical']}")

    on_summary = _arm_summary(on)
    off_summary = _arm_summary(off)
    on_sheds = (on.admission or {}).get("sheds_by_tenant", {})
    shed_tenants = sorted(t for t, r in on_sheds.items() if sum(r.values()))
    total_sheds = sum(sum(r.values()) for r in on_sheds.values())

    assertions = []

    def check(name, ok, detail):
        assertions.append({"name": name, "ok": bool(ok), "detail": detail})

    check(
        "on_zero_lost_studies",
        not on_summary["lost_studies"] and not on_summary["errored_studies"],
        f"lost={on_summary['lost_studies']} errored={on_summary['errored_studies']}",
    )
    check(
        "on_light_p99_within_slo",
        0 < on_summary["light_suggest_p99_ms"] <= budget_ms,
        f"light p99 {on_summary['light_suggest_p99_ms']} ms "
        f"(budget {budget_ms} ms, {on_summary['light_suggests']} suggests)",
    )
    check(
        "on_sheds_nonzero_confined_to_hot",
        total_sheds > 0 and shed_tenants == ["hot"],
        f"sheds={total_sheds} by tenant {on_sheds}",
    )
    check(
        "on_sheds_never_trip_breaker",
        on_summary["breaker_transitions"] == 0,
        f"breaker_open_transitions={on_summary['breaker_transitions']} "
        f"with {total_sheds} sheds",
    )
    check(
        "off_light_p99_collapses",
        off_summary["light_suggest_p99_ms"] > budget_ms,
        f"light p99 {off_summary['light_suggest_p99_ms']} ms OFF vs "
        f"{on_summary['light_suggest_p99_ms']} ms ON (budget {budget_ms})",
    )
    check(
        "admission_off_bit_identical",
        bit["identical"],
        f"compared={bit['studies_compared']} mismatched={bit['mismatched']}",
    )

    ratio = (
        round(off_summary["light_suggest_p99_ms"] / on_summary["light_suggest_p99_ms"], 2)
        if on_summary["light_suggest_p99_ms"]
        else None
    )
    return {
        "version": 1,
        "what": (
            "hot-tenant overload A/B: saturating open-loop loadgen "
            "scenario through the serving stack, admission plane "
            "ON vs OFF; light-tenant p99 + zero lost studies + sheds "
            "confined to the hot tenant with the plane ON, collapse "
            "with it OFF, VIZIER_TORCH_ADMISSION=0 bit-identical to the "
            "path without admission"
        ),
        "scenario": {
            "config": config.as_dict(),
            "fingerprint": on.scenario_fingerprint,
        },
        "slo_budget_ms": budget_ms,
        "light_p99_off_over_on": ratio,
        "arms": {"admission_on": on_summary, "admission_off": off_summary},
        "bit_identity": bit,
        "assertions": assertions,
        "ok": all(a["ok"] for a in assertions),
        "wall_seconds_total": round(time.time() - t0, 1),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=0,
                    help="override the scenario study count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="override the light-tenant p99 SLO budget")
    ap.add_argument("--no-crossover-study", action="store_true",
                    help="keep the first GP study at the scenario's trial budget instead of "
                         "stretching it across the sparse threshold (63 -> 3 trials)")
    ap.add_argument("--transport", choices=driver_lib.TRANSPORTS, default="service",
                    help="service (protobuf servicers, the default) or runtime (no protobuf)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = parser().parse_args(argv)
    report = run(args)
    write_report(report, args.out)
    for a in report["assertions"]:
        _progress(f"  [{'ok' if a['ok'] else 'FAIL'}] {a['name']}: {a['detail']}")
    if not report["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
