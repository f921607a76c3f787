"""The soak assertion engine: one report, one verdict.

The port's copy of the JAX package's ``loadgen/report.py``: on the same
driver results it builds the same report, key for key, and the same
verdict text. Sections:

- **scenario** — the config + deterministic fingerprint + the registered
  program-kind universe the mix was validated against;
- **traffic** — what was actually driven: studies/trials per kind and
  tenant, achieved arrival shape, wall time;
- **outcomes** — the per-kind table: suggest latency percentiles,
  speculative hits, fallbacks, errors;
- **slo** — the SLO engine's own ``slo_report()`` (p99s per hop, burn
  rates, breached set) from the armed run;
- **failover** — the scripted events as fired, replica failover counters,
  and the zero-lost-studies accounting from the verification sweep;
- **parity** — rank-sum regret parity of the engine arm against the
  sequential reference on the parity cohort;
- **bit_identity** — trajectory equality of the gated-off engine arm vs
  the sequential reference (the engine perturbs nothing when its planes
  are off);
- **assertions** — every check with its verdict; ``ok`` is their AND.

Standard library only, with scipy used when present for the rank-sum and
the same normal-approximation fallback otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from vizier_tpu_torch.loadgen import driver as driver_lib
from vizier_tpu_torch.loadgen import models

REPORT_VERSION = 2  # v2: admission section + per-tenant latency/sheds


def ranksum_p(a, b) -> float:
    """Two-sided rank-sum p-value (scipy when present, else normal
    approximation)."""
    if not a or not b:
        return 1.0
    try:
        from scipy import stats as sps

        return float(sps.ranksums(a, b).pvalue)
    except Exception:
        n, m = len(a), len(b)
        ranked = sorted((v, 0) for v in a) + sorted((v, 1) for v in b)
        ranked.sort()
        ra = sum(i + 1 for i, (v, g) in enumerate(ranked) if g == 0)
        mu = n * (n + m + 1) / 2.0
        sigma = math.sqrt(n * m * (n + m + 1) / 12.0) or 1.0
        z = (ra - mu) / sigma
        return 2.0 * (1.0 - 0.5 * (1.0 + math.erf(abs(z) / math.sqrt(2)))) or 1.0


def _percentile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return sorted_values[0]
    rank = (q / 100.0) * (len(sorted_values) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = rank - lo
    return sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac


def _latency_ms(values: List[float]) -> Dict[str, float]:
    values = sorted(values)
    return {
        "p50_ms": round(_percentile(values, 50) * 1e3, 3),
        "p95_ms": round(_percentile(values, 95) * 1e3, 3),
        "p99_ms": round(_percentile(values, 99) * 1e3, 3),
        "max_ms": round((values[-1] if values else 0.0) * 1e3, 3),
        "samples": len(values),
    }


def _outcome_tables(result: driver_lib.SoakResult) -> Dict[str, dict]:
    """The per-kind (and per-tenant) rollup of the request records."""
    by_kind: Dict[str, dict] = {}
    by_tenant: Dict[str, dict] = {}
    latencies: Dict[str, List[float]] = {}
    tenant_latencies: Dict[str, List[float]] = {}
    for record in result.records:
        if record.op != "suggest":
            continue
        for table, key in ((by_kind, record.kind), (by_tenant, record.tenant)):
            row = table.setdefault(
                key,
                {
                    "suggests": 0,
                    "errors": 0,
                    "fallbacks": 0,
                    "speculative_hits": 0,
                    "degraded": 0,
                    "shed_errors": 0,
                },
            )
            row["suggests"] += 1
            if record.error is not None:
                row["errors"] += 1
            if record.fallback:
                row["fallbacks"] += 1
            if record.speculative_hit:
                row["speculative_hits"] += 1
            if record.degraded:
                row["degraded"] += 1
            if record.shed:
                row["shed_errors"] += 1
        if record.error is None:
            latencies.setdefault(record.kind, []).append(record.latency_s)
            tenant_latencies.setdefault(record.tenant, []).append(
                record.latency_s
            )
    for kind, row in by_kind.items():
        row["studies"] = sum(
            1 for o in result.outcomes.values() if o.spec.kind == kind
        )
        served = max(1, row["suggests"] - row["errors"])
        row["fallback_rate"] = round(row["fallbacks"] / served, 4)
        row["hit_rate"] = round(row["speculative_hits"] / served, 4)
        row["latency"] = _latency_ms(latencies.get(kind, []))
    # Per-tenant sheds seen by the controller (retried-and-absorbed sheds
    # included, unlike the client-visible shed_errors) + latency — the
    # fairness view: one hot tenant's collapse must be visible as ITS
    # numbers, not smeared across the fleet aggregate.
    controller_sheds = (result.admission or {}).get("sheds_by_tenant", {})
    for tenant, row in by_tenant.items():
        row["studies"] = sum(
            1 for o in result.outcomes.values() if o.spec.tenant == tenant
        )
        row["sheds"] = sum(controller_sheds.get(tenant, {}).values())
        row["latency"] = _latency_ms(tenant_latencies.get(tenant, []))
    return {
        "by_kind": dict(sorted(by_kind.items())),
        "by_tenant": dict(sorted(by_tenant.items())),
    }


def _parity_section(
    scenario: models.Scenario,
    engine: driver_lib.SoakResult,
    reference: driver_lib.SoakResult,
) -> dict:
    """Rank-sum regret parity on the cohort's final best objectives."""
    cohort = sorted(reference.outcomes)
    engine_best, reference_best, skipped = [], [], []
    for index in cohort:
        e = engine.outcomes.get(index)
        r = reference.outcomes[index]
        if e is None or e.final_best is None or r.final_best is None:
            skipped.append(index)
            continue
        engine_best.append(round(e.final_best, 9))
        reference_best.append(round(r.final_best, 9))
    p = ranksum_p(engine_best, reference_best)
    return {
        "cohort": cohort,
        "skipped": skipped,
        "engine_final_best": engine_best,
        "reference_final_best": reference_best,
        "ranksum_p": round(p, 4),
        "alpha": scenario.config.parity_alpha,
    }


def _bit_identity_section(
    gated: driver_lib.SoakResult, reference: driver_lib.SoakResult
) -> dict:
    """Per-study trajectory equality, gated-off engine vs reference."""
    mismatched, compared = [], 0
    for index, ref in sorted(reference.outcomes.items()):
        g = gated.outcomes.get(index)
        if g is None:
            mismatched.append({"study": index, "reason": "missing in gated arm"})
            continue
        if not ref.trajectory:
            mismatched.append(
                {"study": index, "reason": "empty reference trajectory"}
            )
            continue
        compared += 1
        if g.trajectory != ref.trajectory:
            mismatched.append({"study": index, "reason": "trajectory differs"})
    return {
        "studies_compared": compared,
        "identical": not mismatched and compared > 0,
        "mismatched": mismatched,
    }


def _traffic_section(
    scenario: models.Scenario, engine: driver_lib.SoakResult
) -> dict:
    driven = sum(o.completed for o in engine.outcomes.values())
    return {
        **scenario.summary(),
        "driven_trials": driven,
        "preseeded_trials": sum(
            o.spec.preseed for o in engine.outcomes.values()
        ),
        "wall_s": engine.wall_s,
        "achieved_trials_per_s": round(driven / max(engine.wall_s, 1e-9), 2),
        "open_loop": scenario.config.time_scale > 0,
        "open_loop_capped": engine.open_loop_capped,
    }


def _admission_section(
    config: models.ScenarioConfig, engine: driver_lib.SoakResult
) -> dict:
    """The overload-protection rollup: the controller's own snapshot plus
    the fleet shed rate (controller sheds over controller decisions) the
    --diff regression gate compares."""
    snapshot = dict(engine.admission or {"enabled": False})
    sheds = sum(
        count
        for reasons in snapshot.get("sheds_by_tenant", {}).values()
        for count in reasons.values()
    )
    admits = sum(snapshot.get("admits_by_tenant", {}).values())
    degraded = sum(snapshot.get("degraded_by_tenant", {}).values())
    decisions = sheds + admits + degraded
    return {
        "armed": bool(config.planes.admission),
        "sheds": sheds,
        "degraded_serves": degraded,
        "shed_rate": round(sheds / decisions, 4) if decisions else 0.0,
        "snapshot": snapshot,
    }


def _assert_row(name: str, ok: bool, detail: str) -> dict:
    return {"name": name, "ok": bool(ok), "detail": detail}


def build_report(
    scenario: models.Scenario,
    engine: driver_lib.SoakResult,
    reference: Optional[driver_lib.SoakResult] = None,
    gated: Optional[driver_lib.SoakResult] = None,
    *,
    stamps: Optional[dict] = None,
) -> dict:
    """Assembles the report and evaluates every assertion.

    ``reference``/``gated`` are optional so a quick engine-only run still
    produces a report (the parity/bit-identity assertions then record
    themselves as skipped rather than silently passing).
    """
    config = scenario.config
    outcomes = _outcome_tables(engine)
    by_kind = outcomes["by_kind"]
    assertions: List[dict] = []

    lost = engine.lost_studies()
    errored = engine.errored_studies()
    assertions.append(
        _assert_row(
            "zero_lost_studies",
            not lost and not errored,
            f"lost={lost} errored={errored} of {len(engine.outcomes)} studies",
        )
    )

    expected_kinds = scenario.kinds_present()
    served_kinds = sorted(
        kind
        for kind, row in by_kind.items()
        if row["suggests"] - row["errors"] > 0
    )
    assertions.append(
        _assert_row(
            "all_kinds_served",
            set(expected_kinds) <= set(served_kinds),
            f"expected={expected_kinds} served={served_kinds}",
        )
    )

    fired_ok = [e for e in engine.events_fired if "error" not in e]
    skipped_events = [e for e in engine.events_fired if "skipped" in e]
    assertions.append(
        _assert_row(
            "all_events_fired",
            len(fired_ok) == len(scenario.events) and not skipped_events,
            f"fired={len(fired_ok)}/{len(scenario.events)} "
            f"skipped={len(skipped_events)}",
        )
    )

    kills = [e for e in engine.events_fired if e["kind"] == "kill_replica"]
    if kills:
        failovers = int(engine.serving_stats.get("failovers", 0) or 0)
        assertions.append(
            _assert_row(
                "failover_complete",
                failovers >= 1 and not lost,
                f"failovers={failovers} lost_after_failover={lost}",
            )
        )

    suggests = [r for r in engine.records if r.op == "suggest"]
    served = [r for r in suggests if r.error is None]
    fallbacks = sum(1 for r in served if r.fallback)
    fallback_rate = fallbacks / max(1, len(served))
    assertions.append(
        _assert_row(
            "fallback_rate_bounded",
            fallback_rate <= config.max_fallback_rate,
            f"rate={fallback_rate:.4f} budget={config.max_fallback_rate}",
        )
    )

    speculative_section = {
        "armed": config.planes.speculative,
        "hits": sum(1 for r in served if r.speculative_hit),
        "gp_suggests": sum(
            1 for r in served if r.kind in models.GP_KINDS
        ),
    }
    speculative_section["gp_hit_rate"] = round(
        speculative_section["hits"]
        / max(1, speculative_section["gp_suggests"]),
        4,
    )
    if config.planes.speculative:
        assertions.append(
            _assert_row(
                "speculative_hits",
                speculative_section["hits"] >= config.min_speculative_hits
                and speculative_section["gp_hit_rate"] >= config.min_hit_rate,
                f"hits={speculative_section['hits']} "
                f"(min {config.min_speculative_hits}), gp hit rate "
                f"{speculative_section['gp_hit_rate']} "
                f"(min {config.min_hit_rate})",
            )
        )

    if config.planes.slo:
        if config.target in ("subprocess", "shared_compute"):
            # Each replica process runs its own SLO engine (armed by the
            # inherited env overlay) and dumps it via --obs-dump-dir; the
            # driver has no in-process engine to read, so the roll-up
            # assertion is waived rather than silently passed.
            assertions.append(
                _assert_row(
                    "slo_evaluated",
                    True,
                    "waived: SLO engines run per replica process "
                    "(read them from the fleet observability dumps)",
                )
            )
        else:
            breaching = list(engine.slo.get("breaching", []))
            evaluations = engine.slo.get("evaluations", 0)
            armed = bool(engine.slo) and engine.slo.get("armed", True)
            assertions.append(
                _assert_row(
                    "slo_evaluated",
                    armed
                    and not any(
                        b.startswith("suggest_p99") for b in breaching
                    ),
                    f"armed={armed} evaluations={evaluations} "
                    f"breaching={sorted(breaching)} "
                    f"(p99 budget {config.p99_budget_ms} ms)",
                )
            )

    admission_section = _admission_section(config, engine)
    if config.planes.admission:
        # The plane soaks WITH the traffic: under the scenario's nominal
        # load the controller must not shed past budget (the hot_tenant
        # overload preset raises the budget to 1.0 — shedding there IS
        # the mechanism under test).
        assertions.append(
            _assert_row(
                "shed_rate_bounded",
                admission_section["shed_rate"] <= config.max_shed_rate,
                f"shed_rate={admission_section['shed_rate']} "
                f"budget={config.max_shed_rate} "
                f"(sheds={admission_section['sheds']})",
            )
        )

    # Per-study designer seeding cannot cross a process boundary, so a
    # subprocess tier serves unseeded designers: trajectory-level parity
    # against the in-process reference is structurally meaningless there
    # and is WAIVED (recorded, not silently passed) — the in-process arms
    # carry the parity/bit-identity evidence for the same code paths.
    parity_waived = config.target in ("subprocess", "shared_compute")

    parity = None
    if parity_waived:
        assertions.append(
            _assert_row(
                "regret_parity",
                True,
                "waived: subprocess tier serves unseeded designers "
                "(parity evidence rides the in-process arms)",
            )
        )
    elif reference is not None:
        parity = _parity_section(scenario, engine, reference)
        assertions.append(
            _assert_row(
                "regret_parity",
                parity["ranksum_p"] >= config.parity_alpha
                and not parity["skipped"],
                f"ranksum_p={parity['ranksum_p']} "
                f"(alpha {config.parity_alpha}), cohort "
                f"{len(parity['cohort'])}, skipped {parity['skipped']}",
            )
        )
    else:
        assertions.append(
            _assert_row("regret_parity", False, "reference arm not run")
        )

    bit_identity = None
    if parity_waived:
        assertions.append(
            _assert_row(
                "bit_identical_when_gated",
                True,
                "waived: subprocess tier serves unseeded designers "
                "(bit-identity evidence rides the in-process arms)",
            )
        )
    elif gated is not None and reference is not None:
        bit_identity = _bit_identity_section(gated, reference)
        assertions.append(
            _assert_row(
                "bit_identical_when_gated",
                bit_identity["identical"],
                f"compared={bit_identity['studies_compared']} "
                f"mismatched={bit_identity['mismatched']}",
            )
        )
    else:
        assertions.append(
            _assert_row(
                "bit_identical_when_gated", False, "gated-off arm not run"
            )
        )

    report = {
        "version": REPORT_VERSION,
        "what": (
            "loadgen full-stack soak: production-shaped mixed traffic "
            "(open-loop arrivals, Zipf study sizes, tenant + program-kind "
            "mixes, scripted kill/revive + chaos events) driven through "
            "the real serving fleet, asserted in one report"
        ),
        "scenario": {
            "config": config.as_dict(),
            "fingerprint": engine.scenario_fingerprint,
            "registered_program_kinds": list(models.registered_gp_kinds()),
        },
        "traffic": _traffic_section(scenario, engine),
        "outcomes": outcomes,
        "admission": admission_section,
        "speculative": speculative_section,
        "slo": engine.slo,
        "failover": {
            "events_fired": engine.events_fired,
            "failovers": int(engine.serving_stats.get("failovers", 0) or 0),
            "restored_studies": int(
                engine.serving_stats.get("restored_studies", 0) or 0
            ),
            "recorder_event_kinds": engine.recorder_event_kinds,
            "lost_studies": lost,
            "errored_studies": errored,
            "errors": {
                str(i): engine.outcomes[i].error
                for i in errored
                if engine.outcomes[i].error
            },
        },
        "serving_stats": {
            k: v
            for k, v in sorted(engine.serving_stats.items())
            if isinstance(v, int) and v
        },
        "parity": parity,
        "bit_identity": bit_identity,
        "assertions": assertions,
        "ok": all(a["ok"] for a in assertions),
    }
    if stamps:
        report["stamps"] = stamps
    return report


def diff_reports(
    a: dict,
    b: dict,
    *,
    hit_rate_drop: float = 0.10,
    fallback_rise: float = 0.05,
    shed_rise: float = 0.05,
    latency_ratio: float = 0.0,
) -> dict:
    """Compares two soak reports (A = before, B = after).

    The ROADMAP defaults-ON campaign's before/after gate: per-kind AND
    per-tenant suggest-latency deltas, assertion verdict changes,
    speculative hit-rate, fallback-rate, and admission shed-rate deltas.
    **Regressions** (what flips ``ok`` to False) are: an assertion that
    passed in A and fails in B; a GP hit-rate drop > ``hit_rate_drop``;
    a fallback-rate rise > ``fallback_rise``; an admission shed-rate
    rise > ``shed_rise`` while the plane's armed state is UNCHANGED
    (arming the plane on a saturating scenario legitimately introduces
    sheds — that is not a regression); and, when ``latency_ratio`` > 0,
    any per-kind p99 that grew by more than that factor (off by default
    — wall-clock comparisons across machines are advisory, verdicts are
    the gate). Per-tenant p99 deltas are always reported, and gated by
    the same ``latency_ratio`` knob.
    """

    def _assertions(report: dict) -> Dict[str, bool]:
        return {
            row["name"]: bool(row["ok"])
            for row in report.get("assertions", [])
        }

    regressions: List[str] = []
    a_asserts, b_asserts = _assertions(a), _assertions(b)
    verdict_changes: Dict[str, dict] = {}
    for name in sorted(set(a_asserts) | set(b_asserts)):
        before, after = a_asserts.get(name), b_asserts.get(name)
        if before != after:
            verdict_changes[name] = {"before": before, "after": after}
        if before is True and after is False:
            regressions.append(f"assertion {name}: pass -> FAIL")

    per_kind: Dict[str, dict] = {}
    a_kinds = a.get("outcomes", {}).get("by_kind", {})
    b_kinds = b.get("outcomes", {}).get("by_kind", {})
    for kind in sorted(set(a_kinds) | set(b_kinds)):
        row_a, row_b = a_kinds.get(kind), b_kinds.get(kind)
        entry: Dict[str, object] = {
            "present": {"before": row_a is not None, "after": row_b is not None}
        }
        if row_a and row_b:
            for q in ("p50_ms", "p99_ms"):
                before = row_a.get("latency", {}).get(q)
                after = row_b.get("latency", {}).get(q)
                if before is not None and after is not None:
                    entry[q] = {
                        "before": before,
                        "after": after,
                        "delta": round(after - before, 3),
                        "ratio": round(after / before, 3)
                        if before
                        else None,
                    }
            if (
                latency_ratio > 0
                and isinstance(entry.get("p99_ms"), dict)
                and entry["p99_ms"].get("ratio") is not None
                and entry["p99_ms"]["ratio"] > latency_ratio
            ):
                regressions.append(
                    f"{kind} p99 {entry['p99_ms']['ratio']}x "
                    f"(> {latency_ratio}x budget)"
                )
            entry["fallback_rate"] = {
                "before": row_a.get("fallback_rate", 0.0),
                "after": row_b.get("fallback_rate", 0.0),
            }
            entry["hit_rate"] = {
                "before": row_a.get("hit_rate", 0.0),
                "after": row_b.get("hit_rate", 0.0),
            }
        elif row_a and not row_b:
            regressions.append(f"kind {kind} served in A but absent in B")
        per_kind[kind] = entry

    # Per-tenant p99 deltas + controller-shed deltas (the fair-share
    # regression view: a hot-tenant fix must not quietly cost a light
    # tenant its p99).
    per_tenant: Dict[str, dict] = {}
    a_tenants = a.get("outcomes", {}).get("by_tenant", {})
    b_tenants = b.get("outcomes", {}).get("by_tenant", {})
    for tenant in sorted(set(a_tenants) | set(b_tenants)):
        row_a, row_b = a_tenants.get(tenant), b_tenants.get(tenant)
        entry: Dict[str, object] = {
            "present": {"before": row_a is not None, "after": row_b is not None}
        }
        if row_a and row_b:
            for q in ("p50_ms", "p99_ms"):
                before = (row_a.get("latency") or {}).get(q)
                after = (row_b.get("latency") or {}).get(q)
                if before is not None and after is not None:
                    entry[q] = {
                        "before": before,
                        "after": after,
                        "delta": round(after - before, 3),
                        "ratio": round(after / before, 3) if before else None,
                    }
            entry["sheds"] = {
                "before": row_a.get("sheds", 0),
                "after": row_b.get("sheds", 0),
            }
            if (
                latency_ratio > 0
                and isinstance(entry.get("p99_ms"), dict)
                and entry["p99_ms"].get("ratio") is not None
                and entry["p99_ms"]["ratio"] > latency_ratio
            ):
                regressions.append(
                    f"tenant {tenant} p99 {entry['p99_ms']['ratio']}x "
                    f"(> {latency_ratio}x budget)"
                )
        per_tenant[tenant] = entry

    adm_a = a.get("admission", {}) or {}
    adm_b = b.get("admission", {}) or {}
    shed_section = {
        "armed": {"before": adm_a.get("armed"), "after": adm_b.get("armed")},
        "shed_rate": {
            "before": adm_a.get("shed_rate"),
            "after": adm_b.get("shed_rate"),
        },
    }
    if (
        adm_a.get("armed") == adm_b.get("armed")
        and adm_a.get("shed_rate") is not None
        and adm_b.get("shed_rate") is not None
        and adm_b["shed_rate"] > adm_a["shed_rate"] + shed_rise
    ):
        regressions.append(
            f"admission shed rate {adm_a['shed_rate']} -> "
            f"{adm_b['shed_rate']} (rise > {shed_rise} with the plane "
            "unchanged)"
        )

    spec_a = a.get("speculative", {}) or {}
    spec_b = b.get("speculative", {}) or {}
    speculative = {
        "hits": {"before": spec_a.get("hits"), "after": spec_b.get("hits")},
        "gp_hit_rate": {
            "before": spec_a.get("gp_hit_rate"),
            "after": spec_b.get("gp_hit_rate"),
        },
    }
    if (
        spec_a.get("armed")
        and spec_b.get("armed")
        and spec_a.get("gp_hit_rate") is not None
        and spec_b.get("gp_hit_rate") is not None
        and spec_b["gp_hit_rate"] < spec_a["gp_hit_rate"] - hit_rate_drop
    ):
        regressions.append(
            f"gp hit rate {spec_a['gp_hit_rate']} -> "
            f"{spec_b['gp_hit_rate']} (drop > {hit_rate_drop})"
        )

    def _fallback_rate(report: dict) -> Optional[float]:
        kinds = report.get("outcomes", {}).get("by_kind", {})
        suggests = sum(r.get("suggests", 0) for r in kinds.values())
        fallbacks = sum(r.get("fallbacks", 0) for r in kinds.values())
        return round(fallbacks / suggests, 4) if suggests else None

    fb_a, fb_b = _fallback_rate(a), _fallback_rate(b)
    fallback = {"before": fb_a, "after": fb_b}
    if fb_a is not None and fb_b is not None and fb_b > fb_a + fallback_rise:
        regressions.append(
            f"fallback rate {fb_a} -> {fb_b} (rise > {fallback_rise})"
        )

    return {
        "what": "SOAK_REPORT diff (A = before, B = after)",
        "fingerprints": {
            "before": (a.get("scenario") or {}).get("fingerprint"),
            "after": (b.get("scenario") or {}).get("fingerprint"),
        },
        "same_scenario": (a.get("scenario") or {}).get("fingerprint")
        == (b.get("scenario") or {}).get("fingerprint"),
        "ok_flags": {"before": a.get("ok"), "after": b.get("ok")},
        "assertion_changes": verdict_changes,
        "per_kind": per_kind,
        "per_tenant": per_tenant,
        "admission": shed_section,
        "speculative": speculative,
        "fallback_rate": fallback,
        "regressions": regressions,
        "ok": not regressions,
    }


def render_diff(diff: dict) -> str:
    """Human rendering of :func:`diff_reports` (the --diff stdout)."""
    lines = [
        f"soak diff: {'OK' if diff['ok'] else 'REGRESSED'} "
        f"(same scenario: {diff['same_scenario']})"
    ]
    for name, change in sorted(diff["assertion_changes"].items()):
        lines.append(
            f"  verdict {name}: {change['before']} -> {change['after']}"
        )
    for kind, entry in sorted(diff["per_kind"].items()):
        p99 = entry.get("p99_ms")
        if isinstance(p99, dict):
            lines.append(
                f"  {kind}: p99 {p99['before']} -> {p99['after']} ms "
                f"({p99['ratio']}x)"
            )
    for tenant, entry in sorted(diff.get("per_tenant", {}).items()):
        p99 = entry.get("p99_ms")
        sheds = entry.get("sheds", {})
        if isinstance(p99, dict):
            lines.append(
                f"  tenant {tenant}: p99 {p99['before']} -> {p99['after']} "
                f"ms ({p99['ratio']}x), sheds {sheds.get('before')} -> "
                f"{sheds.get('after')}"
            )
    spec = diff["speculative"]["gp_hit_rate"]
    if spec["before"] is not None or spec["after"] is not None:
        lines.append(
            f"  gp hit rate: {spec['before']} -> {spec['after']}"
        )
    fb = diff["fallback_rate"]
    lines.append(f"  fallback rate: {fb['before']} -> {fb['after']}")
    shed = diff.get("admission", {}).get("shed_rate", {})
    if shed.get("before") is not None or shed.get("after") is not None:
        lines.append(
            f"  admission shed rate: {shed.get('before')} -> "
            f"{shed.get('after')}"
        )
    for regression in diff["regressions"]:
        lines.append(f"  REGRESSION: {regression}")
    return "\n".join(lines)


def render_verdict(report: dict) -> str:
    """The one-screen human verdict (the CLI's stdout tail)."""
    lines = [
        f"soak: {'PASS' if report['ok'] else 'FAIL'} — "
        f"{report['traffic']['studies']} studies / "
        f"{report['traffic']['driven_trials']} trials in "
        f"{report['traffic']['wall_s']}s"
    ]
    for a in report["assertions"]:
        lines.append(
            f"  [{'ok' if a['ok'] else 'FAIL'}] {a['name']}: {a['detail']}"
        )
    return "\n".join(lines)
