"""Suite runner: all passes over the configured paths, baseline applied.

The port's copy of the JAX package's ``analysis/suite.py``. Its
configuration is its own and lives here, not in ``pyproject.toml`` (whose
``[tool.vizier_analysis]`` section configures the JAX package's suite): the
scan roots are the port's package and ``chip_smoke.py``, the baseline is
the package's ``baseline.toml``, and ``graph_discipline`` takes the place of
the JAX package's ``jax_discipline``.

The command line (``python -m vizier_tpu_torch.analysis``) and
``tests/test_torch_analysis.py`` both run through :func:`run_suite`, so they
cannot disagree about what a violation is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

from vizier_tpu_torch.analysis import baseline as baseline_lib
from vizier_tpu_torch.analysis import common
from vizier_tpu_torch.analysis import compute_ir
from vizier_tpu_torch.analysis import env_registry
from vizier_tpu_torch.analysis import graph_discipline
from vizier_tpu_torch.analysis import lock_order

ALL_PASSES = (
    "lock_order",
    "graph_discipline",
    "env_registry",
    "compute_ir",
    "debug_locks",
)

DEFAULT_PATHS = ("vizier_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = "vizier_tpu_torch/analysis/baseline.toml"


@dataclasses.dataclass
class SuiteConfig:
    paths: List[str] = dataclasses.field(default_factory=lambda: list(DEFAULT_PATHS))
    baseline: str = DEFAULT_BASELINE
    passes: List[str] = dataclasses.field(default_factory=lambda: list(ALL_PASSES))
    critical_locks: List[str] = dataclasses.field(
        default_factory=lambda: list(lock_order.DEFAULT_CRITICAL_LOCKS)
    )


def load_config(repo_root: str) -> SuiteConfig:
    """The port's suite configuration (its defaults; ``repo_root`` is where
    the paths are relative to)."""
    del repo_root
    return SuiteConfig()


@dataclasses.dataclass
class PassResult:
    name: str
    findings: List[common.Finding]
    new: List[common.Finding]
    accepted: List[common.Finding]


@dataclasses.dataclass
class SuiteResult:
    passes: Dict[str, PassResult]
    stale_baseline: List[baseline_lib.BaselineEntry]
    lock_result: Optional[lock_order.LockOrderResult] = None
    graph_result: Optional[graph_discipline.GraphDisciplineResult] = None
    env_result: Optional[env_registry.EnvRegistryResult] = None
    compute_ir_result: Optional[compute_ir.ComputeIrResult] = None
    # (confirmed_edge_count, unmapped_site_count) from the runtime check.
    debug_locks_stats: Optional[tuple] = None
    parse_errors: List = dataclasses.field(default_factory=list)

    @property
    def new_findings(self) -> List[common.Finding]:
        out: List[common.Finding] = []
        for result in self.passes.values():
            out.extend(result.new)
        return out

    @property
    def ok(self) -> bool:
        return not self.new_findings and not self.parse_errors


def run_suite(
    repo_root: str,
    config: Optional[SuiteConfig] = None,
    passes: Optional[Sequence[str]] = None,
) -> SuiteResult:
    config = config or load_config(repo_root)
    selected = list(passes or config.passes)
    unknown = set(selected) - set(ALL_PASSES)
    if unknown:
        raise ValueError(
            f"Unknown analysis pass(es) {sorted(unknown)}; "
            f"known: {list(ALL_PASSES)}"
        )
    roots = [os.path.join(repo_root, p) for p in config.paths]
    project = common.Project(roots, rel_to=repo_root)
    bl = baseline_lib.load_baseline(os.path.join(repo_root, config.baseline))

    all_findings: List[common.Finding] = []
    result = SuiteResult(passes={}, stale_baseline=[], parse_errors=list(project.parse_errors))

    if "lock_order" in selected:
        result.lock_result = lock_order.run(
            project, critical_locks=config.critical_locks
        )
        all_findings.extend(result.lock_result.findings)
    if "graph_discipline" in selected:
        result.graph_result = graph_discipline.run(project)
        all_findings.extend(result.graph_result.findings)
    if "env_registry" in selected:
        result.env_result = env_registry.run(project, repo_root)
        all_findings.extend(result.env_result.findings)
    if "compute_ir" in selected:
        result.compute_ir_result = compute_ir.run(project, repo_root)
        all_findings.extend(result.compute_ir_result.findings)
    if "debug_locks" in selected:
        lock_result = result.lock_result or lock_order.run(
            project, critical_locks=config.critical_locks
        )
        dl_findings, result.debug_locks_stats = _run_debug_locks(
            lock_result, repo_root
        )
        all_findings.extend(dl_findings)

    new, accepted, stale = bl.apply(all_findings)
    # A partial run (--pass X) cannot judge other passes' baseline entries.
    result.stale_baseline = [e for e in stale if e.pass_name in selected]
    new_keys = {(f.pass_name, f.key) for f in new}
    for name in selected:
        pass_findings = [f for f in all_findings if f.pass_name == name]
        result.passes[name] = PassResult(
            name=name,
            findings=pass_findings,
            new=[f for f in pass_findings if (f.pass_name, f.key) in new_keys],
            accepted=[
                f for f in pass_findings if (f.pass_name, f.key) not in new_keys
            ],
        )
    return result


def _run_debug_locks(lock_result, repo_root: str):
    """Pass 4: record RUNTIME acquisition order and diff it against the
    static graph.

    Drives the real serving designer-cache + coalescer through a seeded
    threaded workload (happy path AND the invalidate-under-entry-lock
    error path) with every lock instrumented; any observed edge the static
    graph does not predict is a finding — a resolution gap in the static
    pass, not an acceptable exception. The richer chaos-harness variant
    runs in chip_smoke.py on the card (a serving flush with coalescing and
    speculation).
    """
    import random
    import threading

    from vizier_tpu_torch.analysis import common as common_lib
    from vizier_tpu_torch.analysis import debug_locks as debug_locks_lib

    # Imported before the locks are patched: importing torch under
    # instrument() breaks its own imports. Only the locks the block builds
    # are observed, and the cache and coalescer build theirs there.
    from vizier_tpu_torch.observability import tracing as tracing_lib
    from vizier_tpu_torch.serving.coalescer import RequestCoalescer
    from vizier_tpu_torch.serving.designer_cache import DesignerStateCache

    with debug_locks_lib.instrument() as obs:
        # The serving policy runs its designer, which opens spans, under the
        # study's entry lock: a tracer of the block's own, so its lock is
        # observed too.
        previous_tracer = tracing_lib.set_tracer(tracing_lib.Tracer())
        cache = DesignerStateCache(max_entries=3, observe_latency=False)
        coalescer = RequestCoalescer(observe_latency=False)

        def worker(tid: int):
            rng = random.Random(1000 + tid)
            for step in range(8):
                name = f"s{(tid + step) % 4}"
                entry = cache.get_or_create(name, lambda: object())
                with entry.lock:
                    with tracing_lib.get_tracer().span("suggest", study=name):
                        pass
                    if rng.random() < 0.4:  # the policy's error path
                        cache.invalidate(name)
                coalescer.coalesce((name, step), lambda: step)

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        tracing_lib.set_tracer(previous_tracer)

    check = debug_locks_lib.check_against_static(obs, lock_result, repo_root)
    findings = []
    seen = set()
    for src, dst, edge in check.missing_static:
        key = f"runtime-edge-not-in-static-graph:{src}->{dst}"
        if key in seen:
            continue
        seen.add(key)
        findings.append(
            common_lib.Finding(
                pass_name="debug_locks",
                rule="runtime-order-not-in-static-graph",
                key=key,
                message=(
                    f"runtime acquisition order {src} -> {dst} (thread "
                    f"{edge.thread}) is absent from the static lock graph — "
                    "fix the lock_order pass's resolution, don't baseline"
                ),
                path="vizier_tpu_torch/analysis/lock_order.py",
                line=0,
            )
        )
    return findings, (len(check.confirmed), len(check.unmapped_sites))


def format_report(result: SuiteResult, verbose: bool = False) -> str:
    lines: List[str] = []
    for path, err in result.parse_errors:
        lines.append(f"PARSE ERROR {path}: {err}")
    for name, pass_result in result.passes.items():
        status = "FAIL" if pass_result.new else "ok"
        extra = ""
        if name == "lock_order" and result.lock_result is not None:
            extra = (
                f" ({len(result.lock_result.sites)} lock sites, "
                f"{len(result.lock_result.edges)} edges)"
            )
        elif name == "graph_discipline" and result.graph_result is not None:
            extra = (
                f" ({len(result.graph_result.roots)} capture roots, "
                f"{len(result.graph_result.captured)} captured fns)"
            )
        elif name == "env_registry" and result.env_result is not None:
            extra = f" ({len(result.env_result.references)} VIZIER_* names seen)"
        elif name == "compute_ir" and result.compute_ir_result is not None:
            kinds = sorted(
                r.kind or "?" for r in result.compute_ir_result.registered
            )
            extra = f" ({len(kinds)} registered programs: {', '.join(kinds)})"
        elif name == "debug_locks" and result.debug_locks_stats is not None:
            confirmed, unmapped = result.debug_locks_stats
            extra = (
                f" ({confirmed} runtime edges confirmed static, "
                f"{unmapped} unmapped sites)"
            )
        lines.append(
            f"[{name}] {status}: {len(pass_result.new)} new, "
            f"{len(pass_result.accepted)} baselined{extra}"
        )
        for f in pass_result.new:
            lines.append(f"  NEW {f.format()}")
            lines.append(f"      baseline key: {f.key}")
        if verbose:
            for f in pass_result.accepted:
                lines.append(f"  baselined {f.format()}")
    for entry in result.stale_baseline:
        lines.append(
            f"STALE baseline entry [{entry.pass_name}] {entry.key} "
            "(no longer matches anything — remove it)"
        )
    lines.append("ANALYSIS " + ("OK" if result.ok else "FAILED"))
    return "\n".join(lines)
