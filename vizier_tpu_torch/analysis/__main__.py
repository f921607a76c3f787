"""Command line of the port's analysis suite.

Usage (from the repository root)::

    python -m vizier_tpu_torch.analysis                  # every pass
    python -m vizier_tpu_torch.analysis --pass lock_order --verbose
    python -m vizier_tpu_torch.analysis --paths vizier_tpu_torch/serving --json
    python -m vizier_tpu_torch.analysis --dump-graph     # the lock graph

Exit code 0 iff every finding is in the baseline (``--strict-baseline``
also fails on stale baseline entries). The port's counterpart of the JAX
package's ``tools/check_analysis.py``; stdlib only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from vizier_tpu_torch.analysis import suite as suite_lib

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pass", dest="passes", action="append",
                        choices=list(suite_lib.ALL_PASSES),
                        help="Run only this pass (repeatable; default: every pass).")
    parser.add_argument("--paths", nargs="+",
                        help="Override the scan roots (repo-relative).")
    parser.add_argument("--baseline", help="Override the baseline file path.")
    parser.add_argument("--repo-root", default=_REPO_ROOT,
                        help="Repository root to scan from.")
    parser.add_argument("--json", action="store_true", help="Machine-readable findings dump.")
    parser.add_argument("--verbose", action="store_true", help="Also list baselined findings.")
    parser.add_argument("--strict-baseline", action="store_true",
                        help="Fail on stale baseline entries too.")
    parser.add_argument("--dump-graph", action="store_true",
                        help="Print the static lock acquisition graph.")
    args = parser.parse_args(argv)

    config = suite_lib.load_config(args.repo_root)
    if args.paths:
        config.paths = list(args.paths)
    if args.baseline:
        config.baseline = args.baseline

    t0 = time.perf_counter()
    result = suite_lib.run_suite(args.repo_root, config, passes=args.passes)
    elapsed = time.perf_counter() - t0

    failed = bool(result.new_findings) or bool(result.parse_errors)
    if args.strict_baseline and result.stale_baseline:
        failed = True

    if args.json:
        payload = {
            "ok": not failed,
            "elapsed_seconds": round(elapsed, 3),
            "passes": {
                name: {
                    "new": [dataclasses.asdict(f) for f in p.new],
                    "baselined": [dataclasses.asdict(f) for f in p.accepted],
                }
                for name, p in result.passes.items()
            },
            "stale_baseline": [dataclasses.asdict(e) for e in result.stale_baseline],
            "parse_errors": result.parse_errors,
        }
        if result.lock_result is not None:
            payload["lock_graph"] = {
                "sites": [dataclasses.asdict(s) for s in result.lock_result.sites],
                "edges": [dataclasses.asdict(e) for e in result.lock_result.edges],
            }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(suite_lib.format_report(result, verbose=args.verbose))
        if args.dump_graph and result.lock_result is not None:
            print("\nlock sites:")
            for site in result.lock_result.sites:
                mark = " (factory)" if site.factory else ""
                print(f"  {site.lock_id:45s} {site.kind:9s} {site.path}:{site.line}{mark}")
            print("lock acquisition edges (src held -> dst acquired):")
            for edge in result.lock_result.edges:
                print(f"  {edge.src} -> {edge.dst}   via {edge.via}")
        print(f"({elapsed:.2f}s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
