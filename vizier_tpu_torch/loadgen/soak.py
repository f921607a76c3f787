"""Full-stack continuous soak: production-shaped traffic → one soak report.

The port's counterpart of the JAX package's soak tool. It drives the
loadgen engine (``vizier_tpu_torch/loadgen/``) end to end, in three arms:

1. **engine arm** — the scenario's full traffic (open-loop arrivals, Zipf
   study sizes, tenant + program-kind mixes across every registered
   DesignerProgram, scripted kill/revive + chaos windows) against the
   configured target (N-replica sharded tier by default) with the
   scenario's serving planes armed;
2. **reference arm** — the parity cohort re-run sequentially, in-process,
   every plane gated off: the seed-path ground truth;
3. **gated-off arm** — the engine itself with every plane off on the same
   cohort, asserted bit-identical to the reference.

The assertion engine rolls all three into one report (regret parity
rank-sum, zero lost studies, failover completeness, speculative hit rate,
fallback rate, SLO p99 verdicts, shed rate, bit-identity), written to
``--out`` (``TORCH_SOAK_REPORT.json`` by default); the command exits
nonzero when any assertion fails.

Usage::

    python -m vizier_tpu_torch.loadgen.soak                 # acceptance-scale soak
    python -m vizier_tpu_torch.loadgen.soak --smoke --device cpu
    python -m vizier_tpu_torch.loadgen.soak --diff A.json B.json

The designers run on ``--device`` (CUDA unless asked for the CPU; without
a GPU the CUDA default raises). The service transport needs protobuf and
gRPC; ``--transport runtime`` serves the studies through one
``ServingRuntime`` without them (no replicas: the replica events are
recorded as skipped and their assertions fail). ``--diff`` compares two
reports (per-kind latency deltas, assertion verdict changes, hit-rate /
fallback-rate / shed-rate deltas) and exits nonzero on any regression.

Scenario seed/scale/studies/target/events can also come from the
``VIZIER_TORCH_LOADGEN_*`` switches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time
import unittest.mock

from vizier_tpu_torch.loadgen import driver as driver_lib
from vizier_tpu_torch.loadgen import models
from vizier_tpu_torch.loadgen import report as report_lib
from vizier_tpu_torch.utils import env as env_lib

DEFAULT_OUT = "TORCH_SOAK_REPORT.json"


def _stamps(device, transport: str, mesh: dict) -> dict:
    """Provenance stamps: the torch build, the device and the programs."""
    import torch

    from vizier_tpu_torch.compute import registry as compute_registry

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
        "device_name": name,
        "transport": transport,
        "mesh": mesh,
        "compute_programs": list(compute_registry.kinds()),
    }


def _env_overrides() -> dict:
    """VIZIER_TORCH_LOADGEN_* env values as preset overrides (CLI flags win)."""
    out = {
        "seed": env_lib.env_int("VIZIER_TORCH_LOADGEN_SEED", 0),
        "scale": env_lib.env_float("VIZIER_TORCH_LOADGEN_SCALE", 1.0),
    }
    studies = env_lib.env_int("VIZIER_TORCH_LOADGEN_STUDIES", 0)
    if studies:
        out["num_studies"] = studies
    target = env_lib.env_str("VIZIER_TORCH_LOADGEN_TARGET")
    if target:
        out["target"] = target
    return out


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="the seconds-scale CI scenario instead of the acceptance soak",
    )
    parser.add_argument("--studies", type=int, default=0,
                        help="override the scenario study count")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--scale", type=float, default=None)
    parser.add_argument("--target",
                        choices=("inprocess", "replicas", "subprocess", "shared_compute"),
                        default=None)
    parser.add_argument(
        "--compute-tier",
        action="store_true",
        help="run the subprocess fleet behind ONE shared Pythia compute server "
        "(shorthand for --target shared_compute)",
    )
    parser.add_argument(
        "--replica-mode",
        choices=("inprocess", "subprocess"),
        default="inprocess",
        help="'subprocess' runs the replica tier as real replica_main processes "
        "(parity/bit-identity assertions are then waived)",
    )
    parser.add_argument("--replicas", type=int, default=0)
    parser.add_argument("--concurrency", type=int, default=0)
    parser.add_argument(
        "--events",
        default=None,
        help="event track: comma-separated kind[:arg]@fraction entries "
        "(default: the scenario's built-in track)",
    )
    parser.add_argument(
        "--mesh-devices",
        type=int,
        default=0,
        metavar="N",
        help="arm the mesh plane over at most N of the run's devices "
        "(VIZIER_TORCH_MESH_DEVICES; one card or the CPU is one placement)",
    )
    parser.add_argument("--think-time", type=float, default=None,
                        help="per-GP-trial evaluation window in seconds")
    parser.add_argument(
        "--skip-reference",
        action="store_true",
        help="engine arm only (parity/bit-identity assertions then FAIL)",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the designers run (default cuda)")
    parser.add_argument("--transport", choices=driver_lib.TRANSPORTS, default="service",
                        help="'runtime' drives one ServingRuntime without protobuf")
    parser.add_argument(
        "--diff",
        nargs=2,
        metavar=("A.json", "B.json"),
        default=None,
        help="compare two soak reports (A = before, B = after) instead of running "
        "a soak; exits nonzero on regression",
    )
    parser.add_argument("--diff-out", default="",
                        help="optional path for the --diff JSON result")
    parser.add_argument("--out", default=DEFAULT_OUT, help="the report file")
    return parser


def _config(args) -> models.ScenarioConfig:
    overrides = {}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.scale is not None:
        overrides["scale"] = args.scale
    if args.studies:
        overrides["num_studies"] = args.studies
    if args.target:
        overrides["target"] = args.target
    if args.replica_mode == "subprocess" and overrides.get("target", "replicas") != "inprocess":
        overrides["target"] = "subprocess"
    if args.compute_tier:
        overrides["target"] = "shared_compute"
    if args.replicas:
        overrides["replicas"] = args.replicas
    if args.concurrency:
        overrides["concurrency"] = args.concurrency
    if args.think_time is not None:
        overrides["think_time_s"] = args.think_time
    base = models.smoke_config if args.smoke else models.soak_config
    config = base(**{**_env_overrides(), **overrides})
    if args.mesh_devices:
        config = dataclasses.replace(
            config, planes=dataclasses.replace(config.planes, mesh=True)
        )
    env_track = env_lib.env_str("VIZIER_TORCH_LOADGEN_EVENTS")
    track = args.events if args.events is not None else env_track
    if track:
        config = dataclasses.replace(config, events=models.parse_event_track(track, config))
    return config


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.diff:
        before = json.loads(pathlib.Path(args.diff[0]).read_text())
        after = json.loads(pathlib.Path(args.diff[1]).read_text())
        diff = report_lib.diff_reports(before, after)
        print(report_lib.render_diff(diff))
        if args.diff_out:
            pathlib.Path(args.diff_out).write_text(json.dumps(diff, indent=2) + "\n")
            print(f"[soak] wrote {args.diff_out}")
        return 0 if diff["ok"] else 1

    if args.mesh_devices:
        # The runtime's MeshConfig.from_env() reads the cap during the run.
        with unittest.mock.patch.dict(
            os.environ, {"VIZIER_TORCH_MESH_DEVICES": str(args.mesh_devices)}
        ):
            return _soak(args)
    return _soak(args)


def _soak(args) -> int:
    from vizier_tpu_torch import device as device_lib

    device = device_lib.resolve(args.device)
    if args.transport == "service":
        # Fast client polling: the soak measures fleet behavior, not the
        # client's long-poll sleep cadence.
        from vizier_tpu_torch.service import vizier_client

        vizier_client.environment_variables.polling_delay_secs = 0.005

    config = _config(args)
    if config.target in ("subprocess", "shared_compute") and not args.skip_reference:
        # Parity/bit-identity are waived for subprocess tiers (see
        # --replica-mode); the sequential arms would only burn the wall
        # clock the real-process severity track needs.
        args.skip_reference = True
        print(f"[soak] {config.target} tier: reference/gated arms skipped "
              "(parity assertions waived)", flush=True)
    scenario = models.build_scenario(config)
    print(
        f"[soak] scenario {config.name!r}: {len(scenario.studies)} studies / "
        f"{scenario.total_trials} trials, kinds {scenario.kinds_present()}, "
        f"target {config.target} x{config.replicas}, transport {args.transport}, "
        f"device {device}, planes {config.planes.as_dict()}, fingerprint "
        f"{scenario.fingerprint()}",
        flush=True,
    )
    kwargs = dict(device=device, transport=args.transport)
    t0 = time.time()
    engine = driver_lib.run(scenario, arm="engine", **kwargs)
    print(
        f"[soak] engine arm done in {engine.wall_s}s "
        f"(events fired: {[e['kind'] for e in engine.events_fired]})",
        flush=True,
    )
    reference = gated = None
    if not args.skip_reference:
        reference = driver_lib.run_reference(scenario, **kwargs)
        print(f"[soak] reference arm done in {reference.wall_s}s", flush=True)
        gated = driver_lib.run_gated_off(scenario, **kwargs)
        print(f"[soak] gated-off arm done in {gated.wall_s}s", flush=True)

    report = report_lib.build_report(
        scenario, engine, reference, gated,
        stamps=_stamps(device, args.transport, engine.mesh),
    )
    report["wall_seconds_total"] = round(time.time() - t0, 1)
    out_path = pathlib.Path(args.out)
    out_path.write_text(json.dumps(report, indent=2) + "\n")
    print(report_lib.render_verdict(report))
    print(f"[soak] wrote {out_path}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
