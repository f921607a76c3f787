"""The disaggregated compute tier as a standalone gRPC server process.

A copy of the JAX package's ``distributed/pythia_server_main.py``.
``python -m vizier_tpu_torch.distributed.pythia_server_main --server-id
compute-0 --port 28190 --frontends replica-0=host:port,... [--device
cuda|cpu]`` starts ONE shared
:class:`~vizier_tpu_torch.service.pythia_service.PythiaServicer` behind a
gRPC server — one designer cache, one batch executor whose shape buckets
fuse concurrent suggests from EVERY frontend into single batched flushes
on the card, one speculative engine. N ``replica_main`` frontends running with
``--compute-endpoint`` dispatch their Pythia work here over the existing
``PythiaService`` surface (``distributed.compute_tier.RemotePythiaStub``).

The servicer reads trials back through a
:class:`~vizier_tpu_torch.distributed.router_stub.RoutedVizierStub` over the
``--frontends`` endpoints — the same rendezvous placement the fleet's
clients use, so each study's read-back lands on the frontend that owns
it. Connections are lazy: the tier may start before, after, or between
frontend (re)starts.

``--device`` is where the shared Pythia's designers run: ``cuda`` by
default, and the process raises at start when no GPU is present rather
than fall back to the CPU quietly; ``--device cpu`` runs the plain PyTorch
path (``SubprocessReplicaManager(device="cpu")`` passes it).

The ``ReplicationService`` surface is served solely for its ``Heartbeat``
method: the fleet manager health-checks the compute server with the same
lease probes it sends replicas, and a missed lease triggers a respawn
(frontends ride their local-Pythia fallback during the gap — no studies
live here, so there is nothing to restore).

Prints ``READY <endpoint>`` on stdout once serving; SIGTERM drains
in-flight RPCs through the grace window, shuts the serving runtime down,
and writes the ``--obs-dump-dir`` observability dump so the fleet merge
(``observability.fleet``) can stitch frontend→compute-tier traces and read
this process's batch-occupancy histograms.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from concurrent import futures


def _parse_frontends(spec: str):
    """``rid=host:port,...`` -> ordered dict of frontend endpoints."""
    frontends = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        rid, _, endpoint = entry.partition("=")
        if not rid or not endpoint:
            raise SystemExit(f"Bad --frontends entry: {entry!r}")
        frontends[rid] = endpoint
    return frontends


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--server-id", default="compute-0")
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=0, help="0 = pick a free port")
    parser.add_argument(
        "--frontends",
        default="",
        help="frontend replicas as 'rid=host:port,...'; the shared "
        "servicer reads trials back through a routed stub over these "
        "(required for GP algorithms; '' only serves stateless policies)",
    )
    parser.add_argument(
        "--max-workers",
        type=int,
        default=30,
        help="gRPC handler threads; keep >= the frontend count so "
        "concurrent same-bucket suggests can actually meet in one "
        "batch-executor flush window",
    )
    parser.add_argument(
        "--shutdown-grace",
        type=float,
        default=5.0,
        help="seconds SIGTERM waits for in-flight RPCs to drain",
    )
    parser.add_argument(
        "--obs-dump-dir",
        default=None,
        help="write <server-id>-{spans.jsonl,metrics.json,recorder.json} "
        "here on shutdown for fleet merging (observability.fleet); "
        "default: $VIZIER_TORCH_OBS_DUMP_DIR ('' = no dump)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the shared Pythia's designers run: 'cuda' (raises "
        "without a GPU) or 'cpu'",
    )
    args = parser.parse_args(argv)

    import grpc

    from vizier_tpu_torch.utils import env as env_registry
    from vizier_tpu_torch.distributed import config as config_lib
    from vizier_tpu_torch.distributed import replication as replication_lib
    from vizier_tpu_torch.distributed import replication_service as repl_service
    from vizier_tpu_torch.distributed import router_stub, routing
    from vizier_tpu_torch.service import grpc_stubs, pythia_service
    from vizier_tpu_torch.service.vizier_server import _pick_port

    obs_dump_dir = args.obs_dump_dir
    if obs_dump_dir is None:
        obs_dump_dir = env_registry.env_str("VIZIER_TORCH_OBS_DUMP_DIR")

    frontends = _parse_frontends(args.frontends)

    vizier_backend = None
    if frontends:
        dist_config = config_lib.DistributedConfig.from_env()
        # Lazy endpoint factories: a frontend that is not up yet (or is
        # mid-revive) costs nothing until a study routed to it is read.
        endpoints = {
            rid: (lambda ep=endpoint: grpc_stubs.create_vizier_stub(ep))
            for rid, endpoint in frontends.items()
        }
        vizier_backend = router_stub.RoutedVizierStub(
            endpoints,
            router=routing.StudyRouter(
                list(frontends), routing=dist_config.routing
            ),
        )

    pythia = pythia_service.PythiaServicer(vizier_backend, device=args.device)

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=args.max_workers))
    grpc_stubs.add_pythia_servicer_to_server(pythia, server)
    # Heartbeat-only replication surface: the fleet manager's lease plane
    # probes the compute server exactly like any replica.
    replication_servicer = repl_service.ReplicationServicer(
        args.server_id, replication_lib.StandbyStore()
    )
    grpc_stubs.add_replication_servicer_to_server(replication_servicer, server)

    endpoint = f"{args.host}:{args.port or _pick_port()}"
    server.add_insecure_port(endpoint)
    server.start()

    # The handlers go in before READY: a caller may signal as soon as it
    # reads the line. They only append to a list: a handler runs on the main
    # thread between bytecodes, and one that set a threading.Event could
    # deadlock on the Event's lock if it landed inside the main thread's own
    # Event.wait.
    stopping = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, _frame: stopping.append(signum))
    print(f"READY {endpoint}", flush=True)
    while not stopping:
        time.sleep(0.1)

    # Drain in-flight suggests through the grace window, then stop the
    # serving runtime's background planes (speculative workers, batch
    # executor threads), then dump observability — the dump reflects every
    # flush the process actually served.
    server.stop(args.shutdown_grace).wait()
    runtime = pythia.serving_runtime
    if runtime is not None:
        runtime.shutdown()
    grpc_stubs.close_channel(endpoint)
    for frontend_endpoint in frontends.values():
        grpc_stubs.close_channel(frontend_endpoint)
    if obs_dump_dir:
        from vizier_tpu_torch.observability import fleet as fleet_lib
        from vizier_tpu_torch.observability import flight_recorder as recorder_lib
        from vizier_tpu_torch.observability import tracing as tracing_lib

        registry = runtime.metrics if runtime is not None else None
        written = fleet_lib.dump_process(
            obs_dump_dir,
            args.server_id,
            tracer=tracing_lib.get_tracer(),
            registry=registry,
            recorder=recorder_lib.get_recorder(),
        )
        print(
            f"[{args.server_id}] observability dump: "
            f"{', '.join(sorted(written.values()))}",
            file=sys.stderr,
            flush=True,
        )


if __name__ == "__main__":
    main()
