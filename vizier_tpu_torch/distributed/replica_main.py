"""One sharded-tier replica as a standalone gRPC server process.

A copy of the JAX package's ``distributed/replica_main.py``.
``python -m vizier_tpu_torch.distributed.replica_main --replica-id replica-0
--port 28090 [--wal-dir /data/vizier/replica-0] [--device cuda|cpu]``
starts a ``DefaultVizierServer`` (Vizier + its own Pythia) whose datastore
is a snapshot+WAL ``PersistentDataStore`` when ``--wal-dir`` is given — the
process restarts warm from its directory. It prints ``READY <endpoint>``
on stdout once serving, which is what the lease-based
``distributed.subprocess_fleet.SubprocessReplicaManager`` waits for.
``--device`` is where the replica's own Pythia runs its designers:
``cuda`` by default, raising at start when no GPU is present; ``--device
cpu`` runs the plain PyTorch path.

With ``--peers replica-1=host:port,...`` (and a WAL dir) the replica
joins the **cross-process replication plane**: it hosts the
``ReplicationService`` gRPC surface next to ``VizierService`` — persisting
epoch-fenced standby logs for its rendezvous predecessors on its own disk
— and streams its own WAL appends to each study's rendezvous successors
over gRPC (``distributed.replication_service``). ``--replication-epoch``
is the generation a revive restarts the process at (the fleet manager
fences the old generation out first).

Graceful shutdown: SIGTERM/SIGINT drains in-flight RPCs through the gRPC
grace window, flushes the replication streamer, compacts + closes the WAL
and standby stores, and THEN writes the ``--obs-dump-dir`` observability
dump — so a terminated replica's dump reflects its final durable state.

Clients reach the fleet through a client-side
:class:`~vizier_tpu_torch.distributed.router_stub.RoutedVizierStub` over the
replica endpoints (see ``vizier_client.environment_variables
.server_endpoints``); there is no central frontend to scale or fail.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def _parse_peers(spec: str):
    """``rid=host:port,rid=host:port`` -> ordered dict of peer endpoints."""
    peers = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        rid, _, endpoint = entry.partition("=")
        if not rid or not endpoint:
            raise SystemExit(f"Bad --peers entry: {entry!r}")
        peers[rid] = endpoint
    return peers


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--replica-id", default="replica-0")
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=0, help="0 = pick a free port")
    parser.add_argument("--wal-dir", default="", help="'' = RAM only")
    parser.add_argument(
        "--snapshot-interval", type=int, default=0, help="0 = config default"
    )
    parser.add_argument(
        "--peers",
        default="",
        help="peer replicas as 'rid=host:port,...' (this id excluded or "
        "included, either way); with --wal-dir this arms cross-process "
        "WAL replication over the ReplicationService surface",
    )
    parser.add_argument(
        "--replication-factor", type=int, default=0, help="0 = config default"
    )
    parser.add_argument(
        "--replication-epoch",
        type=int,
        default=1,
        help="this generation's streamer epoch (a revive passes the "
        "fenced epoch so the fresh baseline announces it)",
    )
    parser.add_argument(
        "--compute-endpoint",
        default="",
        help="host:port of a shared Pythia compute server "
        "(distributed.pythia_server_main); arms the disaggregated "
        "compute tier for this frontend — Pythia dispatch goes remote "
        "with graceful local fallback. '' = $VIZIER_TORCH_COMPUTE_TIER* "
        "switches decide (default: self-contained local Pythia)",
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
        help="write <replica-id>-{spans.jsonl,metrics.json,recorder.json} "
        "here on shutdown for fleet merging (observability.fleet); "
        "default: $VIZIER_TORCH_OBS_DUMP_DIR ('' = no dump)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the replica's own Pythia runs its designers: 'cuda' "
        "(raises without a GPU) or 'cpu'",
    )
    args = parser.parse_args(argv)

    from vizier_tpu_torch import device as device_lib

    # Refuse a CUDA replica on a host without a GPU before touching the
    # WAL directory (no quiet fallback to the CPU).
    device_lib.resolve(args.device)

    from vizier_tpu_torch.utils import env as env_registry
    from vizier_tpu_torch.distributed import config as config_lib
    from vizier_tpu_torch.distributed import replication as replication_lib
    from vizier_tpu_torch.distributed import replication_service as repl_service
    from vizier_tpu_torch.distributed import wal as wal_lib
    from vizier_tpu_torch.service import grpc_stubs, vizier_server
    from vizier_tpu_torch.testing import netchaos as netchaos_lib

    obs_dump_dir = args.obs_dump_dir
    if obs_dump_dir is None:
        obs_dump_dir = env_registry.env_str("VIZIER_TORCH_OBS_DUMP_DIR")

    dist_config = config_lib.DistributedConfig.from_env()
    peers = _parse_peers(args.peers)
    peers.pop(args.replica_id, None)
    replicate = bool(peers) and bool(args.wal_dir)

    standby = None
    host = None
    sink = None
    if replicate:
        # Receiver side first: reload whatever standby logs this replica
        # already holds for its peers (restart warm, same disk layout as
        # the in-process plane: <wal_dir>/standby/<origin>/).
        standby = replication_lib.StandbyStore(args.wal_dir)

    datastore = None
    if args.wal_dir:
        datastore = wal_lib.PersistentDataStore(
            args.wal_dir,
            snapshot_interval=(args.snapshot_interval or None),
            on_append=None,  # the sink attaches below, post-replay
        )
        print(
            f"[{args.replica_id}] replayed {datastore.recovered_records} "
            f"WAL records (torn tail: {datastore.recovered_torn_tail})",
            file=sys.stderr,
            flush=True,
        )

    server = vizier_server.DefaultVizierServer(
        host=args.host,
        port=args.port or None,
        datastore=datastore,
        device=args.device,
    )
    # Tag this process's request spans so a merged fleet dump stays
    # attributable even if files are renamed.
    server.servicer.replica_id = args.replica_id

    # Disaggregated compute tier (opt-in): route Pythia dispatch to the
    # shared compute server, keeping the local Pythia as the graceful
    # degradation path. With the tier off this is a no-op and the replica
    # is bit-identical to the self-contained topology.
    from vizier_tpu_torch.distributed import compute_tier as compute_tier_lib

    pythia_endpoint = compute_tier_lib.maybe_wrap_pythia(
        server.pythia_servicer,
        replica_id=args.replica_id,
        endpoint=args.compute_endpoint,
    )
    if pythia_endpoint is not server.pythia_servicer:
        server.servicer.set_pythia(pythia_endpoint)
        print(
            f"[{args.replica_id}] compute tier armed: "
            f"{pythia_endpoint.stats()['endpoint']}",
            file=sys.stderr,
            flush=True,
        )

    if replicate:
        # Origin side: stream this replica's appends to each study's
        # rendezvous successors over gRPC. An optional VIZIER_TORCH_NETCHAOS
        # schedule (seeded, parsed once) injects drops/delays/duplicates
        # on the outbound links — the in-replica arm of the network
        # fault-injection harness.
        net = None
        chaos_spec = env_registry.env_str("VIZIER_TORCH_NETCHAOS")
        if chaos_spec:
            net = netchaos_lib.NetChaos.from_spec(chaos_spec)
        link = repl_service.GrpcReplicationLink(
            peers, src_id=args.replica_id, netchaos=net
        )
        registry = server.pythia_servicer.serving_runtime.metrics
        host = repl_service.ReplicaReplicationHost(
            args.replica_id,
            [args.replica_id, *peers],
            datastore=datastore,
            link=link,
            factor=args.replication_factor or dist_config.replication_factor,
            epoch=max(1, args.replication_epoch),
            queue_size=dist_config.replication_queue,
            batch_max=dist_config.replication_batch,
            registry=registry,
        )
        sink = host.sink()
        datastore.set_append_sink(sink)
    # The replication surface is served unconditionally (Heartbeat is the
    # lease-renewal probe even on tiers that do not replicate).
    replication_servicer = repl_service.ReplicationServicer(
        args.replica_id,
        standby if standby is not None else replication_lib.StandbyStore(),
        datastore=datastore,
        host=host,
    )
    grpc_stubs.add_replication_servicer_to_server(
        replication_servicer, server._server
    )

    # The handlers go in before READY: a caller may signal as soon as it
    # reads the line. They only append to a list: a handler runs on the main
    # thread between bytecodes, and one that set a threading.Event could
    # deadlock on the Event's lock if it landed inside the main thread's own
    # Event.wait.
    stopping = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, _frame: stopping.append(signum))
    print(f"READY {server.endpoint}", flush=True)
    while not stopping:
        time.sleep(0.1)

    # Graceful shutdown, in dependency order: (1) drain in-flight RPCs
    # through the gRPC grace window (no new appends after this), (2) flush
    # the replication streamer so every acked append reaches its standby
    # logs, (3) compact + close the WAL and standby stores (the durable
    # state is final), then (4) write the observability dump — the dump
    # describes the state the disk actually holds.
    server.stop(grace=args.shutdown_grace)
    if host is not None:
        host.flush(args.shutdown_grace)
        host.close()
        # Close the link's channels to the peers: an open channel keeps its
        # connectivity watcher running into interpreter teardown.
        for endpoint in peers.values():
            grpc_stubs.close_channel(endpoint)
    if datastore is not None:
        try:
            datastore.compact_now()
        except Exception as e:  # diverged store: close what we can
            print(
                f"[{args.replica_id}] shutdown compaction skipped: {e}",
                file=sys.stderr,
                flush=True,
            )
        datastore.close()
    if standby is not None:
        standby.close()
    if obs_dump_dir:
        # Shutdown dump: this replica's span ring, metric snapshot, and
        # flight-recorder events, in the fleet merge's file layout.
        from vizier_tpu_torch.observability import fleet as fleet_lib
        from vizier_tpu_torch.observability import flight_recorder as recorder_lib
        from vizier_tpu_torch.observability import tracing as tracing_lib

        written = fleet_lib.dump_process(
            obs_dump_dir,
            args.replica_id,
            tracer=tracing_lib.get_tracer(),
            registry=server.pythia_servicer.serving_runtime.metrics,
            recorder=recorder_lib.get_recorder(),
        )
        print(
            f"[{args.replica_id}] observability dump: "
            f"{', '.join(sorted(written.values()))}",
            file=sys.stderr,
            flush=True,
        )


if __name__ == "__main__":
    main()
