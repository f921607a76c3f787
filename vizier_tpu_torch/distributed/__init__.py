"""Horizontally sharded service tier.

One ``VizierService`` replica serves one shard of the study population;
studies are assigned to replicas by rendezvous hashing of their resource
names (``routing.StudyRouter``), clients reach the owning replica through a
drop-in stub wrapper (``router_stub.RoutedVizierStub`` — ``VizierClient``
code is unchanged), each replica's RAM datastore persists through a
snapshot + write-ahead log (``wal.PersistentDataStore``) so replicas
restart warm, WAL appends stream to each study's rendezvous successors'
standby logs (``replication.py``) so failover needs **no shared
filesystem**, and ``replica_manager.ReplicaManager`` health-checks the
fleet and fails a dead replica's studies over to their rendezvous
successors — the reliability layer's retries absorb the transition.

The port's copy of the JAX package's ``distributed/`` (the same
``__all__``). Deployment topologies:

- **in-process** — N ``VizierServicer`` replicas behind one
  ``ReplicaManager``, all feeding ONE shared Pythia (designer cache,
  coalescer, cross-study batch executor). No transport hop: the router IS
  the channel.
- **subprocess / multi-host** — N ``DefaultVizierServer`` processes
  (``python -m vizier_tpu_torch.distributed.replica_main``), routed over real
  gRPC channels; each process hosts its own Pythia, persists epoch-fenced
  standby logs for its rendezvous predecessors on its own disk, and
  streams its WAL appends to successors over the ``ReplicationService``
  gRPC surface (``replication_service.py``).
  ``subprocess_fleet.SubprocessReplicaManager`` spawns and manages the
  fleet with lease-based failure detection (heartbeat RPCs; death on
  lease expiry), fence-first failover from standby logs over the wire,
  and partition tolerance (``testing.netchaos``): a partitioned-away
  replica that comes back finds its stale appends rejected by fenced
  standby stores.

``ShardedDataStore`` is the datastore-granularity analogue: one service
process partitioning its studies across per-shard stores through the same
rendezvous hash.

The exports load lazily (PEP 562): ``routing`` and the serving stack import
no gRPC or protobuf, so a GPU host with only the serving stack installed
can still route studies with ``vizier_tpu_torch.distributed.routing``.
"""

import importlib

# name -> submodule that defines it.
_EXPORTS = {
    "DistributedConfig": "config",
    "GrpcReplicationLink": "replication_service",
    "PersistentDataStore": "wal",
    "ReplicaManager": "replica_manager",
    "ReplicaReplicationHost": "replication_service",
    "ReplicationServicer": "replication_service",
    "ReplicationStreamer": "replication",
    "RoutedVizierStub": "router_stub",
    "ShardedDataStore": "sharded_datastore",
    "StandbyStore": "replication",
    "StudyRouter": "routing",
    "SubprocessReplicaManager": "subprocess_fleet",
    "WriteAheadLog": "wal",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
