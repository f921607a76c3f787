"""Knobs for the sharded service tier.

A copy of the JAX package's ``distributed/config.py`` under the port's
switch prefix, read through ``vizier_tpu_torch.utils.env``. Everything
defaults to a working single-host tier:

- ``VIZIER_TORCH_DISTRIBUTED=0`` — router off-switch: every study
  routes to the first replica (a sharded deployment degrades to the
  single-server topology without touching client code);
- ``VIZIER_TORCH_DISTRIBUTED_REPLICAS=N`` — replica count for tiers built
  from the environment (``ReplicaManager()`` with no explicit count);
- ``VIZIER_TORCH_DISTRIBUTED_WAL_DIR=/path`` — root directory for per-replica
  snapshot+WAL persistence ('' = RAM only, no restart warmth);
- ``VIZIER_TORCH_DISTRIBUTED_SNAPSHOT_INTERVAL`` — mutations per shard between
  snapshot compactions (smaller = shorter replay, more snapshot I/O);
- ``VIZIER_TORCH_DISTRIBUTED_WAL_FSYNC=1`` — fsync the WAL per append:
  mutations survive OS crashes/power loss, not just process crashes, at
  the cost of a disk sync on every write (off by default);
- ``VIZIER_TORCH_DISTRIBUTED_REPLICATION=0`` — WAL replication off-switch:
  appends stream to each study's rendezvous successors' standby logs so
  failover needs no shared filesystem (on by default when a WAL root is
  configured; off = local-disk-only failover);
- ``VIZIER_TORCH_DISTRIBUTED_REPLICATION_FACTOR`` — standby copies per study (K
  rendezvous successors receive its records);
- ``VIZIER_TORCH_DISTRIBUTED_REPLICATION_QUEUE`` — per-origin streamer queue
  bound (overflow drops + re-baselines, never blocks the write path);
- ``VIZIER_TORCH_DISTRIBUTED_REPLICATION_BATCH`` — records per streamed batch;
- ``VIZIER_TORCH_DISTRIBUTED_LEASE_TIMEOUT_S`` — seconds without a renewed
  heartbeat before the subprocess fleet manager declares a replica dead
  (lease-based failure detection — ``distributed.subprocess_fleet``);
- ``VIZIER_TORCH_DISTRIBUTED_HEARTBEAT_INTERVAL_S`` — cadence of the manager's
  lease-renewal Heartbeat probes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Every VIZIER_TORCH_* switch is read through the port's env module.
from vizier_tpu_torch.utils import env as _registry

DEFAULT_REPLICAS = 4
DEFAULT_SNAPSHOT_INTERVAL = 256
DEFAULT_REPLICATION_FACTOR = 2
DEFAULT_REPLICATION_QUEUE = 4096
DEFAULT_REPLICATION_BATCH = 64
DEFAULT_LEASE_TIMEOUT_S = 3.0
DEFAULT_HEARTBEAT_INTERVAL_S = 1.0


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Knobs for the sharded service tier."""

    # Router on/off. Off = rendezvous ranking is ignored and every study
    # maps to the first replica; the WAL and replica plumbing still work.
    routing: bool = True
    # Replica count used when a tier is built without an explicit count.
    num_replicas: int = DEFAULT_REPLICAS
    # Snapshot+WAL root ('' / None = no persistence). Each replica owns the
    # subdirectory ``<wal_root>/<replica_id>``.
    wal_root: Optional[str] = None
    # Mutations between snapshot compactions (per shard).
    snapshot_interval: int = DEFAULT_SNAPSHOT_INTERVAL
    # fsync the WAL on every append. Off = appends are flushed to the OS
    # (durable across process crashes only); on = durable across OS
    # crashes/power loss too, at a per-mutation disk-sync cost.
    wal_fsync: bool = False
    # Deadline-bounded Pythia dispatch on in-process replicas. The router
    # already owns wedged-replica semantics (health check -> mark down ->
    # failover), so the per-suggest dispatch thread the deadline path
    # spawns is redundant overhead inside a managed tier; subprocess
    # replicas (no manager watching them) keep it on.
    replica_deadlines: bool = False
    # Shared-nothing durability: stream every WAL append to the study's
    # K rendezvous successors' standby logs, so failover needs no shared
    # filesystem. Active only when a WAL root is configured (the stream
    # IS the WAL's append feed); off = local-disk-only failover.
    replication: bool = True
    replication_factor: int = DEFAULT_REPLICATION_FACTOR
    # Streamer bounds: a full queue drops + re-baselines (the write path
    # never blocks on replication); batches cap per-delivery work.
    replication_queue: int = DEFAULT_REPLICATION_QUEUE
    replication_batch: int = DEFAULT_REPLICATION_BATCH
    # Lease-based failure detection for SUBPROCESS replicas: the fleet
    # manager renews a per-replica lease on every successful Heartbeat
    # RPC and declares death when a lease runs out. A slow-but-alive
    # replica keeps renewing (delays shorter than the timeout never
    # trigger failover); a partitioned or crashed one expires.
    lease_timeout_s: float = DEFAULT_LEASE_TIMEOUT_S
    heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        """The default config with environment overrides applied."""
        return cls(
            routing=_registry.env_on("VIZIER_TORCH_DISTRIBUTED"),
            num_replicas=max(
                1,
                _registry.env_int(
                    "VIZIER_TORCH_DISTRIBUTED_REPLICAS", DEFAULT_REPLICAS
                ),
            ),
            wal_root=_registry.env_str("VIZIER_TORCH_DISTRIBUTED_WAL_DIR") or None,
            snapshot_interval=max(
                1,
                _registry.env_int(
                    "VIZIER_TORCH_DISTRIBUTED_SNAPSHOT_INTERVAL",
                    DEFAULT_SNAPSHOT_INTERVAL,
                ),
            ),
            wal_fsync=_registry.env_on("VIZIER_TORCH_DISTRIBUTED_WAL_FSYNC", "0"),
            replication=_registry.env_on("VIZIER_TORCH_DISTRIBUTED_REPLICATION"),
            replication_factor=max(
                1,
                _registry.env_int(
                    "VIZIER_TORCH_DISTRIBUTED_REPLICATION_FACTOR",
                    DEFAULT_REPLICATION_FACTOR,
                ),
            ),
            replication_queue=max(
                1,
                _registry.env_int(
                    "VIZIER_TORCH_DISTRIBUTED_REPLICATION_QUEUE",
                    DEFAULT_REPLICATION_QUEUE,
                ),
            ),
            replication_batch=max(
                1,
                _registry.env_int(
                    "VIZIER_TORCH_DISTRIBUTED_REPLICATION_BATCH",
                    DEFAULT_REPLICATION_BATCH,
                ),
            ),
            lease_timeout_s=max(
                0.1,
                _registry.env_float(
                    "VIZIER_TORCH_DISTRIBUTED_LEASE_TIMEOUT_S",
                    DEFAULT_LEASE_TIMEOUT_S,
                ),
            ),
            heartbeat_interval_s=max(
                0.01,
                _registry.env_float(
                    "VIZIER_TORCH_DISTRIBUTED_HEARTBEAT_INTERVAL_S",
                    DEFAULT_HEARTBEAT_INTERVAL_S,
                ),
            ),
        )

    def as_dict(self) -> dict:
        """JSON-ready dump (evidence tools stamp this into their reports)."""
        return dataclasses.asdict(self)
