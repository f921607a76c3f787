"""Study-affinity routing: rendezvous hashing over service replicas.

A copy of the JAX package's ``distributed/routing.py``: the same weights
(blake2b, 8 bytes, over ``replica_id|study_key``), so the port and the JAX
package place every study on the same replica. Pure Python: the card's
fleet phase imports it without gRPC or protobuf.

Rendezvous (highest-random-weight) hashing instead of a ring: every
``(replica, study)`` pair gets a deterministic pseudo-random weight and a
study lives on its highest-weight live replica. Removing a replica remaps
ONLY that replica's studies (each falls to its second-ranked choice);
adding one steals only the studies that now rank it first — the minimal
disruption property a consistent-hash ring needs virtual nodes to
approximate, with no ring state at all.

Weights come from ``hashlib.blake2b`` over ``replica_id|study_key``, so the
assignment is stable across processes, interpreter restarts, and hosts —
a client-side router and a server-side ``ShardedDataStore`` computing the
placement independently always agree.

``StudyRouter`` is the shared placement + liveness table. Its lock is a
LEAF lock guarding dict/set bookkeeping only (no I/O, no callbacks under
it).
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def rendezvous_weight(replica_id: str, study_key: str) -> int:
    """Deterministic 64-bit weight of placing ``study_key`` on ``replica_id``."""
    digest = hashlib.blake2b(
        f"{replica_id}|{study_key}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


class NoLiveReplicaError(ConnectionError):
    """Every replica is marked down (transient: retries may heal it)."""


class StudyRouter:
    """Maps study resource names onto replica ids, tracking liveness."""

    def __init__(
        self,
        replica_ids: Sequence[str],
        *,
        routing: bool = True,
        route_cache_size: Optional[int] = None,
    ):
        if not replica_ids:
            raise ValueError("StudyRouter needs at least one replica id.")
        if len(set(replica_ids)) != len(replica_ids):
            raise ValueError(f"Duplicate replica ids: {list(replica_ids)}")
        self._replica_ids: Tuple[str, ...] = tuple(replica_ids)
        self._routing = routing
        self._lock = threading.Lock()
        self._down: set = set()
        # Placement cache: study_key -> (liveness epoch, replica). Routing
        # is pure given the liveness set, so a cached entry stays valid
        # until any replica changes state (the epoch bumps); this turns
        # the per-RPC route into a dict hit instead of N hashes + a sort.
        # LRU-bounded (VIZIER_TORCH_DISTRIBUTED_ROUTE_CACHE_SIZE) so million-study
        # churn cannot grow it without bound: an evicted study just pays
        # the N-hash ranking again on its next request.
        if route_cache_size is None:
            from vizier_tpu_torch.utils import env as _registry

            route_cache_size = _registry.env_int(
                "VIZIER_TORCH_DISTRIBUTED_ROUTE_CACHE_SIZE", 65536
            )
        if route_cache_size < 1:
            raise ValueError(
                f"route_cache_size must be >= 1, got {route_cache_size}."
            )
        self._route_cache_size = route_cache_size
        self._epoch = 0
        self._route_cache: "collections.OrderedDict[str, Tuple[int, str]]" = (
            collections.OrderedDict()
        )

    # -- placement ---------------------------------------------------------

    def ranking(self, study_key: str) -> List[str]:
        """All replicas, best placement first (ignores liveness)."""
        if not self._routing:
            return list(self._replica_ids)
        return sorted(
            self._replica_ids,
            key=lambda rid: rendezvous_weight(rid, study_key),
            reverse=True,
        )

    def successors(
        self, study_key: str, origin: str, count: int
    ) -> List[str]:
        """The study's next-``count`` rendezvous choices after ``origin``.

        Liveness-BLIND on purpose: replication successor sets must stay
        stable while replicas bounce (a dead successor just misses
        deliveries until it returns and is re-baselined), and the first
        entry is exactly the replica :meth:`replica_for` falls to when
        ``origin`` dies — the standby log lives where the failover lands.
        """
        ranked = [rid for rid in self.ranking(study_key) if rid != origin]
        return ranked[: max(0, count)]

    def replica_for(self, study_key: str) -> str:
        """The live replica that owns ``study_key``.

        The rendezvous ranking restricted to live replicas: when the
        first-ranked replica is down, its studies fall to their
        second-ranked choice (and ONLY its studies move).
        """
        with self._lock:
            cached = self._route_cache.get(study_key)
            if cached is not None and cached[0] == self._epoch:
                self._route_cache.move_to_end(study_key)
                return cached[1]
            down = set(self._down)
            epoch = self._epoch
        for rid in self.ranking(study_key):
            if rid not in down:
                with self._lock:
                    if self._epoch == epoch:
                        self._route_cache[study_key] = (epoch, rid)
                        self._route_cache.move_to_end(study_key)
                        while len(self._route_cache) > self._route_cache_size:
                            self._route_cache.popitem(last=False)
                return rid
        raise NoLiveReplicaError(
            f"All {len(self._replica_ids)} replicas are down."
        )

    def assignments(self, study_keys: Sequence[str]) -> Dict[str, List[str]]:
        """replica id -> the subset of ``study_keys`` it currently owns."""
        out: Dict[str, List[str]] = {rid: [] for rid in self._replica_ids}
        for key in study_keys:
            out[self.replica_for(key)].append(key)
        return out

    # -- liveness ----------------------------------------------------------

    @property
    def replica_ids(self) -> Tuple[str, ...]:
        return self._replica_ids

    def live_replicas(self) -> List[str]:
        with self._lock:
            return [r for r in self._replica_ids if r not in self._down]

    def is_up(self, replica_id: str) -> bool:
        with self._lock:
            return replica_id not in self._down

    def mark_down(self, replica_id: str) -> bool:
        """Returns True when this call transitioned the replica to down."""
        self._check_known(replica_id)
        with self._lock:
            if replica_id in self._down:
                return False
            self._down.add(replica_id)
            self._epoch += 1  # invalidate every cached route
            return True

    def mark_up(self, replica_id: str) -> bool:
        """Returns True when this call transitioned the replica to up."""
        self._check_known(replica_id)
        with self._lock:
            if replica_id not in self._down:
                return False
            self._down.discard(replica_id)
            self._epoch += 1
            return True

    def last_route(self, study_key: str) -> Optional[str]:
        """The replica ``study_key`` last routed to (observability)."""
        with self._lock:
            cached = self._route_cache.get(study_key)
            return cached[1] if cached is not None else None

    def snapshot(self) -> Dict[str, str]:
        """replica id -> "up"/"down", for serving-stats dumps."""
        with self._lock:
            return {
                rid: ("down" if rid in self._down else "up")
                for rid in self._replica_ids
            }

    def _check_known(self, replica_id: str) -> None:
        if replica_id not in self._replica_ids:
            raise KeyError(f"Unknown replica id: {replica_id!r}")
