"""Seeded NETWORK fault injection for the cross-process tier.

A copy of the JAX package's ``testing/netchaos.py``: the same schedule,
spec strings and draw order, so one seed strikes the same calls in both.

This module injects faults at the **links** of the fleet: every wrapped
call is attributed to a directed ``src -> dst`` edge of the fleet graph,
and a per-link schedule decides whether the call is dropped (raises
transport-shaped), delayed (a slow link, NOT a dead one — the case lease
detection must tolerate), duplicated (the at-least-once delivery the
replication protocol's seq filtering must absorb), or partitioned away
entirely.

- :class:`NetChaos` — the seeded schedule + RNG. ``set_link`` installs
  probabilistic drop/delay/duplicate rules (``*`` wildcards match any
  node); ``partition(node)``/``heal(node)`` atomically isolate/rejoin a
  node (every link touching it fails), ``partition_link`` severs one
  directed edge. All draws come from ONE ``random.Random(seed)`` behind
  a leaf lock, and every strike draws exactly three variates, so a
  single-threaded run is exactly reproducible regardless of which
  probabilities are zero.
- :meth:`NetChaos.wrap` / :meth:`NetChaos.wrap_stub` — callable/stub
  proxies that strike before delegating. Drops and partitions raise
  ``ConnectionError`` subclasses, so the reliability layer classifies
  them transient and the routed stub's failure hook sees a transport
  fault — injected faults travel the exact production failure path.
- :meth:`NetChaos.from_spec` — parses the ``VIZIER_TORCH_NETCHAOS`` string
  (``seed=7;drop=a>b:0.1;delay=a>*:0.05@0.3;dup=a>b:0.02;partition=c``),
  which is how a subprocess replica arms fault injection on its own
  outbound replication links (``replica_main`` hands the parsed schedule
  to its ``GrpcReplicationLink``, which strikes the ``replica_id ->
  successor`` link before every delivery attempt).

Fail-fast by design: strikes happen BEFORE the delegate runs, so a
dropped call never leaves a half-applied write behind; a *duplicated*
call runs the delegate twice and returns the second outcome (at-least-
once delivery — receivers must deduplicate, which the standby store's
sequence filtering and the WAL's tolerant replay both do).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class NetChaosError(ConnectionError):
    """An injected network fault (transport-shaped: classified transient)."""


class LinkDroppedError(NetChaosError):
    """The link's schedule dropped this call."""


class PartitionedError(NetChaosError):
    """The link is inside a partition window."""


class LinkRule:
    """One directed link's fault schedule."""

    def __init__(
        self,
        *,
        drop_prob: float = 0.0,
        delay_prob: float = 0.0,
        delay_secs: float = 0.0,
        duplicate_prob: float = 0.0,
    ):
        for name, p in (
            ("drop_prob", drop_prob),
            ("delay_prob", delay_prob),
            ("duplicate_prob", duplicate_prob),
        ):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.drop_prob = drop_prob
        self.delay_prob = delay_prob
        self.delay_secs = delay_secs
        self.duplicate_prob = duplicate_prob


class NetChaos:
    """Seeded per-link drop/delay/duplicate/partition injection."""

    def __init__(
        self,
        seed: int = 0,
        *,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        self.seed = seed
        self._sleep_fn = sleep_fn
        self._rng = random.Random(seed)
        # Leaf lock: RNG draws, rule/partition tables, counters only.
        self._lock = threading.Lock()
        self._rules: Dict[Tuple[str, str], LinkRule] = {}
        self._partitioned_nodes: set = set()
        self._partitioned_links: set = set()
        # "src>dst" -> {"calls", "drops", "delays", "duplicates",
        # "partitioned"}
        self._counts: Dict[str, Dict[str, int]] = {}

    # -- schedule ------------------------------------------------------------

    def set_link(
        self,
        src: str,
        dst: str,
        *,
        drop_prob: float = 0.0,
        delay_prob: float = 0.0,
        delay_secs: float = 0.0,
        duplicate_prob: float = 0.0,
    ) -> None:
        """Installs (or replaces) the rule for ``src -> dst``; ``*``
        matches any node (exact beats ``src>*`` beats ``*>dst`` beats
        ``*>*``)."""
        rule = LinkRule(
            drop_prob=drop_prob,
            delay_prob=delay_prob,
            delay_secs=delay_secs,
            duplicate_prob=duplicate_prob,
        )
        with self._lock:
            self._rules[(src, dst)] = rule

    def clear_link(self, src: str, dst: str) -> None:
        with self._lock:
            self._rules.pop((src, dst), None)

    def partition(self, *nodes: str) -> None:
        """Isolates ``nodes``: every link touching any of them fails with
        :class:`PartitionedError` until :meth:`heal`."""
        with self._lock:
            self._partitioned_nodes.update(nodes)

    def heal(self, *nodes: str) -> None:
        """Rejoins ``nodes`` (and clears directed partitions touching
        them)."""
        with self._lock:
            self._partitioned_nodes.difference_update(nodes)
            self._partitioned_links = {
                (s, d)
                for s, d in self._partitioned_links
                if s not in nodes and d not in nodes
            }

    def partition_link(self, src: str, dst: str) -> None:
        """Severs ONE directed edge (asymmetric partitions: a can reach b
        while b cannot reach a)."""
        with self._lock:
            self._partitioned_links.add((src, dst))

    def heal_link(self, src: str, dst: str) -> None:
        with self._lock:
            self._partitioned_links.discard((src, dst))

    def is_partitioned(self, src: str, dst: str) -> bool:
        with self._lock:
            return self._is_partitioned_locked(src, dst)

    def _is_partitioned_locked(self, src: str, dst: str) -> bool:
        return (
            src in self._partitioned_nodes
            or dst in self._partitioned_nodes
            or (src, dst) in self._partitioned_links
        )

    def _rule_for(self, src: str, dst: str) -> Optional[LinkRule]:
        for key in ((src, dst), (src, "*"), ("*", dst), ("*", "*")):
            rule = self._rules.get(key)
            if rule is not None:
                return rule
        return None

    # -- injection -----------------------------------------------------------

    def strike(self, src: str, dst: str) -> bool:
        """One send over ``src -> dst``: maybe partitioned, dropped, or
        delayed; returns True when the call must be DUPLICATED.

        Always draws exactly three variates per call, so the fault
        sequence is a pure function of (seed, call index) — independent
        of which probabilities are zero.
        """
        site = f"{src}>{dst}"
        with self._lock:
            counts = self._counts.setdefault(
                site,
                {
                    "calls": 0,
                    "drops": 0,
                    "delays": 0,
                    "duplicates": 0,
                    "partitioned": 0,
                },
            )
            counts["calls"] += 1
            rule = self._rule_for(src, dst)
            drop = self._rng.random() < (rule.drop_prob if rule else 0.0)
            lag = self._rng.random() < (rule.delay_prob if rule else 0.0)
            dup = self._rng.random() < (
                rule.duplicate_prob if rule else 0.0
            )
            if self._is_partitioned_locked(src, dst):
                counts["partitioned"] += 1
                raise PartitionedError(
                    f"netchaos: link {site} is partitioned"
                )
            if drop:
                counts["drops"] += 1
            if lag:
                counts["delays"] += 1
            if dup:
                counts["duplicates"] += 1
            delay_secs = rule.delay_secs if (rule and lag) else 0.0
        if delay_secs > 0:
            self._sleep_fn(delay_secs)
        if drop:
            raise LinkDroppedError(f"netchaos: dropped on link {site}")
        return dup

    def wrap(self, fn: Callable, src: str, dst: str) -> Callable:
        """Wraps one callable as traffic on ``src -> dst``."""

        def wrapped(*args, **kwargs):
            duplicate = self.strike(src, dst)
            if duplicate:
                # At-least-once delivery: run the delegate twice; the
                # first outcome (result OR error) is discarded — the wire
                # only promises the SECOND copy's fate to the caller.
                try:
                    fn(*args, **kwargs)
                except Exception:
                    pass
            return fn(*args, **kwargs)

        return wrapped

    def wrap_stub(
        self,
        stub: Any,
        src: str,
        dst: str,
        methods: Optional[Sequence[str]] = None,
    ) -> "_NetChaosStub":
        """Proxies a service stub so each listed RPC (default: every
        public callable) rides the ``src -> dst`` link."""
        return _NetChaosStub(stub, self, src, dst, methods)

    # -- accounting ----------------------------------------------------------

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {site: dict(c) for site, c in self._counts.items()}

    def total(self, field: str) -> int:
        with self._lock:
            return sum(c.get(field, 0) for c in self._counts.values())

    # -- env-spec parsing ----------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "NetChaos":
        """Parses a ``VIZIER_TORCH_NETCHAOS`` schedule string.

        Semicolon-separated directives::

            seed=7                      # RNG seed (default 0)
            drop=src>dst:0.1            # drop probability on one link
            delay=src>dst:0.05@0.3      # 50 ms delay at probability 0.3
                                        # (@prob optional, default 1.0)
            dup=src>dst:0.02            # duplicate probability
            partition=node              # isolate a node
            partition=src>dst           # sever one directed edge

        ``*`` wildcards match any node on either side.
        """
        net = cls()
        directives = [d.strip() for d in spec.split(";") if d.strip()]
        pending: Dict[Tuple[str, str], Dict[str, float]] = {}
        partitions = []
        for directive in directives:
            key, _, value = directive.partition("=")
            key, value = key.strip(), value.strip()
            if not value:
                raise ValueError(f"Bad netchaos directive: {directive!r}")
            if key == "seed":
                net = cls(seed=int(value))
            elif key == "partition":
                partitions.append(value)
            elif key in ("drop", "delay", "dup"):
                link_part, _, prob_part = value.partition(":")
                src, sep, dst = link_part.partition(">")
                if not sep or not prob_part:
                    raise ValueError(
                        f"Bad netchaos directive: {directive!r} "
                        "(expected key=src>dst:value)"
                    )
                rule = pending.setdefault((src, dst), {})
                if key == "drop":
                    rule["drop_prob"] = float(prob_part)
                elif key == "dup":
                    rule["duplicate_prob"] = float(prob_part)
                else:
                    secs, _, prob = prob_part.partition("@")
                    rule["delay_secs"] = float(secs)
                    rule["delay_prob"] = float(prob) if prob else 1.0
            else:
                raise ValueError(f"Unknown netchaos directive: {key!r}")
        for (src, dst), kwargs in pending.items():
            net.set_link(src, dst, **kwargs)
        for value in partitions:
            src, sep, dst = value.partition(">")
            if sep:
                net.partition_link(src, dst)
            else:
                net.partition(value)
        return net


class _NetChaosStub:
    """Stub proxy routing each RPC through one link's schedule."""

    def __init__(
        self,
        inner: Any,
        net: NetChaos,
        src: str,
        dst: str,
        methods: Optional[Sequence[str]],
    ):
        self._inner = inner
        self._net = net
        self._src = src
        self._dst = dst
        self._methods = frozenset(methods) if methods is not None else None

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr):
            return attr
        if self._methods is not None and name not in self._methods:
            return attr
        return self._net.wrap(attr, self._src, self._dst)
