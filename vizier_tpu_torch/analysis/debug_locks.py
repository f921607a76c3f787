"""Pass 4: runtime lock-order recording that cross-checks the static graph.

The port's copy of the JAX package's ``analysis/debug_locks.py``.

:func:`instrument` monkeypatches ``threading.Lock`` / ``RLock`` /
``Condition`` with wrappers that record, per thread, which locks are held
when another is acquired — the *observed* acquisition graph. Each wrapper
remembers the first non-library frame of its creation stack, so an
observed lock maps back to the static
:class:`~vizier_tpu_torch.analysis.lock_order.LockSite` created at the same
``(file, line)``; locks built through factories (``defaultdict(
threading.Lock)`` creates at the access site, not the declaration site)
fall back to the file's unique static site.

The chaos/serving tests run a threaded workload under ``instrument()``
and then call :func:`check_against_static`: every observed edge must
already be in the static graph (or the baseline) — an edge the static
pass missed is a resolution gap to fix, not a test flake to retry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, Iterator, List, Optional, Set, Tuple

from vizier_tpu_torch.analysis import lock_order

_LIBRARY_HINTS = ("analysis/debug_locks.py", "threading.py", "importlib")


@dataclasses.dataclass(frozen=True)
class CreationSite:
    path: str  # absolute file of the creating frame
    line: int

    def short(self) -> str:
        return f"{os.path.basename(self.path)}:{self.line}"


@dataclasses.dataclass(frozen=True)
class ObservedEdge:
    src: CreationSite
    dst: CreationSite
    thread: str


class LockObservatory:
    """Shared sink for every instrumented lock's acquisition events."""

    def __init__(self):
        self._mutex = threading.Lock()  # guards the edge/site tables only
        self._held = threading.local()
        self.edges: Set[ObservedEdge] = set()
        self.sites: Set[CreationSite] = set()
        self.acquisitions = 0

    def _stack(self) -> List["_InstrumentedBase"]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def record_site(self, site: CreationSite) -> None:
        with self._mutex:
            self.sites.add(site)

    def on_acquired(self, lock: "_InstrumentedBase") -> None:
        stack = self._stack()
        with self._mutex:
            self.acquisitions += 1
            for held in stack:
                if held is lock or held.site == lock.site:
                    continue  # reentrancy / sibling instances of one site
                self.edges.add(
                    ObservedEdge(
                        held.site, lock.site, threading.current_thread().name
                    )
                )
        stack.append(lock)

    def on_released(self, lock: "_InstrumentedBase") -> None:
        stack = self._stack()
        # Release order need not be LIFO (c.f. explicit acquire/release);
        # drop the most recent matching entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def edge_pairs(self) -> Set[Tuple[CreationSite, CreationSite]]:
        with self._mutex:
            return {(e.src, e.dst) for e in self.edges}


def _creation_site() -> CreationSite:
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if not any(hint in path for hint in _LIBRARY_HINTS):
            return CreationSite(path=path, line=frame.f_lineno)
        frame = frame.f_back
    return CreationSite(path="<unknown>", line=0)


class _InstrumentedBase:
    def __init__(self, inner, observatory: LockObservatory):
        self._inner = inner
        self.observatory = observatory
        self.site = _creation_site()
        observatory.record_site(self.site)

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self.observatory.on_acquired(self)
        return got

    def release(self):
        self._inner.release()
        self.observatory.on_released(self)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class InstrumentedLock(_InstrumentedBase):
    pass


class InstrumentedRLock(_InstrumentedBase):
    pass


class InstrumentedCondition(_InstrumentedBase):
    """Condition wrapper: the underlying lock IS the condition's lock, so
    wait() releasing and re-acquiring it is tracked coherently."""

    def __init__(self, real_condition_factory, observatory: LockObservatory):
        super().__init__(real_condition_factory(), observatory)

    def wait(self, timeout: Optional[float] = None):
        # wait() atomically releases the condition lock; mirror that in the
        # held stack so waiting does not manufacture false edges.
        self.observatory.on_released(self)
        try:
            return self._inner.wait(timeout)
        finally:
            self.observatory.on_acquired(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self.observatory.on_released(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self.observatory.on_acquired(self)

    def notify(self, n: int = 1):
        return self._inner.notify(n)

    def notify_all(self):
        return self._inner.notify_all()

    def locked(self):  # Condition has no locked(); keep the wrapper honest
        raise AttributeError("Condition has no locked()")


@contextlib.contextmanager
def instrument(
    observatory: Optional[LockObservatory] = None,
) -> Iterator[LockObservatory]:
    """Patches ``threading.Lock/RLock/Condition`` inside the block.

    Only locks *constructed* inside the block are instrumented; existing
    locks keep running untouched (their acquisitions are simply not
    observed). Nesting instrument() is not supported.
    """
    obs = observatory or LockObservatory()
    real_lock, real_rlock = threading.Lock, threading.RLock
    real_condition = threading.Condition

    def make_lock():
        return InstrumentedLock(real_lock(), obs)

    def make_rlock():
        return InstrumentedRLock(real_rlock(), obs)

    def make_condition(lock=None):
        # The real Condition must wrap a REAL lock: handing it an
        # instrumented wrapper breaks its _is_owned() probe (a reentrant
        # acquire(0) on a wrapper succeeds, so the probe concludes "not
        # owned" and wait() raises). Unwrap caller-supplied instrumented
        # locks; default to an unpatched RLock.
        if isinstance(lock, _InstrumentedBase):
            inner_lock = lock._inner
        elif lock is not None:
            inner_lock = lock
        else:
            inner_lock = real_rlock()
        return InstrumentedCondition(lambda: real_condition(inner_lock), obs)

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.RLock = make_rlock  # type: ignore[assignment]
    threading.Condition = make_condition  # type: ignore[assignment]
    try:
        yield obs
    finally:
        threading.Lock = real_lock  # type: ignore[assignment]
        threading.RLock = real_rlock  # type: ignore[assignment]
        threading.Condition = real_condition  # type: ignore[assignment]


def map_site(
    site: CreationSite,
    static_sites: List[lock_order.LockSite],
    repo_root: str,
) -> Optional[str]:
    """The static lock id created at ``site``, or None.

    Exact ``(file, line)`` match first; for factory-created locks (whose
    creation frame is the *access* site) fall back to the file's static
    site when the file declares exactly one.
    """
    norm = site.path.replace("\\", "/")
    in_file: List[lock_order.LockSite] = []
    for s in static_sites:
        static_abs = os.path.join(repo_root, s.path).replace("\\", "/")
        if norm.endswith(s.path) or norm == static_abs:
            in_file.append(s)
            if s.line == site.line:
                return s.lock_id
    if len(in_file) == 1:
        return in_file[0].lock_id
    factories = [s for s in in_file if s.factory]
    if len(factories) == 1:
        return factories[0].lock_id
    return None


@dataclasses.dataclass
class CrossCheckResult:
    # Observed edges whose endpoints both mapped to static sites but which
    # the static graph does not contain: static-analysis gaps.
    missing_static: List[Tuple[str, str, ObservedEdge]]
    # Observed edges fully mapped AND statically predicted (the good case).
    confirmed: List[Tuple[str, str]]
    # Creation sites that could not be joined to any static site (locks
    # created by code outside the scanned tree, e.g. test scaffolding).
    unmapped_sites: List[CreationSite]


def check_against_static(
    observatory: LockObservatory,
    static_result: lock_order.LockOrderResult,
    repo_root: str,
    allowed_extra: Optional[Set[Tuple[str, str]]] = None,
) -> CrossCheckResult:
    mapping: Dict[CreationSite, Optional[str]] = {}
    for site in observatory.sites:
        mapping[site] = map_site(site, static_result.sites, repo_root)
    static_edges = static_result.edge_pairs()
    allowed = allowed_extra or set()
    missing: List[Tuple[str, str, ObservedEdge]] = []
    confirmed: List[Tuple[str, str]] = []
    for edge in sorted(
        observatory.edges, key=lambda e: (e.src.short(), e.dst.short())
    ):
        src_id, dst_id = mapping.get(edge.src), mapping.get(edge.dst)
        if src_id is None or dst_id is None or src_id == dst_id:
            continue
        if (src_id, dst_id) in static_edges or (src_id, dst_id) in allowed:
            confirmed.append((src_id, dst_id))
        else:
            missing.append((src_id, dst_id, edge))
    unmapped = sorted(
        (s for s, lock_id in mapping.items() if lock_id is None),
        key=lambda s: (s.path, s.line),
    )
    return CrossCheckResult(
        missing_static=missing, confirmed=confirmed, unmapped_sites=unmapped
    )
