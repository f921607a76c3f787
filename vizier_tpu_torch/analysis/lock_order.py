"""Pass 1: static lock-order analysis over the serving stack.

The port's copy of the JAX package's ``analysis/lock_order.py``. Its
critical locks are the port's counterparts of the JAX package's list (the
same classes under the same names), and its device-compute markers are
torch's: a ``.synchronize()`` call, or any call that reaches the port's
device subtrees.

Three things are extracted from the AST, with no code imported or run:

1. **Lock sites** — every ``threading.Lock`` / ``RLock`` / ``Condition``
   construction, including factory forms like
   ``collections.defaultdict(threading.Lock)``. A site is identified by
   ``Class.attr`` (or ``module.NAME`` for module-level locks); the file
   and line are kept so :mod:`vizier_tpu_torch.analysis.debug_locks` can join
   runtime-created locks back to static nodes.

2. **The acquisition graph** — an edge ``A -> B`` means B is (possibly)
   acquired while A is held. Direct ``with a: with b:`` nesting is exact;
   cross-module edges come from resolving calls made under a lock through
   :class:`~vizier_tpu_torch.analysis.common.Project`'s type index and
   propagating each callee's transitive lock set to a fixpoint
   (e.g. ServingRuntime -> designer_cache -> coalescer, and the
   vizier_service study locks -> datastore locks).

3. **Hazards under critical locks** — the rule "no device compute,
   blocking RPC, or ``Condition.wait`` while holding a study/cache lock".
   Blocking markers are ``.wait()`` (except a condition waiting on
   itself), ``WaitForResponse``, ``time.sleep``, thread ``.join``,
   future ``.result``; device compute is a ``.synchronize()`` or any call
   that reaches a module under ``designers/ models/ optimizers/ ops/
   parallel/`` or a
   duck-typed ``designer.*`` receiver; RPC is a duck-typed
   ``_pythia/stub/channel`` receiver or a ``grpc.*`` call.

Violations fail unless listed in ``baseline.toml`` with a reason — the
intentional per-study serialization (device compute under one study's
``CachedDesignerEntry.lock``) is the canonical baselined exception.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from vizier_tpu_torch.analysis import common

PASS_NAME = "lock_order"

_LOCK_CTORS = {"Lock", "RLock", "Condition"}

# Locks whose critical sections must stay free of blocking work. Matched
# by site id; the list mirrors the serving stack's contention points.
DEFAULT_CRITICAL_LOCKS = (
    "VizierServicer._study_locks",
    "DesignerStateCache._lock",
    "CachedDesignerEntry.lock",
    "RequestCoalescer._lock",
    "grpc_stubs._CHANNEL_LOCK",
    # The fleet (vizier_tpu_torch.distributed): the router/WAL locks
    # sit UNDER the study locks on the hot path and must stay leaf-ward
    # (bookkeeping + local file I/O only — no RPC, no device compute).
    "StudyRouter._lock",
    "RoutedVizierStub._lock",
    "PersistentDataStore._lock",
    "ReplicaManager._lock",
)

# Any resolved call landing in these subtrees counts as device compute.
DEVICE_MODULE_PARTS = (
    "designers/",
    "models/",
    "optimizers/",
    "ops/",
    "parallel/",
)

# Receiver names that imply a hazard even when the call target cannot be
# resolved (duck-typed seams: the designer protocol, the Pythia endpoint).
# "channel" is deliberately absent: channel-object methods (subscribe,
# unary_unary, close) register/construct without network round-trips; real
# RPCs go through stubs.
DUCK_DEVICE_RECEIVERS = frozenset({"designer"})
DUCK_RPC_RECEIVERS = frozenset({"_pythia", "stub"})

_WAIT_METHODS = frozenset({"wait", "wait_for", "WaitForResponse"})

# grpc entry points that only CONSTRUCT objects (no network activity —
# channels connect lazily); calling these under a lock is not an RPC.
_NONBLOCKING_GRPC = frozenset(
    {
        "grpc.insecure_channel",
        "grpc.secure_channel",
        "grpc.server",
        "grpc.method_handlers_generic_handler",
        "grpc.unary_unary_rpc_method_handler",
    }
)


@dataclasses.dataclass(frozen=True)
class LockSite:
    lock_id: str  # "Class.attr" or "module.NAME"
    kind: str  # "Lock" | "RLock" | "Condition"
    path: str
    line: int
    factory: bool = False  # constructed via a factory (defaultdict etc.)


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    via: str  # "path::qualname" of the function holding src
    line: int


@dataclasses.dataclass
class LockOrderResult:
    sites: List[LockSite]
    edges: List[Edge]
    findings: List[common.Finding]
    # functions whose calls could not be resolved while a lock was held
    unresolved_calls: int = 0

    def site_ids(self) -> Set[str]:
        return {s.lock_id for s in self.sites}

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}


def _is_lock_ctor(node: ast.AST) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' when node constructs one, else None."""
    if isinstance(node, ast.Call):
        tail = common._tail_name(node.func)
        if tail in _LOCK_CTORS:
            return tail
        # Factory forms: defaultdict(threading.Lock), partial(Condition).
        for arg in node.args:
            tail = common._tail_name(arg)
            if tail in _LOCK_CTORS:
                return tail
    return None


def find_lock_sites(project: common.Project) -> List[LockSite]:
    sites: Dict[str, LockSite] = {}

    def add(lock_id: str, kind: str, path: str, line: int, factory: bool):
        # First construction site wins; re-assignments (e.g. in reset
        # helpers) refer to the same logical lock.
        sites.setdefault(
            lock_id, LockSite(lock_id, kind, path, line, factory)
        )

    for path, tree in project.trees.items():
        module = _module_base(path)
        # Module-level locks.
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                kind = _is_lock_ctor(node.value)
                if kind and isinstance(node.targets[0], ast.Name):
                    factory = common._tail_name(node.value.func) not in _LOCK_CTORS
                    add(
                        f"{module}.{node.targets[0].id}",
                        kind,
                        path,
                        node.lineno,
                        factory,
                    )
        # self.attr locks anywhere inside class methods.
        for cls_name, cls in project.classes.items():
            if cls.path != path:
                continue
            for method in cls.methods.values():
                for node in ast.walk(method.node):
                    value = None
                    target = None
                    if isinstance(node, ast.Assign) and len(node.targets) == 1:
                        target, value = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign) and node.value is not None:
                        target, value = node.target, node.value
                    if value is None:
                        continue
                    kind = _is_lock_ctor(value)
                    if not kind:
                        continue
                    attr = common.Project._self_attr(target)
                    if attr is not None:
                        factory = (
                            common._tail_name(value.func) not in _LOCK_CTORS
                        )
                        add(
                            f"{cls_name}.{attr}", kind, path, node.lineno, factory
                        )
    return sorted(sites.values(), key=lambda s: s.lock_id)


def _module_base(path: str) -> str:
    base = path.rsplit("/", 1)[-1]
    return base[:-3] if base.endswith(".py") else base


class _FunctionSummary:
    def __init__(self):
        # (held_tuple, lock_id, line): direct acquisitions with held context
        self.acquisitions: List[Tuple[Tuple[str, ...], str, int]] = []
        # (held_tuple, callee_qualnames, receiver_tail, attr_name, line)
        self.calls: List[
            Tuple[Tuple[str, ...], Tuple[str, ...], Optional[str], Optional[str], int]
        ] = []
        # Hazard tags triggered directly in this function body with no lock
        # requirement (used for transitive propagation).
        self.direct_tags: Set[str] = set()
        # (held_tuple, tag, detail, line) — hazards observed under a lock.
        self.held_hazards: List[Tuple[Tuple[str, ...], str, str, int]] = []
        self.unresolved_under_lock = 0


class LockOrderAnalyzer:
    def __init__(
        self,
        project: common.Project,
        critical_locks: Sequence[str] = DEFAULT_CRITICAL_LOCKS,
        duck_device: FrozenSet[str] = DUCK_DEVICE_RECEIVERS,
        duck_rpc: FrozenSet[str] = DUCK_RPC_RECEIVERS,
    ):
        self.project = project
        self.critical = set(critical_locks)
        self.duck_device = duck_device
        self.duck_rpc = duck_rpc
        self.sites = find_lock_sites(project)
        self._by_id = {s.lock_id: s for s in self.sites}
        self._by_attr: Dict[str, List[LockSite]] = {}
        for s in self.sites:
            self._by_attr.setdefault(s.lock_id.split(".", 1)[1], []).append(s)
        self.summaries: Dict[str, _FunctionSummary] = {}

    # -- lock expression resolution ----------------------------------------

    def _resolve_lock_expr(
        self,
        node: ast.AST,
        fn: common.FunctionInfo,
        local_types: Dict[str, str],
    ) -> Optional[str]:
        # `with self._study_locks[name]:` — the dict values are the locks.
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            attr = node.attr
            # self.attr: the enclosing class (or a base) owns the site.
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                cls_name = fn.class_name
                while cls_name:
                    if f"{cls_name}.{attr}" in self._by_id:
                        return f"{cls_name}.{attr}"
                    cls = self.project.classes.get(cls_name)
                    cls_name = cls.bases[0] if cls and cls.bases else None
            # typed receiver
            owner = self.project._expr_class(
                node.value,
                local_types,
                self.project.classes.get(fn.class_name) if fn.class_name else None,
            )
            if owner and f"{owner}.{attr}" in self._by_id:
                return f"{owner}.{attr}"
            # unique attribute name across all sites
            candidates = self._by_attr.get(attr, [])
            if len(candidates) == 1:
                return candidates[0].lock_id
            return None
        if isinstance(node, ast.Name):
            lock_id = f"{_module_base(fn.path)}.{node.id}"
            if lock_id in self._by_id:
                return lock_id
            candidates = self._by_attr.get(node.id, [])
            if len(candidates) == 1:
                return candidates[0].lock_id
        return None

    # -- per-function walk ---------------------------------------------------

    def _summarize(self, fn: common.FunctionInfo) -> _FunctionSummary:
        summary = _FunctionSummary()
        local_types = self.project.local_types(fn)
        nested: List[ast.AST] = []

        def visit(node: ast.AST, held: Tuple[str, ...]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # Nested defs run later (threads, callbacks): analyzed as
                # their own functions with an empty held stack.
                nested.append(node)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in node.items:
                    visit(item.context_expr, held)
                    lock_id = self._resolve_lock_expr(
                        item.context_expr, fn, local_types
                    )
                    if lock_id is not None:
                        summary.acquisitions.append(
                            (new_held, lock_id, node.lineno)
                        )
                        new_held = new_held + (lock_id,)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, ast.Call):
                self._record_call(node, fn, local_types, held, summary)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.node.body:
            visit(stmt, ())
        # Nested defs: separate summaries folded into this pass run.
        for i, sub in enumerate(nested):
            if isinstance(sub, ast.Lambda):
                continue
            sub_fn = common.FunctionInfo(
                qualname=f"{fn.qualname}.<{sub.name}>",
                name=sub.name,
                node=sub,
                path=fn.path,
                class_name=fn.class_name,
            )
            self.summaries[sub_fn.qualname] = self._summarize(sub_fn)
        return summary

    def _record_call(
        self,
        call: ast.Call,
        fn: common.FunctionInfo,
        local_types: Dict[str, str],
        held: Tuple[str, ...],
        summary: _FunctionSummary,
    ) -> None:
        func = call.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        receiver_tail = (
            common._tail_name(func.value)
            if isinstance(func, ast.Attribute)
            else None
        )
        dotted_name = common.dotted(func)

        # Direct blocking markers.
        tag: Optional[str] = None
        detail = dotted_name or attr or "?"
        if attr in _WAIT_METHODS:
            # A condition waiting on itself releases the lock: exempt.
            waited = self._resolve_lock_expr(func.value, fn, local_types)
            if not (waited is not None and waited in held):
                tag = "wait"
        elif dotted_name == "time.sleep":
            tag = "wait"
        elif attr == "join" and receiver_tail and "thread" in receiver_tail.lower():
            tag = "wait"
        elif attr == "result" and receiver_tail and "future" in receiver_tail.lower():
            tag = "wait"
        elif attr == "synchronize":
            tag = "device_compute"
        elif receiver_tail in self.duck_rpc or (
            dotted_name
            and dotted_name.startswith("grpc.")
            and dotted_name not in _NONBLOCKING_GRPC
        ):
            tag = "rpc"
        elif receiver_tail in self.duck_device and attr is not None:
            tag = "device_compute"
        if tag is not None:
            summary.direct_tags.add(tag)
            if held:
                summary.held_hazards.append((held, tag, detail, call.lineno))

        # Resolved project callees (for transitive locks/hazards).
        callees = self.project.resolve_call(call, fn, local_types)
        if callees:
            summary.calls.append(
                (
                    held,
                    tuple(c.qualname for c in callees),
                    receiver_tail,
                    attr,
                    call.lineno,
                )
            )
        elif held and isinstance(func, ast.Attribute) and tag is None:
            summary.unresolved_under_lock += 1

    # -- fixpoint propagation -----------------------------------------------

    def run(self) -> LockOrderResult:
        for qualname, fn in list(self.project.functions.items()):
            self.summaries[qualname] = self._summarize(fn)

        # Transitive lock sets and hazard tags per function.
        locks_t: Dict[str, Set[str]] = {}
        tags_t: Dict[str, Set[str]] = {}
        for qualname, summary in self.summaries.items():
            locks_t[qualname] = {a[1] for a in summary.acquisitions}
            tags_t[qualname] = set(summary.direct_tags)
        changed = True
        iterations = 0
        while changed and iterations < 50:
            changed = False
            iterations += 1
            for qualname, summary in self.summaries.items():
                for _, callees, _, _, _ in summary.calls:
                    for callee in callees:
                        if callee == qualname:
                            continue
                        extra_locks = locks_t.get(callee, set()) - locks_t[qualname]
                        if extra_locks:
                            locks_t[qualname] |= extra_locks
                            changed = True
                        callee_tags = set(tags_t.get(callee, set()))
                        if self._is_device_fn(callee):
                            callee_tags.add("device_compute")
                        extra_tags = callee_tags - tags_t[qualname]
                        if extra_tags:
                            tags_t[qualname] |= extra_tags
                            changed = True

        edges: Dict[Tuple[str, str], Edge] = {}
        findings: List[common.Finding] = []
        unresolved = 0

        for qualname, summary in self.summaries.items():
            fn_path = qualname.split("::", 1)[0]
            unresolved += summary.unresolved_under_lock
            for held, lock_id, line in summary.acquisitions:
                for src in held:
                    if src != lock_id:
                        edges.setdefault(
                            (src, lock_id), Edge(src, lock_id, qualname, line)
                        )
            for held, callees, _, _, line in summary.calls:
                if not held:
                    continue
                for callee in callees:
                    for dst in locks_t.get(callee, ()):
                        for src in held:
                            if src != dst:
                                edges.setdefault(
                                    (src, dst), Edge(src, dst, qualname, line)
                                )
                    callee_tags = set(tags_t.get(callee, set()))
                    if self._is_device_fn(callee):
                        callee_tags.add("device_compute")
                    for tag in sorted(callee_tags):
                        self._hazard_findings(
                            findings, held, tag, f"call to {callee}", qualname,
                            fn_path, line,
                        )
            for held, tag, detail, line in summary.held_hazards:
                self._hazard_findings(
                    findings, held, tag, detail, qualname, fn_path, line
                )

        findings.extend(self._cycle_findings(list(edges.values())))
        # De-duplicate by key, keep first occurrence (stable order).
        seen: Set[str] = set()
        unique: List[common.Finding] = []
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.key)):
            if f.key not in seen:
                seen.add(f.key)
                unique.append(f)
        return LockOrderResult(
            sites=self.sites,
            edges=sorted(edges.values(), key=lambda e: (e.src, e.dst)),
            findings=unique,
            unresolved_calls=unresolved,
        )

    def _is_device_fn(self, qualname: str) -> bool:
        path = qualname.split("::", 1)[0].replace("\\", "/")
        return any(part in path for part in DEVICE_MODULE_PARTS)

    def _hazard_findings(
        self,
        findings: List[common.Finding],
        held: Tuple[str, ...],
        tag: str,
        detail: str,
        qualname: str,
        path: str,
        line: int,
    ) -> None:
        fn_name = qualname.split("::", 1)[1]
        for lock_id in held:
            if lock_id not in self.critical:
                continue
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="hazard-under-critical-lock",
                    key=f"{lock_id}->{tag}@{path}::{fn_name}",
                    message=(
                        f"{tag} ({detail}) while holding critical lock "
                        f"{lock_id} in {fn_name}"
                    ),
                    path=path,
                    line=line,
                )
            )

    def _cycle_findings(self, edges: List[Edge]) -> List[common.Finding]:
        graph: Dict[str, Set[str]] = {}
        for e in edges:
            graph.setdefault(e.src, set()).add(e.dst)
        # Tarjan SCC: any SCC with >1 node (or a self-loop) is a cycle.
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        sccs: List[List[str]] = []

        def strongconnect(v: str):
            # Iterative Tarjan to stay safe on deep graphs.
            work = [(v, iter(sorted(graph.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph.get(w, ())))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)

        findings = []
        edge_set = {(e.src, e.dst) for e in edges}
        by_pair = {(e.src, e.dst): e for e in edges}
        for scc in sccs:
            is_cycle = len(scc) > 1 or (scc[0], scc[0]) in edge_set
            if not is_cycle:
                continue
            nodes = sorted(scc)
            witness = next(
                (by_pair[(a, b)] for a in nodes for b in nodes
                 if (a, b) in by_pair),
                None,
            )
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="lock-cycle",
                    key="cycle:" + "->".join(nodes),
                    message=(
                        "lock acquisition cycle between "
                        + ", ".join(nodes)
                        + (f" (e.g. via {witness.via})" if witness else "")
                    ),
                    path=witness.via.split("::", 1)[0] if witness else "",
                    line=witness.line if witness else 0,
                )
            )
        return findings


def run(
    project: common.Project,
    critical_locks: Sequence[str] = DEFAULT_CRITICAL_LOCKS,
) -> LockOrderResult:
    return LockOrderAnalyzer(project, critical_locks=critical_locks).run()
