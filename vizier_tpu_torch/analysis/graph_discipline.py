"""Pass 2: CUDA-graph capture discipline in capture-reachable code.

The port's counterpart of the JAX package's ``analysis/jax_discipline.py``.
A captured CUDA graph replays the launches its function made while it was
captured, so that function must read nothing back to the host and take no
Python branch on a tensor's value: either fails the capture, or bakes one
call's value into every replay. This pass finds the functions a capture
runs, plus everything reachable from them through the project call graph:

- the callable handed to ``capture(...)`` (``optimizers/graphs.py``): a
  lambda's resolvable callees, a function defined in the calling function,
  a module function or a method;
- the body of a ``with torch.cuda.graph(...)`` block, and its resolvable
  callees;

and flags, inside that set:

- **host syncs**: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` and ``bool()`` / ``float()`` / ``int()`` of
  a non-literal expression;
- **tensor branching**: a Python ``if`` / ``while`` whose condition reads a
  parameter of a root or a value produced by ``torch`` ops (shape / ndim /
  dtype / ``len`` and ``is None`` tests are static and exempt);

and, anywhere in the scanned tree, the one retrace hazard graphs have:

- **capture in a loop**: ``capture(...)``, ``torch.cuda.graph(...)``,
  ``CUDAGraph()`` or ``.capture_begin()`` inside a ``for`` / ``while``
  body, which captures a new graph on every iteration.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set

from vizier_tpu_torch.analysis import common

PASS_NAME = "graph_discipline"

_CAPTURE_TAIL = "capture"
_TORCH_VALUE_ROOTS = {"torch"}
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_LOOP_CAPTURE_TAILS = {"capture", "graph", "CUDAGraph", "capture_begin"}


@dataclasses.dataclass
class CaptureRoot:
    fn: common.FunctionInfo
    line: int


@dataclasses.dataclass
class GraphDisciplineResult:
    roots: List[CaptureRoot]
    captured: Set[str]  # qualnames
    findings: List[common.Finding]


def _param_names(fn_node: ast.AST) -> List[str]:
    args = fn_node.args
    return [a.arg for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)]


def _is_graph_block(item: ast.withitem) -> bool:
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    return (common.dotted(expr.func) or "").endswith("cuda.graph")


def _is_capture_call(call: ast.Call) -> bool:
    return common._tail_name(call.func) == _CAPTURE_TAIL and bool(call.args)


class GraphDisciplineAnalyzer:
    def __init__(self, project: common.Project):
        self.project = project
        self.roots: Dict[str, CaptureRoot] = {}
        self.findings: List[common.Finding] = []

    # -- root discovery -----------------------------------------------------

    def _discover_roots(self) -> None:
        for fn in list(self.project.functions.values()):
            local_types = self.project.local_types(fn)
            nested = {
                node.name: node
                for node in ast.walk(fn.node)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not fn.node
            }
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call) and _is_capture_call(node):
                    self._add_callable_root(node.args[0], fn, local_types, nested)
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_block(item) for item in node.items
                ):
                    block = ast.FunctionDef(
                        name=f"<graph@{node.lineno}>",
                        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                           kw_defaults=[], defaults=[]),
                        body=node.body, decorator_list=[], lineno=node.lineno,
                    )
                    self._add_root(self._pseudo(fn, block), node.lineno)

    def _pseudo(self, fn: common.FunctionInfo, node: ast.AST) -> common.FunctionInfo:
        return common.FunctionInfo(
            qualname=f"{fn.qualname}.<{node.name}>",
            name=node.name,
            node=node,
            path=fn.path,
            class_name=fn.class_name,
        )

    def _add_root(self, info: common.FunctionInfo, line: int) -> None:
        self.roots.setdefault(info.qualname, CaptureRoot(fn=info, line=line))

    def _add_callable_root(self, target, fn, local_types, nested) -> None:
        if isinstance(target, ast.Lambda):
            for sub in ast.walk(target.body):
                if isinstance(sub, ast.Call):
                    for callee in self.project.resolve_call(sub, fn, local_types):
                        self._add_root(callee, target.lineno)
            return
        if isinstance(target, ast.Name):
            if target.id in nested:
                self._add_root(self._pseudo(fn, nested[target.id]), target.lineno)
                return
            info = self.project.module_functions.get(fn.path, {}).get(target.id)
            if info is not None:
                self._add_root(info, target.lineno)
            return
        if isinstance(target, ast.Attribute):
            owner = self.project._expr_class(
                target.value,
                local_types,
                self.project.classes.get(fn.class_name) if fn.class_name else None,
            )
            if owner is not None:
                method = self.project._lookup_method(owner, target.attr)
                if method is not None:
                    self._add_root(method, target.lineno)

    # -- reachability --------------------------------------------------------

    def _function(self, qualname: str) -> Optional[common.FunctionInfo]:
        root = self.roots.get(qualname)
        return root.fn if root is not None else self.project.functions.get(qualname)

    def _captured_closure(self) -> Set[str]:
        captured: Set[str] = set(self.roots)
        queue = list(self.roots)
        while queue:
            fn = self._function(queue.pop())
            if fn is None:
                continue
            local_types = self.project.local_types(fn)
            for call in ast.walk(fn.node):
                if not isinstance(call, ast.Call):
                    continue
                for callee in self.project.resolve_call(call, fn, local_types):
                    if callee.qualname not in captured:
                        captured.add(callee.qualname)
                        queue.append(callee.qualname)
        return captured

    # -- checks inside captured functions ------------------------------------

    def _tainted_locals(self, fn: common.FunctionInfo) -> Set[str]:
        """Names assigned from torch computations in ``fn``'s body."""
        tainted: Set[str] = set()
        for _ in range(2):
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                names: List[str] = []
                if isinstance(tgt, ast.Name):
                    names = [tgt.id]
                elif isinstance(tgt, ast.Tuple):
                    names = [e.id for e in tgt.elts if isinstance(e, ast.Name)]
                if names and self._is_torch_valued(node.value, tainted):
                    tainted.update(names)
        return tainted

    @staticmethod
    def _is_torch_valued(node: ast.AST, tainted: Set[str]) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                dotted_name = common.dotted(sub.func)
                if dotted_name and dotted_name.split(".", 1)[0] in _TORCH_VALUE_ROOTS:
                    return True
            elif isinstance(sub, ast.Name) and sub.id in tainted:
                return True
        return False

    def _check_function(self, qualname: str) -> None:
        fn = self._function(qualname)
        if fn is None:
            return
        params: Set[str] = set()
        if qualname in self.roots:
            params = set(_param_names(fn.node))
            params.discard("self")
        tainted = self._tainted_locals(fn)
        imported = self.project.imported.get(fn.path, set())
        fn_label = qualname.split("::", 1)[1]
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                self._check_host_sync(node, fn, fn_label, imported)
            elif isinstance(node, (ast.If, ast.While)):
                bad = self._tensor_names_in_test(node.test, params, tainted)
                if bad:
                    self.findings.append(
                        common.Finding(
                            pass_name=PASS_NAME,
                            rule="tensor-branch",
                            key=f"tensor-branch@{fn.path}::{fn_label}:{sorted(bad)[0]}",
                            message=(
                                f"Python branch on tensor value(s) {sorted(bad)} "
                                f"inside captured {fn_label}; use torch.where"
                            ),
                            path=fn.path,
                            line=node.lineno,
                        )
                    )

    def _check_host_sync(
        self, call: ast.Call, fn: common.FunctionInfo, fn_label: str, imported: Set[str]
    ) -> None:
        func = call.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        dotted_name = common.dotted(func) or ""
        sync: Optional[str] = None
        if attr in _SYNC_METHODS and not call.args:
            sync = f".{attr}()"
        elif dotted_name.endswith("cuda.synchronize"):
            sync = "torch.cuda.synchronize"
        elif (
            isinstance(func, ast.Name)
            and func.id in ("bool", "float", "int")
            and call.args
            and not isinstance(call.args[0], ast.Constant)
            and not self._static_value(call.args[0])
            and self._reads_a_value(call.args[0], imported)
        ):
            sync = f"{func.id}()"
        if sync is not None:
            self.findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="host-sync-in-capture",
                    key=f"host-sync@{fn.path}::{fn_label}:{sync}",
                    message=(
                        f"host sync {sync} inside captured {fn_label} (fails "
                        "the capture, or freezes one call's value into every "
                        "replay)"
                    ),
                    path=fn.path,
                    line=call.lineno,
                )
            )

    @staticmethod
    def _reads_a_value(node: ast.AST, imported: Set[str]) -> bool:
        """True when the expression reads a variable (``float(x.sum())``);
        ``float(math.pi)`` reads an imported module's constant, not a value."""
        return any(
            isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) and sub.id not in imported
            for sub in ast.walk(node)
        )

    @staticmethod
    def _static_value(node: ast.AST) -> bool:
        """Expressions whose value does not change between replays."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim", "dtype", "device"):
                return True
            if isinstance(sub, ast.Call) and common._tail_name(sub.func) in ("len", "size", "dim"):
                return True
        return False

    def _tensor_names_in_test(self, test: ast.AST, params: Set[str], tainted: Set[str]) -> Set[str]:
        if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return set()
        if self._static_value(test):
            return set()
        bad: Set[str] = set()
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call):
                if common._tail_name(sub.func) in ("isinstance", "len", "hasattr", "getattr", "callable"):
                    return set()
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                if sub.id in params or sub.id in tainted:
                    bad.add(sub.id)
        return bad

    # -- capture in a loop ----------------------------------------------------

    def _check_loops(self) -> None:
        for qualname, fn in self.project.functions.items():
            in_loop: Set[int] = set()
            for node in ast.walk(fn.node):
                if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Call):
                            in_loop.add(id(sub))
            for call in ast.walk(fn.node):
                if not isinstance(call, ast.Call) or id(call) not in in_loop:
                    continue
                tail = common._tail_name(call.func)
                dotted_name = common.dotted(call.func) or ""
                if tail not in _LOOP_CAPTURE_TAILS:
                    continue
                if tail == "graph" and not dotted_name.endswith("cuda.graph"):
                    continue
                if tail == "capture" and not call.args:
                    continue
                fn_label = qualname.split("::", 1)[1]
                self.findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="capture-in-loop",
                        key=f"capture-in-loop@{fn.path}::{fn_label}:{tail}",
                        message=(
                            f"{tail}(...) inside a loop in {fn_label}: every "
                            "iteration captures a new graph; capture once per "
                            "layout and replay"
                        ),
                        path=fn.path,
                        line=call.lineno,
                    )
                )

    def run(self) -> GraphDisciplineResult:
        self._discover_roots()
        captured = self._captured_closure()
        for qualname in sorted(captured):
            self._check_function(qualname)
        self._check_loops()
        seen: Set[str] = set()
        unique: List[common.Finding] = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.key)):
            if f.key not in seen:
                seen.add(f.key)
                unique.append(f)
        return GraphDisciplineResult(
            roots=sorted(self.roots.values(), key=lambda r: r.fn.qualname),
            captured=captured,
            findings=unique,
        )


def run(project: common.Project) -> GraphDisciplineResult:
    return GraphDisciplineAnalyzer(project).run()
