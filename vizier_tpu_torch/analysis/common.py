"""Shared infrastructure for the static-analysis passes.

The port's copy of the JAX package's ``analysis/common.py``; its one change
is that a container method name (``clear``, ``get``, ...) on a receiver that
is neither typed nor an imported module is not resolved by name. Everything here
is stdlib-only (``ast`` + dataclasses): the analysis suite must run in any
environment that can parse the tree, the card's machine included. The central object is :class:`Project` — a parsed-AST index
over a set of Python files with just enough *lightweight* type inference
to resolve ``obj.method()`` calls across modules:

- every class definition, its bases and its methods;
- per-class attribute types, inferred from ``self.x = SomeClass(...)``,
  ``self.x = typed_param`` and annotated assignments;
- per-function local-variable types from parameter annotations and
  assignments (``x = SomeClass(...)``, ``x = self.typed_attr``,
  ``x = getattr(obj, "literal")``).

Resolution is deliberately conservative: an unresolvable call is simply
not followed (passes may count them), never guessed. Precision comes from
the codebase's own discipline — constructor injection and annotated
parameters — which is exactly what the passes are meant to protect.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


# Methods of the builtin containers (and of ``threading.Event``): a call of
# one on a receiver whose type is unknown is not matched to a module-level
# function by its name alone.
_CONTAINER_METHODS = frozenset({
    "add", "append", "clear", "copy", "count", "discard", "extend", "get",
    "index", "insert", "items", "keys", "pop", "popitem", "remove", "set",
    "setdefault", "sort", "update", "values",
})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation reported by a pass.

    ``key`` is the stable identity used for baseline matching: it is built
    from qualified names (never line numbers), so ordinary edits do not
    churn the baseline.
    """

    pass_name: str
    rule: str
    key: str
    message: str
    path: str
    line: int

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}/{self.rule}] {self.message}"


@dataclasses.dataclass
class FunctionInfo:
    """One function or method definition."""

    qualname: str  # "module/path.py::Class.method" or "module/path.py::func"
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    path: str
    class_name: Optional[str] = None


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    path: str
    bases: List[str] = dataclasses.field(default_factory=list)
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # attr name -> inferred class name (project classes only)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


def iter_python_files(roots: Sequence[str]) -> List[str]:
    """All .py files under ``roots`` (files accepted verbatim), sorted."""
    out: Set[str] = set()
    for root in roots:
        if os.path.isfile(root) and root.endswith(".py"):
            out.add(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.add(os.path.join(dirpath, fn))
    return sorted(out)


def _annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    """The class name an annotation refers to, unwrapping Optional/quotes."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.Subscript):
        # Optional[X] / List[X] / "collections.OrderedDict[str, X]": take the
        # innermost project-class-looking name on a best-effort basis.
        inner = node.slice
        if isinstance(inner, ast.Tuple):
            for elt in reversed(inner.elts):
                name = _annotation_class(elt)
                if name is not None:
                    return name
            return None
        return _annotation_class(inner)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _tail_name(node: ast.AST) -> Optional[str]:
    """The final identifier of a Name/Attribute chain (``a.b.C`` -> ``C``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string, or None for non-trivial expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Project:
    """Parsed-AST index with lightweight cross-module type resolution."""

    def __init__(self, roots: Sequence[str], rel_to: Optional[str] = None):
        self.rel_to = rel_to or os.getcwd()
        self.trees: Dict[str, ast.Module] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}  # qualname -> info
        self.module_functions: Dict[str, Dict[str, FunctionInfo]] = {}
        self.subclasses: Dict[str, Set[str]] = {}
        # path -> names the module binds by import.
        self.imported: Dict[str, Set[str]] = {}
        self.parse_errors: List[Tuple[str, str]] = []
        for abspath in iter_python_files(roots):
            rel = os.path.relpath(abspath, self.rel_to)
            try:
                with open(abspath, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=rel)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                self.parse_errors.append((rel, str(e)))
                continue
            self.trees[rel] = tree
            self._index_module(rel, tree)
        self._infer_attr_types()
        self._build_subclasses()

    # -- indexing -----------------------------------------------------------

    def _index_module(self, path: str, tree: ast.Module) -> None:
        self.imported[path] = {
            (alias.asname or alias.name).split(".")[0]
            for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for alias in node.names
        }
        mod_funcs: Dict[str, FunctionInfo] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(
                    qualname=f"{path}::{node.name}",
                    name=node.name,
                    node=node,
                    path=path,
                )
                mod_funcs[node.name] = info
                self.functions[info.qualname] = info
            elif isinstance(node, ast.ClassDef):
                cls = ClassInfo(name=node.name, node=node, path=path)
                for base in node.bases:
                    base_name = _tail_name(base)
                    if base_name is not None:
                        cls.bases.append(base_name)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info = FunctionInfo(
                            qualname=f"{path}::{node.name}.{item.name}",
                            name=item.name,
                            node=item,
                            path=path,
                            class_name=node.name,
                        )
                        cls.methods[item.name] = info
                        self.functions[info.qualname] = info
                # Last definition of a class name wins (names are unique in
                # this tree; fixtures keep their own Project instances).
                self.classes[node.name] = cls
        self.module_functions[path] = mod_funcs

    def _build_subclasses(self) -> None:
        for cls in self.classes.values():
            for base in cls.bases:
                if base in self.classes:
                    self.subclasses.setdefault(base, set()).add(cls.name)

    def _infer_attr_types(self) -> None:
        for cls in self.classes.values():
            # Class-level annotated attributes.
            for item in cls.node.body:
                if isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name
                ):
                    ann = _annotation_class(item.annotation)
                    if ann in self.classes:
                        cls.attr_types[item.target.id] = ann
            for method in cls.methods.values():
                params = self._param_types(method.node)
                for stmt in ast.walk(method.node):
                    target: Optional[str] = None
                    value: Optional[ast.AST] = None
                    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                        target = self._self_attr(stmt.targets[0])
                        value = stmt.value
                    elif isinstance(stmt, ast.AnnAssign):
                        target = self._self_attr(stmt.target)
                        ann = _annotation_class(stmt.annotation)
                        if target is not None and ann in self.classes:
                            cls.attr_types.setdefault(target, ann)
                            continue
                        value = stmt.value
                    if target is None or value is None:
                        continue
                    inferred = self._expr_class(value, params, cls)
                    if inferred is not None:
                        cls.attr_types.setdefault(target, inferred)

    @staticmethod
    def _self_attr(node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _param_types(self, fn_node: ast.AST) -> Dict[str, str]:
        out: Dict[str, str] = {}
        args = fn_node.args
        for arg in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            ann = _annotation_class(arg.annotation)
            if ann in self.classes:
                out[arg.arg] = ann
        return out

    def _expr_class(
        self,
        node: ast.AST,
        local_types: Dict[str, str],
        cls: Optional[ClassInfo],
    ) -> Optional[str]:
        """The project class an expression evaluates to, if inferable."""
        if isinstance(node, ast.Call):
            # getattr(obj, "literal"[, default]) reads an attribute.
            if (
                isinstance(node.func, ast.Name)
                and node.func.id == "getattr"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                owner = self._expr_class(node.args[0], local_types, cls)
                if owner is not None:
                    return self.classes[owner].attr_types.get(node.args[1].value)
                return None
            callee = _tail_name(node.func)
            if callee in self.classes:
                return callee
            # Annotated return type of a resolvable method call
            # (e.g. registry.counter(...) -> Counter).
            if isinstance(node.func, ast.Attribute):
                owner = self._expr_class(node.func.value, local_types, cls)
                if owner is not None:
                    method = self._lookup_method(owner, node.func.attr)
                    if method is not None:
                        ret = _annotation_class(
                            getattr(method.node, "returns", None)
                        )
                        if ret in self.classes:
                            return ret
                    elif node.func.attr in ("get", "pop", "setdefault"):
                        # Container-of-X convention: dict-style access on a
                        # container typed by its element class yields X
                        # (the class defines no such method itself).
                        return owner
            return None
        if isinstance(node, ast.Subscript):
            # Container-of-X convention: a dict/list attr typed as X (via
            # Dict[str, X] annotations or comprehension values) yields X
            # when subscripted.
            return self._expr_class(node.value, local_types, cls)
        if isinstance(node, ast.DictComp):
            return self._expr_class(node.value, local_types, cls)
        if isinstance(node, (ast.ListComp, ast.SetComp)):
            return self._expr_class(node.elt, local_types, cls)
        if isinstance(node, ast.Name):
            if node.id == "self" and cls is not None:
                return cls.name
            return local_types.get(node.id)
        if isinstance(node, ast.Attribute):
            owner = self._expr_class(node.value, local_types, cls)
            if owner is not None:
                return self.classes[owner].attr_types.get(node.attr)
            return None
        if isinstance(node, ast.IfExp):
            return self._expr_class(
                node.body, local_types, cls
            ) or self._expr_class(node.orelse, local_types, cls)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                got = self._expr_class(v, local_types, cls)
                if got is not None:
                    return got
        return None

    # -- per-function local type environments -------------------------------

    def local_types(self, fn: FunctionInfo) -> Dict[str, str]:
        """Variable name -> project class, for ``fn``'s body."""
        cls = self.classes.get(fn.class_name) if fn.class_name else None
        env = self._param_types(fn.node)
        # Two sweeps so a name assigned before its source attr was seen
        # still resolves (assignment order in a straight-line body).
        for _ in range(2):
            for stmt in ast.walk(fn.node):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt = stmt.targets[0]
                    if isinstance(tgt, ast.Name):
                        inferred = self._expr_class(stmt.value, env, cls)
                        if inferred is not None:
                            env[tgt.id] = inferred
                elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    ann = _annotation_class(stmt.annotation)
                    if ann in self.classes:
                        env[stmt.target.id] = ann
        return env

    # -- call resolution -----------------------------------------------------

    def _lookup_method(self, class_name: str, meth: str) -> Optional[FunctionInfo]:
        seen: Set[str] = set()
        queue = [class_name]
        while queue:
            name = queue.pop(0)
            if name in seen or name not in self.classes:
                continue
            seen.add(name)
            cls = self.classes[name]
            if meth in cls.methods:
                return cls.methods[meth]
            queue.extend(cls.bases)
        return None

    def _method_candidates(self, class_name: str, meth: str) -> List[FunctionInfo]:
        """``cls.meth`` plus overrides in project subclasses (ABC dispatch)."""
        out: List[FunctionInfo] = []
        base = self._lookup_method(class_name, meth)
        if base is not None:
            out.append(base)
        for sub in sorted(self._all_subclasses(class_name)):
            sub_cls = self.classes.get(sub)
            if sub_cls is not None and meth in sub_cls.methods:
                info = sub_cls.methods[meth]
                if info not in out:
                    out.append(info)
        return out

    def _all_subclasses(self, class_name: str) -> Set[str]:
        out: Set[str] = set()
        queue = list(self.subclasses.get(class_name, ()))
        while queue:
            name = queue.pop()
            if name in out:
                continue
            out.add(name)
            queue.extend(self.subclasses.get(name, ()))
        return out

    def resolve_call(
        self,
        call: ast.Call,
        fn: FunctionInfo,
        local_types: Dict[str, str],
    ) -> List[FunctionInfo]:
        """Project functions a call may dispatch to ([] when unresolvable)."""
        func = call.func
        cls = self.classes.get(fn.class_name) if fn.class_name else None
        if isinstance(func, ast.Name):
            # Constructor or module-level function in the same module.
            if func.id in self.classes:
                ctor = self._lookup_method(func.id, "__init__")
                return [ctor] if ctor is not None else []
            local = self.module_functions.get(fn.path, {}).get(func.id)
            return [local] if local is not None else []
        if isinstance(func, ast.Attribute):
            meth = func.attr
            # self.meth() / typed_receiver.meth()
            owner = self._expr_class(func.value, local_types, cls)
            if owner is not None:
                candidates = self._method_candidates(owner, meth)
                if candidates:
                    return candidates
            # module_alias.func() / module_alias.Class() — match by tail name
            # against project classes, then module-level functions anywhere
            # with a unique name.
            if meth in self.classes:
                ctor = self._lookup_method(meth, "__init__")
                return [ctor] if ctor is not None else []
            if meth in _CONTAINER_METHODS and not (
                isinstance(func.value, ast.Name)
                and func.value.id in self.imported.get(fn.path, ())
            ):
                # ``self._entries.clear()`` is a dict, list or set method far
                # more often than a same-named module function (the port's
                # ``optimizers/graphs.py::clear``); ``registry.get(...)`` on
                # an imported module still resolves by name.
                return []
            matches = [
                funcs[meth]
                for funcs in self.module_functions.values()
                if meth in funcs
            ]
            if len(matches) == 1:
                return matches
        return []
