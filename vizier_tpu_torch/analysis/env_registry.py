"""Pass 3: every ``VIZIER_*`` environment read must be declared.

The port's copy of the JAX package's ``analysis/env_registry.py``. The
registry (:mod:`vizier_tpu_torch.analysis.registry`) is the single source of
truth for the port's environment switches. A literal that ends in ``_``
(``"VIZIER_TORCH_"``) is a prefix, not a name, and is not checked. This pass AST-scans the
configured paths and fails on:

- ``undeclared-env-read`` — ``os.environ.get/[]/setdefault`` or
  ``os.getenv`` of a literal ``VIZIER_*`` name missing from the registry;
- ``environ-read-of-constant`` — an env read of a name declared as a
  reserved *constant* (``VIZIER_METHODS`` / ``VIZIER_SERVICE_NAME`` are
  gRPC tables, not switches);
- ``dynamic-env-read`` — an ``os.environ`` read whose name is not a string
  literal. Only :mod:`vizier_tpu_torch.analysis.registry` itself may do this
  (its helpers validate names at runtime); ad-hoc ``_env_on(name)``
  helpers elsewhere hide reads from this scan and must go through the
  registry;
- ``undeclared-literal`` — any other ``VIZIER_*`` string literal not in
  the registry (catches reads routed through helpers and doc drift);
- ``undocumented-switch`` — a declared switch whose ``doc`` file is
  missing or never mentions the switch name;
- ``unreferenced-switch`` — a declared env switch no scanned file
  mentions (a stale declaration).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Set

from vizier_tpu_torch.analysis import common
from vizier_tpu_torch.analysis import registry

PASS_NAME = "env_registry"

_VIZIER_NAME = re.compile(r"^VIZIER_[A-Z0-9_]*[A-Z0-9]$")

# The registry module itself reads the environment with validated
# non-literal names; that is the one sanctioned dynamic read site.
_DYNAMIC_READ_ALLOWED = ("analysis/registry.py",)


@dataclasses.dataclass
class EnvRegistryResult:
    findings: List[common.Finding]
    # literal VIZIER_* name -> paths referencing it (for coverage checks)
    references: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)


def _env_read_name(call: ast.Call) -> Optional[ast.AST]:
    """The name expression of an env read call, or None if not one."""
    func = call.func
    dotted_name = common.dotted(func)
    if dotted_name in ("os.getenv",) and call.args:
        return call.args[0]
    if isinstance(func, ast.Attribute) and func.attr in ("get", "setdefault"):
        base = common.dotted(func.value)
        if base in ("os.environ", "environ") and call.args:
            return call.args[0]
    return None


def _environ_subscript(node: ast.Subscript) -> Optional[ast.AST]:
    base = common.dotted(node.value)
    if base in ("os.environ", "environ"):
        return node.slice
    return None


def run(
    project: common.Project,
    repo_root: str,
    check_registry_coverage: Optional[bool] = None,
) -> EnvRegistryResult:
    """Scans ``project`` for env-read violations.

    ``check_registry_coverage`` controls the registry-wide rules
    (undocumented-switch / unreferenced-switch); by default they run only
    when the scan actually includes the registry module — a partial scan
    (a fixtures directory, one subpackage) cannot judge whole-tree
    coverage.
    """
    if check_registry_coverage is None:
        check_registry_coverage = any(
            p.replace("\\", "/").endswith(_DYNAMIC_READ_ALLOWED[0])
            for p in project.trees
        )
    findings: List[common.Finding] = []
    references: Dict[str, Set[str]] = {}

    def check_read(name_node: ast.AST, path: str) -> None:
        if isinstance(name_node, ast.Constant) and isinstance(
            name_node.value, str
        ):
            name = name_node.value
            if not _VIZIER_NAME.match(name):
                return  # non-VIZIER env reads are out of scope
            switch = registry.BY_NAME.get(name)
            if switch is None:
                findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="undeclared-env-read",
                        key=f"undeclared-env-read:{name}@{path}",
                        message=(
                            f"environment read of undeclared switch {name}; "
                            "declare it in vizier_tpu_torch/analysis/registry.py"
                        ),
                        path=path,
                        line=name_node.lineno,
                    )
                )
            elif switch.kind == "constant":
                findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="environ-read-of-constant",
                        key=f"environ-read-of-constant:{name}@{path}",
                        message=(
                            f"{name} is a reserved constant "
                            f"(owner {switch.owner}), not an environment "
                            "switch; reading it from os.environ is a bug"
                        ),
                        path=path,
                        line=name_node.lineno,
                    )
                )
            return
        # Non-literal name.
        norm = path.replace("\\", "/")
        if any(norm.endswith(suffix) for suffix in _DYNAMIC_READ_ALLOWED):
            return
        findings.append(
            common.Finding(
                pass_name=PASS_NAME,
                rule="dynamic-env-read",
                key=f"dynamic-env-read@{path}:{getattr(name_node, 'lineno', 0)}",
                message=(
                    "os.environ read with a non-literal name; route it "
                    "through vizier_tpu_torch.analysis.registry helpers so the "
                    "switch is declared and validated"
                ),
                path=path,
                line=getattr(name_node, "lineno", 0),
            )
        )

    for path, tree in project.trees.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name_node = _env_read_name(node)
                if name_node is not None:
                    check_read(name_node, path)
            elif isinstance(node, ast.Subscript):
                name_node = _environ_subscript(node)
                if name_node is not None:
                    check_read(name_node, path)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                if _VIZIER_NAME.match(node.value):
                    references.setdefault(node.value, set()).add(path)
                    if node.value not in registry.BY_NAME:
                        findings.append(
                            common.Finding(
                                pass_name=PASS_NAME,
                                rule="undeclared-literal",
                                key=f"undeclared-literal:{node.value}@{path}",
                                message=(
                                    f"VIZIER_* literal {node.value!r} is not "
                                    "declared in the switch registry"
                                ),
                                path=path,
                                line=node.lineno,
                            )
                        )

    # Declared switches must be documented where they claim to be...
    for switch in registry.SWITCHES if check_registry_coverage else ():
        doc_path = os.path.join(repo_root, switch.doc)
        documented = False
        try:
            with open(doc_path, "r", encoding="utf-8") as f:
                documented = switch.name in f.read()
        except OSError:
            documented = False
        if not documented:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="undocumented-switch",
                    key=f"undocumented-switch:{switch.name}",
                    message=(
                        f"declared switch {switch.name} is not mentioned in "
                        f"its doc file {switch.doc}"
                    ),
                    path="vizier_tpu_torch/analysis/registry.py",
                    line=0,
                )
            )
        # ... and real env switches must actually be referenced somewhere
        # beyond their own registry declaration.
        outside_refs = {
            p
            for p in references.get(switch.name, ())
            if not p.replace("\\", "/").endswith(_DYNAMIC_READ_ALLOWED[0])
        }
        if switch.kind != "constant" and not outside_refs:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="unreferenced-switch",
                    key=f"unreferenced-switch:{switch.name}",
                    message=(
                        f"declared switch {switch.name} is never referenced "
                        "by any scanned file (stale declaration?)"
                    ),
                    path="vizier_tpu_torch/analysis/registry.py",
                    line=0,
                )
            )

    seen: Set[str] = set()
    unique: List[common.Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.key)):
        if f.key not in seen:
            seen.add(f.key)
            unique.append(f)
    return EnvRegistryResult(findings=unique, references=references)
