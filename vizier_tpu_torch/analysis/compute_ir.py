"""Pass 5: compute-IR conformance — every registered DesignerProgram is a
full citizen of the serving stack.

The port's copy of the JAX package's ``analysis/compute_ir.py``.

The batched designer-compute IR (:mod:`vizier_tpu_torch.compute`) only pays off
if every registered program actually carries the cross-cutting features
the seam promises. This pass AST-scans the configured paths for
``compute`` registry ``register(DesignerType, Program())`` sites and fails
on:

- ``unresolvable-program-class`` — a registration whose program class
  definition the scan cannot find (dynamic construction hides the
  contract from every other rule);
- ``program-missing-hook`` — the class (or a scanned non-ABC base) does
  not define one of the four IR hooks (``bucket_key`` / ``prepare`` /
  ``device_program`` / ``finalize``); the abstract definitions on
  ``DesignerProgram`` itself do not count;
- ``program-missing-prewarm-coverage`` — no ``prewarm_factory``
  implementation: the program would be invisible to the prewarm walker
  and a bucket's first flush pays for its CUDA-graph captures;
- ``program-missing-kind`` / ``program-missing-device-phase`` — the
  ``kind`` / ``device_phase`` class attributes are absent or not string
  literals, so registry lookup / ``vizier_jax_phase_seconds`` tracing
  cannot name the program (the port keeps the JAX histogram's name);
- ``program-missing-shard-axis`` — no literal ``shardable_batch_axis``
  declaration: the mesh execution plane (``parallel.mesh``) needs every
  program to state explicitly whether its ``device_program`` may be
  sharded over a device placement (``"study"`` for the stacked
  leading-axis programs, ``""`` for an unshardable one) — an inherited
  silent default would let a program that never audited its batch axis
  ride the single-device path forever, or worse, a copied program claim
  shardability it never implements;
- ``missing-chaos-program-hook`` — ``vizier_tpu_torch/testing/chaos.py`` no
  longer defines the generic ``ChaosProgram`` wrapper (the IR-level chaos
  slot-isolation seam) with the per-slot and device hooks;
- ``program-missing-chaos-coverage`` — the program's ``kind`` literal
  appears in no test file that exercises the chaos harness: a program
  nobody chaos-tests has unproven slot isolation. (Like the env pass's
  doc rule, this reads ``tests/`` directly — the suite's scan roots stay
  production code.)
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from vizier_tpu_torch.analysis import common

PASS_NAME = "compute_ir"

REQUIRED_HOOKS = ("bucket_key", "prepare", "device_program", "finalize")

# The abstract contract class: its (abstract) hook defs never count as
# implementations, and it is skipped when walking scanned bases.
_ABC_NAMES = ("DesignerProgram",)

_CHAOS_MODULE = os.path.join("vizier_tpu_torch", "testing", "chaos.py")
_CHAOS_WRAPPER = "ChaosProgram"
_CHAOS_HOOKS = ("prepare", "device_program", "finalize")


@dataclasses.dataclass(frozen=True)
class RegisteredProgram:
    """One ``register(DesignerType, ProgramClass())`` site."""

    designer_type: str
    program_class: str
    kind: Optional[str]  # the class's literal kind, if resolvable
    path: str
    line: int


@dataclasses.dataclass
class ComputeIrResult:
    findings: List[common.Finding]
    registered: List[RegisteredProgram] = dataclasses.field(
        default_factory=list
    )


def _is_registry_register(call: ast.Call, path_imports: Set[str]) -> bool:
    """Whether ``call`` is a compute-registry ``register(...)`` call."""
    name = common.dotted(call.func)
    if name is None or not name.endswith("register"):
        return False
    # compute_registry.register(...) / registry.register(...) where the
    # module was imported from vizier_tpu_torch.compute.
    parts = name.split(".")
    if len(parts) != 2:
        return False
    return parts[0] in path_imports and len(call.args) >= 2


def _compute_registry_aliases(tree: ast.Module) -> Set[str]:
    """Local names bound to ``vizier_tpu_torch.compute.registry`` in a module."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for alias in node.names:
                if module == "vizier_tpu_torch.compute" and alias.name == "registry":
                    aliases.add(alias.asname or alias.name)
                elif module == "vizier_tpu_torch.compute.registry":
                    continue  # from-imports of members, not the module
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "vizier_tpu_torch.compute.registry":
                    aliases.add(
                        alias.asname or "vizier_tpu_torch.compute.registry"
                    )
    return aliases


def _class_attr_literal(cls: ast.ClassDef, attr: str) -> Optional[str]:
    """The string literal bound to a class attribute, or None."""
    for item in cls.body:
        targets = []
        value = None
        if isinstance(item, ast.Assign):
            targets = [
                t.id for t in item.targets if isinstance(t, ast.Name)
            ]
            value = item.value
        elif isinstance(item, ast.AnnAssign) and isinstance(
            item.target, ast.Name
        ):
            targets = [item.target.id]
            value = item.value
        if attr in targets and isinstance(value, ast.Constant):
            if isinstance(value.value, str):
                return value.value
    return None


def _methods_with_bases(
    project: common.Project, class_name: str
) -> Dict[str, common.FunctionInfo]:
    """Methods defined on ``class_name`` or scanned non-ABC bases."""
    out: Dict[str, common.FunctionInfo] = {}
    seen: Set[str] = set()
    stack = [class_name]
    while stack:
        name = stack.pop()
        if name in seen or name in _ABC_NAMES:
            continue
        seen.add(name)
        info = project.classes.get(name)
        if info is None:
            continue
        for method, finfo in info.methods.items():
            out.setdefault(method, finfo)
        stack.extend(info.bases)
    return out


def _inherited_attr_literal(
    project: common.Project, class_name: str, attr: str
) -> Optional[str]:
    seen: Set[str] = set()
    stack = [class_name]
    while stack:
        name = stack.pop()
        if name in seen or name in _ABC_NAMES:
            continue
        seen.add(name)
        info = project.classes.get(name)
        if info is None:
            continue
        literal = _class_attr_literal(info.node, attr)
        if literal is not None:
            return literal
        stack.extend(info.bases)
    return None


def run(project: common.Project, repo_root: str) -> ComputeIrResult:
    findings: List[common.Finding] = []
    registered: List[RegisteredProgram] = []

    # 1. Registration sites.
    for path, tree in project.trees.items():
        aliases = _compute_registry_aliases(tree)
        if not aliases:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if not _is_registry_register(node, aliases):
                continue
            designer = common.dotted(node.args[0]) or "<dynamic>"
            program_arg = node.args[1]
            program_class: Optional[str] = None
            if isinstance(program_arg, ast.Call):
                program_class = common.dotted(program_arg.func)
            elif isinstance(program_arg, ast.Name):
                # register(T, PROGRAM_SINGLETON) — resolve via assignment?
                program_class = None
            if program_class is None:
                findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="unresolvable-program-class",
                        key=f"unresolvable-program-class@{path}:{designer}",
                        message=(
                            "compute-registry register() with a program "
                            "whose class the scan cannot resolve; register "
                            "a direct ProgramClass() instantiation"
                        ),
                        path=path,
                        line=node.lineno,
                    )
                )
                continue
            program_class = program_class.split(".")[-1]
            kind = _inherited_attr_literal(project, program_class, "kind")
            registered.append(
                RegisteredProgram(
                    designer_type=designer,
                    program_class=program_class,
                    kind=kind,
                    path=path,
                    line=node.lineno,
                )
            )

    # 2. Per-program contract checks.
    for reg in registered:
        info = project.classes.get(reg.program_class)
        if info is None:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="unresolvable-program-class",
                    key=f"unresolvable-program-class:{reg.program_class}",
                    message=(
                        f"registered program class {reg.program_class} has "
                        "no scanned definition"
                    ),
                    path=reg.path,
                    line=reg.line,
                )
            )
            continue
        methods = _methods_with_bases(project, reg.program_class)
        for hook in REQUIRED_HOOKS:
            if hook not in methods:
                findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="program-missing-hook",
                        key=f"program-missing-hook:{reg.program_class}.{hook}",
                        message=(
                            f"DesignerProgram {reg.program_class} does not "
                            f"implement the IR hook {hook}()"
                        ),
                        path=info.path,
                        line=info.node.lineno,
                    )
                )
        if "prewarm_factory" not in methods:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="program-missing-prewarm-coverage",
                    key=f"program-missing-prewarm-coverage:{reg.program_class}",
                    message=(
                        f"DesignerProgram {reg.program_class} has no "
                        "prewarm_factory — the prewarm walker cannot "
                        "cover it and a bucket's first flush pays for its "
                        "CUDA-graph captures"
                    ),
                    path=info.path,
                    line=info.node.lineno,
                )
            )
        if reg.kind is None:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="program-missing-kind",
                    key=f"program-missing-kind:{reg.program_class}",
                    message=(
                        f"DesignerProgram {reg.program_class} does not "
                        "declare a literal `kind` class attribute"
                    ),
                    path=info.path,
                    line=info.node.lineno,
                )
            )
        if _inherited_attr_literal(
            project, reg.program_class, "device_phase"
        ) is None:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="program-missing-device-phase",
                    key=f"program-missing-device-phase:{reg.program_class}",
                    message=(
                        f"DesignerProgram {reg.program_class} does not "
                        "declare a literal `device_phase` — its flushes "
                        "would be invisible to vizier_jax_phase_seconds"
                    ),
                    path=info.path,
                    line=info.node.lineno,
                )
            )
        if _inherited_attr_literal(
            project, reg.program_class, "shardable_batch_axis"
        ) is None:
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="program-missing-shard-axis",
                    key=f"program-missing-shard-axis:{reg.program_class}",
                    message=(
                        f"DesignerProgram {reg.program_class} does not "
                        "declare a literal `shardable_batch_axis` — the "
                        "mesh execution plane needs an explicit statement "
                        "of whether device_program may shard over a "
                        'placement ("study") or must stay single-device '
                        '("")'
                    ),
                    path=info.path,
                    line=info.node.lineno,
                )
            )

    # 3. The generic chaos hook must exist and cover the IR surface. Like
    # env_registry's registry-wide rules, the whole-tree checks only run
    # when the scan actually saw registrations — a partial scan (fixtures,
    # one subpackage) cannot judge tree-wide coverage.
    if not registered:
        return ComputeIrResult(findings=_dedupe(findings), registered=[])
    chaos_info = project.classes.get(_CHAOS_WRAPPER)
    chaos_path_ok = chaos_info is not None and chaos_info.path.replace(
        "\\", "/"
    ).endswith("testing/chaos.py")
    if not chaos_path_ok:
        findings.append(
            common.Finding(
                pass_name=PASS_NAME,
                rule="missing-chaos-program-hook",
                key="missing-chaos-program-hook",
                message=(
                    "vizier_tpu_torch/testing/chaos.py must define the generic "
                    f"{_CHAOS_WRAPPER} wrapper (IR-level chaos slot "
                    "isolation)"
                ),
                path=_CHAOS_MODULE.replace(os.sep, "/"),
                line=0,
            )
        )
    else:
        for hook in _CHAOS_HOOKS:
            if hook not in chaos_info.methods:
                findings.append(
                    common.Finding(
                        pass_name=PASS_NAME,
                        rule="missing-chaos-program-hook",
                        key=f"missing-chaos-program-hook:{hook}",
                        message=(
                            f"{_CHAOS_WRAPPER} does not wrap the IR hook "
                            f"{hook}()"
                        ),
                        path=chaos_info.path,
                        line=chaos_info.node.lineno,
                    )
                )

    # 4. Per-kind chaos coverage in tests/.
    chaos_texts: List[str] = []
    tests_root = os.path.join(repo_root, "tests")
    for dirpath, dirnames, filenames in os.walk(tests_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for filename in filenames:
            if not filename.endswith(".py"):
                continue
            try:
                with open(
                    os.path.join(dirpath, filename), "r", encoding="utf-8"
                ) as f:
                    text = f.read()
            except OSError:
                continue
            if any(
                marker in text
                for marker in (
                    "testing import chaos",
                    "testing.chaos",
                    "ChaosDesigner",
                    "ChaosProgram",
                    "ChaosMonkey",
                )
            ):
                chaos_texts.append(text)
    for reg in registered:
        if reg.kind is None:
            continue  # already reported above
        if not any(reg.kind in text for text in chaos_texts):
            findings.append(
                common.Finding(
                    pass_name=PASS_NAME,
                    rule="program-missing-chaos-coverage",
                    key=f"program-missing-chaos-coverage:{reg.kind}",
                    message=(
                        f"registered program kind {reg.kind!r} appears in "
                        "no chaos-exercising test under tests/ — its "
                        "slot-isolation contract is untested"
                    ),
                    path=reg.path,
                    line=reg.line,
                )
            )

    return ComputeIrResult(findings=_dedupe(findings), registered=registered)


def _dedupe(findings: List[common.Finding]) -> List[common.Finding]:
    seen: Set[str] = set()
    unique: List[common.Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.key)):
        if f.key not in seen:
            seen.add(f.key)
            unique.append(f)
    return unique
