"""The designer-compute program registry.

Counterpart of the JAX package's ``compute/registry.py``: one process-wide
table, indexed by kind (``get("gp_ucb_pe")``) and by designer type
(:func:`resolve` walks ``type(designer).__mro__`` to the most-derived class
with registered programs and returns the first program whose ``bucket_key``
accepts the designer's current state: the exact program declines a study the
surrogate auto-switch has flipped sparse, and the sparse program takes it).

A designer exposing ``compute_program(count) -> (program, key) | None``
overrides resolution (wrappers, fault injection in tests). Registration
happens when a designer module is imported.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from vizier_tpu_torch.compute import ir

_LOCK = threading.Lock()
_BY_KIND: Dict[str, ir.DesignerProgram] = {}
_BY_TYPE: Dict[type, List[ir.DesignerProgram]] = {}


def register(designer_type: type, program: ir.DesignerProgram) -> ir.DesignerProgram:
    """Adds ``program`` for designers of ``designer_type`` (re-registering
    the same kind replaces it)."""
    if not program.kind:
        raise ValueError(f"{type(program).__name__} must declare a kind.")
    with _LOCK:
        if program.kind in _BY_KIND:
            for programs in _BY_TYPE.values():
                programs[:] = [p for p in programs if p.kind != program.kind]
        _BY_KIND[program.kind] = program
        _BY_TYPE.setdefault(designer_type, []).append(program)
    return program


def get(kind: str) -> Optional[ir.DesignerProgram]:
    with _LOCK:
        return _BY_KIND.get(kind)


def kinds() -> Tuple[str, ...]:
    """Registered program kinds, sorted."""
    _ensure_builtin_programs()
    with _LOCK:
        return tuple(sorted(_BY_KIND))


def programs() -> Tuple[ir.DesignerProgram, ...]:
    _ensure_builtin_programs()
    with _LOCK:
        return tuple(_BY_KIND[k] for k in sorted(_BY_KIND))


def programs_for_algorithm(algorithm: str) -> Tuple[ir.DesignerProgram, ...]:
    """Programs that serve studies of ``algorithm``."""
    return tuple(p for p in programs() if p.matches_algorithm(algorithm))


def _ensure_builtin_programs() -> None:
    """Imports the port's designer modules so their programs are present."""
    import vizier_tpu_torch.designers.gp_bandit  # noqa: F401  (registers on import)
    import vizier_tpu_torch.designers.gp_ucb_pe  # noqa: F401


def resolve(
    designer: Any, count: Optional[int] = None
) -> Optional[Tuple[ir.DesignerProgram, ir.BucketKey]]:
    """The designer's program + bucket key for this compute, or None.

    Order: the designer's own ``compute_program`` hook, then the
    most-derived registered designer type's programs in registration order
    (first non-None ``bucket_key`` wins). None means unbatchable: the caller
    runs the plain sequential ``suggest``.
    """
    count = count or 1
    hook = getattr(designer, "compute_program", None)
    if hook is not None:
        return hook(count)
    with _LOCK:
        type_programs = None
        for cls in type(designer).__mro__:
            found = _BY_TYPE.get(cls)
            if found:
                type_programs = list(found)
                break
    if type_programs is None:
        return None
    for program in type_programs:
        key = program.bucket_key(designer, count)
        if key is not None:
            return program, key
    return None
