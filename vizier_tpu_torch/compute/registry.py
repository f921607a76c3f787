"""The designer-compute program registry.

Counterpart of the JAX package's ``compute/registry.py``: one process-wide
table, indexed by kind (``get("gp_ucb_pe")``) and by designer type
(:func:`resolve` walks ``type(designer).__mro__`` to the most-derived class
with registered programs and returns the first program whose ``bucket_key``
accepts the designer's current state: the exact program declines a study the
surrogate auto-switch has flipped sparse, and the sparse program takes it).

Wrappers and custom designers compose without registering:

- a designer exposing ``compute_program(count) -> (program, key) | None``
  overrides resolution (wrappers, fault injection in tests);
- a designer with only the duck-typed ``batch_*`` hooks (``batch_bucket_key``,
  ``batch_prepare``, ``batch_execute``, ``batch_finalize``) resolves to a
  :class:`DuckTypedProgram` adapter, so out-of-tree designers keep batching
  through the executor without a registry entry (they forgo prewarm).

Registration happens when a designer module is imported.
"""

from __future__ import annotations

import inspect
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


class DuckTypedProgram(ir.DesignerProgram):
    """Adapter over a designer's duck-typed ``batch_*`` hooks.

    Unregistered designers (test stubs, out-of-tree extensions) keep
    batching through the executor; the adapter is made per resolution so the
    bound designer's own hooks run, including any fault injection they carry.
    """

    surrogate_family = "exact"

    def __init__(self, kind: str, designer: Any):
        self.kind = kind
        self.device_phase = f"{kind}.suggest_batched"
        # The device body dispatches through the RESOLVED designer, not the
        # designer an item may record: a wrapper's ``batch_execute`` (a chaos
        # strike, say) stays on the dispatch path.
        self._designer = designer

    def bucket_key(self, designer, count):
        key_fn = getattr(designer, "batch_bucket_key", None)
        return key_fn(count) if key_fn is not None else None

    def prepare(self, designer, count):
        return designer.batch_prepare(count)

    def device_program(self, items, pad_to=None, placement=None):
        execute = self._designer.batch_execute
        if placement is not None and "placement" in inspect.signature(execute).parameters:
            return execute(items, pad_to=pad_to, placement=placement)
        return execute(items, pad_to=pad_to)

    def finalize(self, designer, item, output):
        return designer.batch_finalize(item, output)

    def prewarm_factory(self, problem, **kwargs):
        raise NotImplementedError(
            "Duck-typed designers are not prewarmable; register a "
            "DesignerProgram to join the prewarm walk."
        )


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
    (first non-None ``bucket_key`` wins), then the duck-typed ``batch_*``
    hooks. None means unbatchable: the caller runs the plain sequential
    ``suggest``.
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
    if type_programs is not None:
        for program in type_programs:
            key = program.bucket_key(designer, count)
            if key is not None:
                return program, key
        return None
    key_fn = getattr(designer, "batch_bucket_key", None)
    if key_fn is None:
        return None
    key = key_fn(count)
    if key is None:
        return None
    return DuckTypedProgram(key.kind, designer), key
