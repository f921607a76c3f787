"""The batched designer-compute IR: one contract for every serving path.

Counterpart of the JAX package's ``compute/ir.py``. Every batchable designer
computation has the same anatomy:

- a **shape/static descriptor** (:class:`BucketKey`) that says which other
  studies' computations it can share a device program with;
- a **host-side encode** run on the submitting thread (trial → padded model
  data + the per-phase random seeds, no device work);
- a **device body** (multi-restart ARD train + the acquisition sweep) run
  once per bucket flush over a leading study axis;
- a **host-side decode/demux** that writes the designer's state transitions
  (warm ARD seed, cached posterior, counters) and decodes suggestions.

Programs register in :mod:`vizier_tpu_torch.compute.registry`; the batch
executor consumes them generically. A designer's sequential ``suggest`` runs
the same program on its study alone (:meth:`DesignerProgram.run_alone`), so
slot i of a flush computes what study i computes alone.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Hashable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Identity of one shape bucket: equal keys ⇒ batchable together.

    ``kind`` is the registered :class:`DesignerProgram` that executes the
    bucket's device body. ``statics`` carries the hashable static objects
    (model, optimizers, acquisition config, restart budget, …) so two studies
    share a bucket exactly when they share shape AND configuration.
    """

    kind: str  # registered program kind, e.g. "gp_bandit" | "gp_ucb_pe"
    pad_trials: int
    cont_width: int
    cat_width: int
    metric_count: int
    count: int  # suggestions per study
    statics: Tuple[Hashable, ...] = ()

    def label(self) -> str:
        """Low-cardinality metrics/tracing label (one per shape bucket)."""
        return (
            f"{self.kind}/t{self.pad_trials}/f{self.cont_width}"
            f"x{self.cat_width}/m{self.metric_count}/q{self.count}"
        )


class DesignerProgram(abc.ABC):
    """One batched designer computation, named by ``kind``.

    Programs are stateless singletons: all per-study state lives on the
    designer instance each hook receives (the ``prepare``/``finalize`` pair
    runs the state transitions the designer's sequential ``suggest``
    performs). ``device_program`` reads the shared statics from ``items[0]``:
    the bucket key guarantees every slot's statics are equal.
    """

    #: Unique registry key; also the BucketKey.kind this program emits.
    kind: str = ""
    #: ``device_timing.device_phase`` name a batched flush is timed under
    #: (``vizier_jax_phase_seconds{phase}``, the JAX package's histogram).
    device_phase: str = ""
    #: Name of the batch axis ``device_program`` may split over a mesh
    #: placement ("" = unshardable: the executor never passes a
    #: ``placement``). Every in-tree program stacks its items along a leading
    #: study axis and declares ``"study"``. Declared, not inferred, so the
    #: ``compute_ir`` analysis pass can check that each program made the call.
    shardable_batch_axis: str = ""
    #: Service algorithm names whose studies this program serves, and whose
    #: prewarm walks cover its buckets (``PythiaServicer.prewarm``).
    algorithms: Tuple[str, ...] = ()

    @abc.abstractmethod
    def bucket_key(self, designer: Any, count: int) -> Optional[BucketKey]:
        """This designer's shape bucket for a ``count``-suggestion compute,
        or None when the program does not cover its current state."""

    @abc.abstractmethod
    def prepare(self, designer: Any, count: int) -> dict:
        """Host-side encode on the submitting thread: padded model data and
        the per-phase seeds, drawn from the designer's seed stream in the
        sequential order. Issues no device work."""

    @abc.abstractmethod
    def device_program(
        self, items: Sequence[dict], pad_to: Optional[int] = None, placement: Any = None
    ) -> List[dict]:
        """The batched train + acquire body for a whole bucket: stacks the
        items along a leading study axis (padded to ``pad_to`` with copies of
        item 0), runs them as one batch, copies the results to the host once,
        and returns one output dict per item.

        ``placement`` (a ``parallel.mesh.DevicePlacement``) is passed only to
        a program that declares a ``shardable_batch_axis``: the program then
        splits the stacked items over the placement's devices
        (``batch_executor.place_batch``), one batch per device. The executor
        pads to a multiple of the placement's device count."""

    @abc.abstractmethod
    def finalize(self, designer: Any, item: dict, output: dict) -> List[Any]:
        """Host-side decode/demux on the waiting thread: the designer's
        sequential state writeback plus suggestion decode."""

    def prewarm_factory(self, problem: Any, **kwargs) -> Any:
        """A designer whose computations route to this program, for the
        prewarm walker (``BatchExecutor.prewarm``) to run synthetic studies
        through every padding bucket. A program that does not override it is
        not prewarmable (the ``compute_ir`` analysis pass requires it of
        every registered program)."""
        raise NotImplementedError(
            f"{type(self).__name__} is not prewarmable: it declares no prewarm_factory."
        )

    def run_alone(self, designer: Any, count: int) -> List[Any]:
        """The designer's study as a flush of one: its sequential suggest."""
        item = self.prepare(designer, count)
        (output,) = self.device_program([item])
        return self.finalize(designer, item, output)

    def matches_algorithm(self, algorithm: str) -> bool:
        """Whether this program serves studies of ``algorithm``."""
        return (algorithm or "").upper() in self.algorithms
