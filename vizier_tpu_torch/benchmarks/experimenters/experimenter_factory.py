"""Experimenter factories: named benchmark construction.

Parity with
``vizier/_src/benchmarks/experimenters/experimenter_factory.py:44,110``:
``BBOBFactory``/``SingleObjectiveExperimenterFactory`` build (optionally
shifted/noised/discretized) objectives by name — the configuration unit
benchmark sweeps iterate over.

Copy of the JAX package's ``benchmarks/experimenters/experimenter_factory.py``, on the port's data model; numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base, wrappers
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob


@dataclasses.dataclass
class SingleObjectiveExperimenterFactory:
    """Builds a BBOB experimenter by name with standard wrappers."""

    name: str
    dim: int = 4
    shift: Optional[np.ndarray] = None
    noise_std: Optional[float] = None
    noise_type: Optional[str] = None  # BBOB-noisy zoo (wrappers.NOISE_TYPES)
    discrete_dict: Optional[dict] = None
    seed: int = 0

    def __call__(self) -> base.Experimenter:
        if self.name not in bbob.BBOB_FUNCTIONS:
            raise ValueError(
                f"Unknown BBOB function {self.name!r}; "
                f"choices: {sorted(bbob.BBOB_FUNCTIONS)}"
            )
        if self.noise_std is not None and self.noise_type is not None:
            raise ValueError("Pass noise_std OR noise_type, not both.")
        exptr: base.Experimenter = base.NumpyExperimenter(
            bbob.BBOB_FUNCTIONS[self.name], base.bbob_problem(self.dim)
        )
        if self.shift is not None:
            exptr = wrappers.ShiftingExperimenter(exptr, np.asarray(self.shift))
        if self.discrete_dict:
            exptr = wrappers.DiscretizingExperimenter(exptr, self.discrete_dict)
        if self.noise_std is not None:
            exptr = wrappers.NoisyExperimenter(
                exptr, noise_std=self.noise_std, seed=self.seed
            )
        elif self.noise_type is not None:
            # Reference factory parity (experimenter_factory.py:199-201):
            # the named BBOB-noisy model, case-insensitive.
            exptr = wrappers.NoisyExperimenter.from_type(
                exptr, self.noise_type.upper(), seed=self.seed
            )
        return exptr

    @property
    def description(self) -> str:
        parts = [f"{self.name}_{self.dim}d"]
        if self.shift is not None:
            parts.append("shifted")
        if self.noise_std:
            parts.append(f"noise{self.noise_std}")
        if self.noise_type:
            parts.append(self.noise_type.lower())
        return "_".join(parts)


def shifted_bbob_instance(
    fn_name: str, seed: int, dim: int = 20, shift_range: float = 2.0
) -> base.Experimenter:
    """THE pinned per-seed shifted BBOB instance the repo's evidence uses.

    One definition shared by ``parity_suite.py`` (the committed
    ``regret_report_r4.json``), the CI convergence gate
    (``tests/designers/test_convergence_gates.py::TestShifted20DGates``)
    and ``tools/budget_policy_ab.py`` — editing the recipe here moves all
    three together, so the gate can never silently diverge from the
    published evidence. Mirrors the reference factory's shift application
    (``experimenter_factory.py:151-153``): the optimum moves off the
    search-box center, so center-seeding cannot fake convergence.
    """
    shift = np.random.default_rng(1000 + seed).uniform(
        -shift_range, shift_range, size=dim
    )
    fn = bbob.BBOB_FUNCTIONS.get(fn_name) or bbob.EXTRA_FUNCTIONS.get(fn_name)
    if fn is None:
        valid = sorted(bbob.BBOB_FUNCTIONS) + sorted(bbob.EXTRA_FUNCTIONS)
        raise ValueError(f"Unknown function {fn_name!r}; choices: {valid}")
    return wrappers.ShiftingExperimenter(
        base.NumpyExperimenter(fn, base.bbob_problem(dim)),
        shift=shift,
    )
