"""CMA-ES designer wrapping the external ``pycma`` package.

Copy of the JAX package's ``designers/pycmaes.py``. The self-contained
implementation lives in ``designers/cmaes.py``; this wrapper exists for
users who specifically want pycma's reference implementation (restart
heuristics, option surface). Only :meth:`suggest` imports ``cma`` —
construction, validation, and state handling are plain code and run (and
are tested) without the library through an injected module.

Protocol: features are scaled to the unit cube; labels are converted
maximization-signed and sign-flipped before feeding (pycma minimizes); the
resume feed truncates history to a multiple of the population size, as
``feed_for_resume`` requires.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class PyCMAESDesigner(core_lib.Designer):
    """CMA-ES via pycma over a flat all-continuous search space."""

    problem: base_study_config.ProblemStatement
    sigma0: float = 0.1
    popsize: Optional[int] = None

    def __post_init__(self):
        if self.popsize is not None and self.popsize < 2:
            raise ValueError(f"popsize must be at least 2, got {self.popsize}.")
        space = self.problem.search_space
        if space.is_conditional:
            raise ValueError("PyCMAESDesigner requires a flat search space.")
        if len(self.problem.metric_information) != 1:
            raise ValueError("PyCMAESDesigner works with exactly one metric.")
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem
        )
        enc = self._converter.encoder
        if enc.num_categorical:
            raise ValueError(
                "PyCMAESDesigner supports continuous parameters only."
            )
        # Start point: per-parameter default value when set, else the bounds
        # midpoint — NATIVE frame, then through the converter's own codecs
        # so scale types (LOG/REVERSE_LOG) land in the same unit-cube frame
        # as the resume-fed features.
        init_params = {}
        for pc_ in space.parameters:
            lo, hi = pc_.bounds
            init_params[pc_.name] = (
                pc_.default_value
                if pc_.default_value is not None
                else (lo + hi) / 2.0
            )
        cont, _ = self._converter.encoder.encode(
            [trial_.Trial(id=0, parameters=init_params)]
        )
        self._x0 = np.asarray(cont[0], dtype=np.float64)
        self._completed: List[trial_.Trial] = []

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        self._completed.extend(completed.trials)

    def _labels_for(self, trials: Sequence[trial_.Trial]) -> np.ndarray:
        """Maximization-signed labels, sign-flipped for pycma (minimizer)."""
        out = self._converter.metrics.encode(trials)[:, 0]
        return -np.asarray(out, dtype=np.float64)

    def suggest(
        self, count: Optional[int] = None
    ) -> List[trial_.TrialSuggestion]:
        try:
            import cma
        except ImportError as e:
            raise ImportError(
                "PyCMAESDesigner needs the external pycma package, which is not "
                "installed; use designers.cmaes.CMAESDesigner for the "
                "self-contained implementation."
            ) from e
        return self._suggest_with(cma, count)

    def _suggest_with(
        self, cma_module, count: Optional[int]
    ) -> List[trial_.TrialSuggestion]:
        """The full protocol against any module with pycma's surface."""
        count = count or 1
        options = {"bounds": [0.0, 1.0]}
        if self.popsize is not None:
            options["popsize"] = self.popsize
        evolution = cma_module.CMAEvolutionStrategy(
            self._x0, self.sigma0, options
        )
        # Infeasible / metric-missing trials encode to NaN labels, which
        # would poison pycma's covariance update — drop them before the
        # whole-generation truncation feed_for_resume requires.
        usable = (
            [
                t
                for t, label in zip(self._completed, self._labels_for(self._completed))
                if np.isfinite(label)
            ]
            if self._completed
            else []
        )
        feed_size = (len(usable) // evolution.popsize) * evolution.popsize
        if feed_size > 0:
            recent = usable[-feed_size:]
            features, _ = self._converter.encoder.encode(recent)
            evolution.feed_for_resume(
                np.asarray(features, dtype=np.float64),
                self._labels_for(recent),
            )
        asked = np.asarray(evolution.ask(count), dtype=np.float64)
        asked = np.clip(asked, 0.0, 1.0)
        empty_cat = np.zeros((len(asked), 0), dtype=np.int32)
        return [
            trial_.TrialSuggestion(parameters=params)
            for params in self._converter.to_parameters(asked, empty_cat)
        ]
