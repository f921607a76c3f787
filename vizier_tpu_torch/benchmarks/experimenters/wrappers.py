"""Experimenter wrappers: noise, shifting and discretizing.

Copy of the JAX package's ``benchmarks/experimenters/wrappers.py``, the
wrappers that ``SingleObjectiveExperimenterFactory`` builds (parity with the
reference's noisy_experimenter, shifting_experimenter and
discretizing_experimenter under ``vizier/_src/benchmarks/experimenters/``).
The sign-flip, normalizing, infeasible, sparse, permuting and switch
wrappers are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_


class _Wrapper(base.Experimenter):
    def __init__(self, exptr: base.Experimenter):
        self._exptr = exptr

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        self._exptr.evaluate(suggestions)

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._exptr.problem_statement()


# BBOB-noisy noise models (Hansen et al., "Real-Parameter Black-Box
# Optimization Benchmarking: Noisy Functions Definitions"). Constants match
# the reference's noise-type zoo (noisy_experimenter.py:74-199) so noise
# robustness experiments reproduce. Names are SEVERITY_FAMILY strings.
_LOGNORMAL_SIGMA = {"MODERATE": 0.01, "SEVERE": 0.1}
_UNIFORM_EXPONENT = {"MODERATE": 0.01, "SEVERE": 0.1}
_CAUCHY_STRENGTH_FREQ = {"MODERATE": (0.01, 0.05), "SEVERE": (0.1, 0.25)}
_ADDITIVE_STDDEV = {"LIGHT": 0.01, "MODERATE": 0.1, "SEVERE": 1.0}

NOISE_TYPES = (
    "NO_NOISE",
    "MODERATE_GAUSSIAN",
    "SEVERE_GAUSSIAN",
    "MODERATE_UNIFORM",
    "SEVERE_UNIFORM",
    "MODERATE_SELDOM_CAUCHY",
    "SEVERE_SELDOM_CAUCHY",
    "LIGHT_ADDITIVE_GAUSSIAN",
    "MODERATE_ADDITIVE_GAUSSIAN",
    "SEVERE_ADDITIVE_GAUSSIAN",
)


def make_noise_fn(
    noise_type: str,
    dimension: int,
    rng: np.random.Generator,
    target_value: float = 1e-8,
):
    """``float -> float`` noise model for one of :data:`NOISE_TYPES`.

    The multiplicative families (gaussian / uniform / seldom-cauchy) are
    stabilized: values below ``target_value`` (near the BBOB optimum) pass
    through unnoised, and noised values get a ``+1.01 * target_value``
    floor offset, per the BBOB-noisy post-processing. Additive-gaussian is
    plain ``v + N(0, σ)`` with no stabilization, matching the reference.
    """
    if noise_type not in NOISE_TYPES:
        raise ValueError(
            f"Unknown noise type {noise_type!r}; choices: {NOISE_TYPES}"
        )
    severity, _, family = noise_type.partition("_")

    if noise_type == "NO_NOISE":
        noise = lambda v: v
    elif family == "GAUSSIAN":
        sigma = _LOGNORMAL_SIGMA[severity]
        noise = lambda v: v * rng.lognormal(0.0, sigma)
    elif family == "UNIFORM":
        # Noise strength grows as the value approaches 0 (the optimum):
        # v · U^max(0,β) · max(1, (1e9 / (v + ε))^(α·U')).
        exponent = _UNIFORM_EXPONENT[severity]
        alpha = exponent * (0.49 + 1.0 / dimension)
        beta = exponent

        def noise(v, alpha=alpha, beta=beta):
            shrink = rng.uniform() ** max(0.0, beta)
            amplify = (1e9 / (v + 1e-99)) ** (alpha * rng.uniform())
            return v * shrink * max(1.0, amplify)

    elif family == "SELDOM_CAUCHY":
        # Infrequent heavy-tailed outliers: with probability p add
        # α · max(0, 1000 + cauchy()).
        strength, freq = _CAUCHY_STRENGTH_FREQ[severity]

        def noise(v, strength=strength, freq=freq):
            c = (rng.uniform() < freq) * rng.standard_cauchy()
            return v + strength * max(0.0, 1000.0 + c)

    else:  # ADDITIVE_GAUSSIAN, the only remaining family in NOISE_TYPES
        stddev = _ADDITIVE_STDDEV[severity]
        return lambda v: v + rng.normal(0.0, stddev)

    def stabilized(v):
        if v < target_value:
            return v
        return noise(v) + 1.01 * target_value

    return stabilized


class NoisyExperimenter(_Wrapper):
    """Applies a noise model to every metric after evaluation.

    The unnoised value is preserved as ``<metric>_before_noise`` (reference
    ``noisy_experimenter.py:60-69``). The default constructor is additive
    Gaussian with ``noise_std``; :meth:`from_type` builds the BBOB-noisy
    model zoo (uniform / seldom-cauchy / multiplicative-gaussian families).
    """

    def __init__(
        self,
        exptr: base.Experimenter,
        *,
        noise_std: float = 1.0,
        seed: Optional[int] = None,
        noise_fn=None,
    ):
        super().__init__(exptr)
        self._rng = np.random.default_rng(seed)
        if noise_fn is None:
            std = noise_std
            noise_fn = lambda v: v + self._rng.normal(0.0, std)
        self._noise_fn = noise_fn

    @classmethod
    def from_type(
        cls,
        exptr: base.Experimenter,
        noise_type: str,
        seed: Optional[int] = None,
    ) -> "NoisyExperimenter":
        """Builds the named BBOB-noisy model (reference ``from_type``).

        ``seed=None`` defaults to 0, matching the reference's
        ``np.random.default_rng(seed or 0)`` — default runs must be
        reproducible, not OS-entropy seeded.
        """
        dim = len(exptr.problem_statement().search_space.parameters)
        self = cls(exptr, seed=seed or 0)
        self._noise_fn = make_noise_fn(noise_type, dimension=dim, rng=self._rng)
        return self

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        self._exptr.evaluate(suggestions)
        for t in suggestions:
            if t.final_measurement is None:
                continue
            noisy: Dict[str, trial_.Metric] = {}
            for name, m in t.final_measurement.metrics.items():
                noisy[name] = trial_.Metric(float(self._noise_fn(m.value)))
                noisy[name + "_before_noise"] = m
            t.final_measurement = trial_.Measurement(
                metrics=noisy,
                elapsed_secs=t.final_measurement.elapsed_secs,
                steps=t.final_measurement.steps,
            )


class ShiftingExperimenter(_Wrapper):
    """Shifts the optimum: evaluates f(x - shift) with clipped bounds."""

    def __init__(self, exptr: base.Experimenter, shift: np.ndarray):
        super().__init__(exptr)
        self._shift = np.asarray(shift, dtype=np.float64)
        self._params = [
            p for p in exptr.problem_statement().search_space.parameters
        ]
        if len(self._shift) != len(self._params):
            raise ValueError(
                f"shift has {len(self._shift)} dims for {len(self._params)} parameters."
            )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        shifted = []
        for t in suggestions:
            params = trial_.ParameterDict()
            for p, s in zip(self._params, self._shift):
                lo, hi = p.bounds
                v = float(t.parameters.get_value(p.name)) - s
                params[p.name] = float(np.clip(v, lo, hi))
            shifted.append(trial_.Trial(id=t.id, parameters=params))
        self._exptr.evaluate(shifted)
        for orig, sh in zip(suggestions, shifted):
            orig.final_measurement = sh.final_measurement
            orig.infeasibility_reason = sh.infeasibility_reason
            orig.completion_time = sh.completion_time


class DiscretizingExperimenter(_Wrapper):
    """Restricts selected DOUBLE parameters to discrete feasible points."""

    def __init__(
        self,
        exptr: base.Experimenter,
        discretization: Dict[str, Sequence[float]],
    ):
        super().__init__(exptr)
        original = exptr.problem_statement()
        space = pc.SearchSpace()
        for p in original.search_space.parameters:
            if p.name in discretization:
                space.root.add_discrete_param(
                    p.name, list(discretization[p.name]), auto_cast=False
                )
            else:
                space.parameters = space.parameters + [p]
        self._problem = base_study_config.ProblemStatement(
            search_space=space,
            metric_information=original.metric_information,
            metadata=original.metadata,
        )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem
