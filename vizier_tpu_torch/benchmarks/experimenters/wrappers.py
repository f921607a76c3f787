"""Experimenter wrappers: noise, shifting, discretizing, sign-flip, etc.

Copy of the JAX package's ``benchmarks/experimenters/wrappers.py``, every
wrapper of it (parity with the reference wrapper experimenters under
``vizier/_src/benchmarks/experimenters/``: noisy_experimenter,
shifting_experimenter, discretizing_experimenter, normalizing_experimenter,
sign_flip_experimenter, infeasible_experimenter, permuting_experimenter,
sparse_experimenter and switch_experimenter). All of it is host numpy: the
same seed and the same trials give the same floats as the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

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


class SignFlipExperimenter(_Wrapper):
    """Negates metrics and flips goals (MINIMIZE ⇄ MAXIMIZE)."""

    def __init__(self, exptr: base.Experimenter):
        super().__init__(exptr)
        original = exptr.problem_statement()
        self._problem = base_study_config.ProblemStatement(
            search_space=original.search_space,
            metric_information=base_study_config.MetricsConfig(
                [m.flip_goal() for m in original.metric_information]
            ),
            metadata=original.metadata,
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        self._exptr.evaluate(suggestions)
        for t in suggestions:
            if t.final_measurement is None:
                continue
            t.final_measurement = trial_.Measurement(
                metrics={
                    name: trial_.Metric(-m.value)
                    for name, m in t.final_measurement.metrics.items()
                },
                elapsed_secs=t.final_measurement.elapsed_secs,
                steps=t.final_measurement.steps,
            )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return self._problem


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


class NormalizingExperimenter(_Wrapper):
    """Normalizes metrics by |f| statistics sampled on a random grid."""

    def __init__(self, exptr: base.Experimenter, *, num_samples: int = 100, seed: int = 0):
        super().__init__(exptr)
        problem = exptr.problem_statement()
        rng = np.random.default_rng(seed)
        from vizier_tpu_torch.designers import random as random_designer

        probes = []
        for _ in range(num_samples):
            params = random_designer.sample_point(problem.search_space, rng)
            probes.append(trial_.Trial(parameters=params))
        exptr.evaluate(probes)
        names = [m.name for m in problem.metric_information]
        self._scale = {}
        for name in names:
            vals = [
                t.final_measurement.metrics[name].value
                for t in probes
                if t.final_measurement is not None and name in t.final_measurement.metrics
            ]
            std = float(np.std(vals)) if vals else 1.0
            self._scale[name] = std if std > 1e-12 else 1.0

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        self._exptr.evaluate(suggestions)
        for t in suggestions:
            if t.final_measurement is None:
                continue
            t.final_measurement = trial_.Measurement(
                metrics={
                    name: trial_.Metric(m.value / self._scale.get(name, 1.0))
                    for name, m in t.final_measurement.metrics.items()
                },
                elapsed_secs=t.final_measurement.elapsed_secs,
                steps=t.final_measurement.steps,
            )


class InfeasibleExperimenter(_Wrapper):
    """Marks a random fraction of evaluations infeasible."""

    def __init__(
        self, exptr: base.Experimenter, *, infeasible_prob: float = 0.1, seed: int = 0
    ):
        super().__init__(exptr)
        self._prob = infeasible_prob
        self._rng = np.random.default_rng(seed)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        self._exptr.evaluate(suggestions)
        for t in suggestions:
            if self._rng.uniform() < self._prob:
                t.final_measurement = None
                t.infeasibility_reason = "Randomly infeasible (benchmark wrapper)."


class SparseExperimenter(_Wrapper):
    """Expands the search space with placeholder parameters that do nothing.

    Reference ``SparseExperimenter``: tests that a designer can optimize when
    only a subset of the parameters affect the objective. The added ("sparse")
    parameters are copies of ``extra_space``'s parameters, renamed with
    ``prefix``; evaluation strips them before delegating.
    """

    def __init__(
        self,
        exptr: base.Experimenter,
        extra_space: "pc.SearchSpace",
        *,
        prefix: str = "_SPARSE",
    ):
        super().__init__(exptr)
        self._prefix = prefix
        inner = exptr.problem_statement()
        self._inner_names = set(inner.search_space.parameter_names())
        self._problem = copy.deepcopy(inner)
        for cfg in extra_space.parameters:
            name = f"{prefix}_{cfg.name}"
            if name in self._inner_names:
                raise ValueError(f"Sparse parameter {name!r} collides.")
            self._problem.search_space.root.add(
                dataclasses.replace(cfg, name=name)
            )

    @classmethod
    def create_default(
        cls,
        exptr: base.Experimenter,
        num_float: int = 0,
        num_int: int = 0,
        num_discrete: int = 0,
        num_categorical: int = 0,
        *,
        prefix: str = "_SPARSE",
    ) -> "SparseExperimenter":
        """Convenience: N placeholder params of each type with default domains."""
        space = pc.SearchSpace()
        for i in range(num_float):
            space.root.add_float_param(f"float{i}", -5.0, 5.0)
        for i in range(num_int):
            space.root.add_int_param(f"int{i}", -5, 5)
        for i in range(num_discrete):
            space.root.add_discrete_param(f"discrete{i}", [0, 1, 2, 3, 4])
        for i in range(num_categorical):
            space.root.add_categorical_param(
                f"categorical{i}", ["a", "b", "c", "d", "e", "f"]
            )
        return cls(exptr, space, prefix=prefix)

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        stripped = []
        for t in suggestions:
            s = trial_.Trial(
                id=t.id,
                parameters={
                    k: v.value
                    for k, v in t.parameters.items()
                    if k in self._inner_names
                },
            )
            stripped.append(s)
        self._exptr.evaluate(stripped)
        for t, s in zip(suggestions, stripped):
            if s.final_measurement is not None:
                t.complete(s.final_measurement)
            else:
                t.complete(
                    infeasibility_reason=s.infeasibility_reason
                    or "Inner experimenter returned no measurement."
                )

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)


class PermutingExperimenter(_Wrapper):
    """Permutes chosen discrete/categorical parameter values before evaluation.

    Reference ``PermutingExperimenter``: breaks any accidental ordinal
    structure of categorical values, so designers that (wrongly) assume
    category order degrade while order-agnostic ones do not.
    """

    def __init__(
        self,
        exptr: base.Experimenter,
        parameters_to_permute: Sequence[str],
        seed: Optional[int] = None,
    ):
        super().__init__(exptr)
        problem = exptr.problem_statement()
        if problem.search_space.is_conditional:
            raise ValueError("PermutingExperimenter requires a flat space.")
        rng = np.random.default_rng(seed)
        self._maps: Dict[str, Dict] = {}
        for name in parameters_to_permute:
            cfg = problem.search_space.get(name)
            if cfg.type == pc.ParameterType.DOUBLE:
                raise ValueError(
                    f"Parameter {name!r} is continuous; only finite-domain "
                    "parameters can be permuted."
                )
            values = list(cfg.feasible_values)
            permuted = list(rng.permutation(np.asarray(values, dtype=object)))
            self._maps[name] = dict(zip(values, permuted))

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        permuted = []
        for t in suggestions:
            s = copy.deepcopy(t)
            for name, mapping in self._maps.items():
                if name in s.parameters:
                    raw = s.parameters[name].value
                    key = type(next(iter(mapping)))(raw)
                    s.parameters[name] = mapping[key]
            permuted.append(s)
        self._exptr.evaluate(permuted)
        for t, s in zip(suggestions, permuted):
            if s.final_measurement is not None:
                t.complete(s.final_measurement)
            else:
                t.complete(
                    infeasibility_reason=s.infeasibility_reason
                    or "Inner experimenter returned no measurement."
                )


class SwitchExperimenter(base.Experimenter):
    """Conditional-space benchmark: a switch selects one sub-experimenter.

    Reference ``SwitchExperimenter``: the root ``switch`` parameter activates
    the selected experimenter's parameters as conditional children; the
    objective is relayed under one common metric name. This is the
    tree-structured (NAS-style) search-space testbed for conditional-capable
    designers (grid/random/quasi-random).
    """

    def __init__(
        self,
        experimenters: Sequence[base.Experimenter],
        *,
        switch_param_name: str = "switch",
        metric_name: str = "switch_metric",
    ):
        if not experimenters:
            raise ValueError("Need at least one experimenter.")
        self._experimenters = list(experimenters)
        self._switch = switch_param_name
        self._metric = metric_name
        self._problems = [e.problem_statement() for e in self._experimenters]
        self._objectives = [
            p.metric_information.item().name for p in self._problems
        ]
        goals = {p.metric_information.item().goal for p in self._problems}
        if len(goals) > 1:
            # Relaying raw values under one goal would silently invert the
            # benchmark for sub-experimenters with the other goal.
            raise ValueError(
                f"All sub-experimenters must share one optimization goal; "
                f"got {sorted(g.name for g in goals)}."
            )
        goal = self._problems[0].metric_information.item().goal
        self._problem = base_study_config.ProblemStatement()
        selector = self._problem.search_space.root.add_categorical_param(
            self._switch, [str(i) for i in range(len(self._experimenters))]
        )
        for i, p in enumerate(self._problems):
            child = selector.select_values([str(i)])
            for cfg in p.search_space.parameters:
                child.add(copy.deepcopy(cfg))
        self._problem.metric_information.append(
            base_study_config.MetricInformation(name=self._metric, goal=goal)
        )

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            idx = int(str(t.parameters[self._switch].value))
            sub = copy.deepcopy(t)
            del sub.parameters[self._switch]
            self._experimenters[idx].evaluate([sub])
            if sub.final_measurement is None:
                t.complete(
                    infeasibility_reason=sub.infeasibility_reason
                    or "Sub-experimenter returned no measurement."
                )
                continue
            value = sub.final_measurement.metrics[self._objectives[idx]].value
            t.complete(trial_.Measurement(metrics={self._metric: value}))

    def problem_statement(self) -> base_study_config.ProblemStatement:
        return copy.deepcopy(self._problem)
