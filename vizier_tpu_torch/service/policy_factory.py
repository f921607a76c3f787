"""Default service policy factory: algorithm string → Policy.

Counterpart of the JAX package's ``service/policy_factory.py``, without
protobuf: ``PythiaServicer.Suggest`` calls
``policy_factory(problem, algorithm, supporter, study_name)`` and then
``policy.suggest(request)``, and this is that factory.

- DEFAULT, GP_UCB_PE and ALGORITHM_UNSPECIFIED go to the port's
  ``VizierGPUCBPEBandit``, GAUSSIAN_PROCESS_BANDIT to ``VizierGPBandit``:
  with a serving runtime, through ``CachedDesignerStatePolicy`` (designer
  cache, warm-started ARD, the runtime's surrogate policy and batch
  executor), otherwise through the stateless ``DesignerPolicy``.
- RANDOM_SEARCH goes to ``RandomPolicy``; QUASI_RANDOM_SEARCH,
  GRID_SEARCH, SHUFFLED_GRID_SEARCH (shuffle seed 0), NSGA2 (its survival
  ranking on the factory's device) and EAGLE_STRATEGY to the
  ``PartiallySerializableDesignerPolicy`` (designer state in the study's
  metadata); CMA_ES, BOCS and HARMONICA to the stateless ``DesignerPolicy``.
  Each route has the JAX package's policy class.
- PYGLOVE goes to the port's ``pyglove.backend.TunerPolicy`` over the
  generator that the study's primary tuner registered
  (``pyglove.backend.register_generator``); a study with none raises
  ``ValueError``, as in the JAX package. The policy needs the ``pyglove``
  package, which only a host with it installed has.
"""

from __future__ import annotations

from typing import Optional

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter as supporter_lib
from vizier_tpu_torch.pyvizier import base_study_config

_ALLOWED_BUDGET_POLICIES = ("first_pick_full", "per_batch", "per_pick")

SERVED = (
    "DEFAULT", "GP_UCB_PE", "ALGORITHM_UNSPECIFIED", "GAUSSIAN_PROCESS_BANDIT", "RANDOM_SEARCH",
    "QUASI_RANDOM_SEARCH", "GRID_SEARCH", "SHUFFLED_GRID_SEARCH", "NSGA2", "EAGLE_STRATEGY",
    "CMA_ES", "BOCS", "HARMONICA", "PYGLOVE",
)


def _validated_acq_evals(problem_statement) -> int:
    """Study-metadata acquisition-sweep budget (0 = designer default).

    Namespace ``gp_ucb_pe``, key ``max_acquisition_evaluations``: the remote
    client's path to a designer kwarg. Raises on non-integer or negative
    values so a typo surfaces on the first suggest.
    """
    raw = problem_statement.metadata.ns("gp_ucb_pe").get("max_acquisition_evaluations")
    if raw is None:
        return 0
    try:
        evals = int(raw)
    except (TypeError, ValueError):
        evals = -1
    if evals < 0:
        raise ValueError(
            "Invalid study metadata ns 'gp_ucb_pe' key "
            f"'max_acquisition_evaluations': {raw!r}. "
            "Expected a non-negative integer (0 = designer default)."
        )
    return evals


class DefaultPolicyFactory:
    """Maps well-known algorithm names to policies.

    With a ``serving_runtime`` (``vizier_tpu_torch.serving.ServingRuntime``)
    the GP algorithms route through the per-study designer-state cache
    (``CachedDesignerStatePolicy``), with the designers configured from the
    runtime's config. ``device`` is where the designers run: CUDA unless the
    caller asks for the CPU.
    """

    def __init__(self, serving_runtime=None, device: device_lib.DeviceLike = "cuda"):
        self._serving = serving_runtime
        self._device = device

    def _gp_designer_kwargs(self) -> dict:
        """Serving-config-driven designer knobs for the GP algorithms."""
        kwargs = {"device": self._device}
        if self._serving is None:
            return kwargs
        cfg = self._serving.config
        kwargs["use_warm_start_ard"] = cfg.warm_start
        if cfg.warm_start:
            kwargs["warm_ard_restarts"] = cfg.warm_ard_restarts
        surrogates = getattr(self._serving, "surrogates", None)
        if surrogates is not None:
            kwargs["surrogate"] = surrogates
        return kwargs

    def _gp_policy(
        self, policy_supporter, factory, study_name: str, problem=None
    ) -> policy_lib.Policy:
        """Cache-backed policy when serving is on; stateless otherwise."""
        from vizier_tpu_torch.algorithms import designer_policy

        if self._serving is not None and self._serving.config.designer_cache:
            from vizier_tpu_torch.serving import policy as serving_policy

            if problem is not None:
                # Background prewarm of this search space's buckets (a no-op
                # unless batching_prewarm is on).
                self._serving.maybe_prewarm_batching_async(problem, factory)
            return serving_policy.CachedDesignerStatePolicy(
                policy_supporter, factory, self._serving, study_name, use_seeding=True
            )
        return designer_policy.DesignerPolicy(policy_supporter, factory, use_seeding=True)

    def __call__(
        self,
        problem_statement: base_study_config.ProblemStatement,
        algorithm: Optional[str],
        policy_supporter: supporter_lib.PolicySupporter,
        study_name: str,
    ) -> policy_lib.Policy:
        from vizier_tpu_torch.algorithms import designer_policy

        algorithm = (algorithm or "DEFAULT").upper()
        if algorithm in ("DEFAULT", "GP_UCB_PE", "ALGORITHM_UNSPECIFIED"):
            # Validate the metadata overrides at policy construction: a
            # client typo surfaces as one descriptive error.
            requested_policy = problem_statement.metadata.ns("gp_ucb_pe").get(
                "acquisition_budget_policy", cls=str
            )
            if requested_policy and requested_policy not in _ALLOWED_BUDGET_POLICIES:
                raise ValueError(
                    "Invalid study metadata ns 'gp_ucb_pe' key "
                    f"'acquisition_budget_policy': {requested_policy!r}. "
                    f"Allowed values: {', '.join(_ALLOWED_BUDGET_POLICIES)}."
                )
            _validated_acq_evals(problem_statement)
            from vizier_tpu_torch.designers import gp_ucb_pe

            serving_kwargs = self._gp_designer_kwargs()

            def factory(p, **kw):
                kwargs = dict(serving_kwargs)
                requested = p.metadata.ns("gp_ucb_pe").get("acquisition_budget_policy", cls=str)
                if requested:
                    kwargs["acquisition_budget_policy"] = requested
                evals = _validated_acq_evals(p)
                if evals:
                    kwargs["max_acquisition_evaluations"] = evals
                return gp_ucb_pe.VizierGPUCBPEBandit(p, **kwargs)

            return self._gp_policy(
                policy_supporter, factory, study_name, problem=problem_statement
            )
        if algorithm == "GAUSSIAN_PROCESS_BANDIT":
            from vizier_tpu_torch.designers import gp_bandit

            serving_kwargs = self._gp_designer_kwargs()
            return self._gp_policy(
                policy_supporter,
                lambda p, **kw: gp_bandit.VizierGPBandit(p, **serving_kwargs),
                study_name,
                problem=problem_statement,
            )
        if algorithm == "RANDOM_SEARCH":
            from vizier_tpu_torch.algorithms import random_policy

            return random_policy.RandomPolicy(policy_supporter)
        if algorithm == "QUASI_RANDOM_SEARCH":
            from vizier_tpu_torch.designers import quasi_random

            return designer_policy.PartiallySerializableDesignerPolicy(
                policy_supporter,
                lambda p, **kw: quasi_random.QuasiRandomDesigner(p.search_space),
            )
        if algorithm in ("GRID_SEARCH", "SHUFFLED_GRID_SEARCH"):
            from vizier_tpu_torch.designers import grid

            shuffle = 0 if algorithm == "SHUFFLED_GRID_SEARCH" else None
            return designer_policy.PartiallySerializableDesignerPolicy(
                policy_supporter,
                lambda p, **kw: grid.GridSearchDesigner(p.search_space, shuffle_seed=shuffle),
            )
        if algorithm == "NSGA2":
            from vizier_tpu_torch.designers import evolution

            return designer_policy.PartiallySerializableDesignerPolicy(
                policy_supporter,
                lambda p, **kw: evolution.NSGA2Designer(p, device=self._device),
            )
        if algorithm == "EAGLE_STRATEGY":
            from vizier_tpu_torch.designers import eagle_strategy

            return designer_policy.PartiallySerializableDesignerPolicy(
                policy_supporter,
                lambda p, **kw: eagle_strategy.EagleStrategyDesigner(p),
            )
        if algorithm == "CMA_ES":
            from vizier_tpu_torch.designers import cmaes

            return designer_policy.DesignerPolicy(
                policy_supporter, lambda p, **kw: cmaes.CMAESDesigner(p)
            )
        if algorithm == "BOCS":
            from vizier_tpu_torch.designers import bocs

            return designer_policy.DesignerPolicy(
                policy_supporter, lambda p, **kw: bocs.BOCSDesigner(p)
            )
        if algorithm == "HARMONICA":
            from vizier_tpu_torch.designers import harmonica

            return designer_policy.DesignerPolicy(
                policy_supporter, lambda p, **kw: harmonica.HarmonicaDesigner(p)
            )
        if algorithm == "PYGLOVE":
            from vizier_tpu_torch.pyglove import backend as pyglove_backend

            registered = pyglove_backend.get_registered_generator(study_name)
            if registered is None:
                raise ValueError(
                    f"No PyGlove generator registered for study {study_name!r}; "
                    "construct VizierBackend with dna_spec and algorithm in the "
                    "primary tuner process first."
                )
            dna_spec, generator = registered
            return pyglove_backend.TunerPolicy(policy_supporter, dna_spec, generator)
        raise ValueError(f"Unknown algorithm: {algorithm!r}")
