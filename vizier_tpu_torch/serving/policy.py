"""The serving policy: cached designer + incremental updates + warm ARD.

Counterpart of the JAX package's ``serving/policy.py``. The policy itself is
rebuilt per Pythia request (cheap), while the designer, its trained ARD
params and the incorporated-trial-id set live in the process-wide
:class:`~vizier_tpu_torch.serving.designer_cache.DesignerStateCache`. Each
suggest hands the designer to the runtime's batch executor (when batching
is on), so concurrent same-bucket studies share one batched program; a
speculative job's compute rides the executor's deferrable lane.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Sequence

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.algorithms import designer_policy
from vizier_tpu_torch.observability import flight_recorder as recorder_lib
from vizier_tpu_torch.observability import tracing as tracing_lib
from vizier_tpu_torch.pythia import policy as policy_lib
from vizier_tpu_torch.pythia import policy_supporter as supporter_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.serving import designer_cache as cache_lib
from vizier_tpu_torch.serving import runtime as runtime_lib
from vizier_tpu_torch.serving import speculative as speculative_lib
from vizier_tpu_torch.surrogates import config as surrogate_config_lib

_logger = logging.getLogger(__name__)


class CachedDesignerStatePolicy(policy_lib.Policy):
    """Routes suggests through the shared per-study designer cache."""

    def __init__(
        self,
        supporter: supporter_lib.PolicySupporter,
        designer_factory: Callable[[base_study_config.ProblemStatement], Any],
        runtime: runtime_lib.ServingRuntime,
        study_name: str,
        *,
        use_seeding: bool = False,
    ):
        self._supporter = supporter
        self._designer_factory = designer_factory
        self._runtime = runtime
        self._study_name = study_name
        self._use_seeding = use_seeding

    def suggest(self, request: policy_lib.SuggestRequest) -> policy_lib.SuggestDecision:
        if self._use_seeding and request.max_trial_id == 0:
            seed = designer_policy.default_suggestion(request.study_config.to_problem())
            rest: Sequence[trial_.TrialSuggestion] = []
            if request.count > 1:
                rest = self._run_designer(request, request.count - 1)
            return policy_lib.SuggestDecision(suggestions=[seed] + list(rest))
        return policy_lib.SuggestDecision(
            suggestions=list(self._run_designer(request, request.count))
        )

    def _run_designer(
        self, request: policy_lib.SuggestRequest, count: int
    ) -> List[trial_.TrialSuggestion]:
        problem = request.study_config.to_problem()
        cache = self._runtime.designer_cache
        entry = cache.get_or_create(self._study_name, lambda: self._designer_factory(problem))
        # Surrogate-crossover invalidation: a parked speculative batch
        # predates the crossover's warm/posterior reset, so the designer
        # reports the flip straight into the engine the moment it happens.
        if self._runtime.speculative_engine is not None:
            surrogate_config_lib.install_crossover_listener(
                entry.designer, self._on_surrogate_crossover
            )
        with entry.lock:
            try:
                return self._update_and_suggest(entry, count)
            except Exception:
                # A designer whose live state went bad must not poison every
                # later suggest for the study: drop the entry so the next
                # request rebuilds from a full replay, then surface the error.
                cache.invalidate(self._study_name)
                _logger.warning(
                    "Serving designer for %s failed; cache entry invalidated.", self._study_name
                )
                raise

    def _update_and_suggest(
        self, entry: cache_lib.CachedDesignerEntry, count: int
    ) -> List[trial_.TrialSuggestion]:
        designer = entry.designer
        tracer = tracing_lib.get_tracer()
        completed = self._supporter.GetTrials(status_matches=trial_.TrialStatus.COMPLETED)
        new_completed = [t for t in completed if t.id not in entry.incorporated_trial_ids]
        active = self._supporter.GetTrials(status_matches=trial_.TrialStatus.ACTIVE)
        before = self._counts(designer, "ard_train_counts")
        surrogate_before = self._counts(designer, "surrogate_counts")
        with tracer.span(
            "designer.update", designer=type(designer).__name__,
            new_completed=len(new_completed), incremental=True,
        ):
            designer.update(core_lib.CompletedTrials(new_completed), core_lib.ActiveTrials(active))
        entry.incorporated_trial_ids.update(t.id for t in new_completed)
        with tracer.span("designer.suggest", designer=type(designer).__name__, count=count):
            # Cross-study batching: concurrent same-bucket computations from
            # different studies share one batched program; the executor runs
            # unbatchable paths inline.
            executor = self._runtime.batch_executor
            if executor is not None:
                # A speculative job's compute rides the deferrable lane: it
                # shares a flush with live traffic when one is forming, but
                # never delays a live flush.
                suggestions = list(executor.suggest(
                    designer, count, speculative=speculative_lib.in_speculative_compute()
                ))
            else:
                suggestions = list(designer.suggest(count))
        self._account(before, self._counts(designer, "ard_train_counts"),
                      {"warm": "warm_trains", "cold": "cold_trains"})
        surrogate_after = self._counts(designer, "surrogate_counts")
        self._account(surrogate_before, surrogate_after,
                      {"sparse_suggests": "sparse_suggests", "crossovers": "surrogate_crossovers"})
        if surrogate_before is not None and surrogate_after is not None:
            crossed = surrogate_after.get("crossovers", 0) - surrogate_before.get("crossovers", 0)
            if crossed > 0:
                recorder_lib.get_recorder().record(
                    self._study_name, "surrogate_crossover", count=crossed,
                    mode=surrogate_after.get("mode"),
                )
        # Mirror the trained unconstrained ARD params into the entry: the
        # inspection surface for "what would seed the next train".
        get_state = getattr(designer, "warm_start_state", None)
        if get_state is not None:
            entry.warm_params = get_state()
        entry.surrogate_mode = getattr(designer, "surrogate_mode", None)
        get_sparse = getattr(designer, "sparse_inducing_state", None)
        entry.sparse_state = get_sparse() if get_sparse is not None else None
        entry.num_suggests += 1
        return suggestions

    def _on_surrogate_crossover(self, old_mode: str, new_mode: str) -> None:
        """The designer's exact↔sparse flip invalidates the parked batch."""
        self._runtime.speculative_invalidate(
            self._study_name, reason=f"crossover:{old_mode}->{new_mode}"
        )

    @staticmethod
    def _counts(designer: Any, attribute: str) -> Optional[dict]:
        counts = getattr(designer, attribute, None)
        return dict(counts) if counts is not None else None

    def _account(self, before: Optional[dict], after: Optional[dict], fields: dict) -> None:
        if before is None or after is None:
            return
        for key, field in fields.items():
            delta = after.get(key, 0) - before.get(key, 0)
            if delta > 0:
                self._runtime.stats.increment(field, delta)
