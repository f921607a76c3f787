"""Gradient-based acquisition maximization (continuous-only), and any
designer as an acquisition optimizer.

Counterpart of the JAX package's ``optimizers/lbfgsb_optimizer.py``.
``LBFGSBOptimizer`` maximizes a differentiable acquisition over [0, 1]^D by
multi-restart L-BFGS; bounds are handled by a sigmoid reparameterization
z -> (0, 1)^D, as the ARD train handles its own. The JAX package ``vmap``s
the restarts; here they are one ``[R, D]`` batch through the batched
``lbfgs.lbfgs_minimize``, and the score sees all R query points at once
(each row is scored on its own, so each restart follows its own path). On
CUDA features the acquisition's gradient with respect to the query points
reaches the kernel through K2's feature gradient (``kernels.matern52_ard``'s
backward asks for it when the queries require a gradient); on the CPU the
plain version computes the same function.

``DesignerAsOptimizer`` is host logic, as in the JAX package: the
acquisition is the objective of a mini-study that a designer drives.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LBFGSBOptimizer:
    """Continuous acquisition maximizer under the vectorized-result API."""

    num_restarts: int = 16
    maxiter: int = 50
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", device_lib.resolve(self.device))

    def restart_draws(self, generator: Optional[torch.Generator], num_continuous: int) -> Tensor:
        """The restarts' starting points z0 = 2·N(0, 1), [R, D]."""
        return 2.0 * torch.randn((self.num_restarts, num_continuous), generator=generator,
                                 device=self.device)

    def loss_fn(self, score_fn: vectorized_lib.ScoreFn) -> Callable[[Tensor], Tensor]:
        """[R, D] unconstrained points -> [R] negated scores at their sigmoids."""

        def unconstrained_loss(z: Tensor) -> Tensor:
            x = torch.sigmoid(z)  # (0, 1)^D
            codes = torch.zeros((z.shape[0], 0), dtype=torch.int32, device=z.device)
            return -score_fn(kernels.MixedFeatures(x, codes))

        return unconstrained_loss

    def __call__(
        self,
        score_fn: vectorized_lib.ScoreFn,
        generator: Optional[torch.Generator] = None,
        *,
        num_continuous: int,
        count: int = 1,
        z0: Optional[Tensor] = None,
    ) -> vectorized_lib.VectorizedOptimizerResult:
        """The ``count`` best of ``num_restarts`` maximizations of
        ``score_fn``. ``z0`` [R, D] gives the restarts' starting points
        (fed draws); by default they are drawn from ``generator``."""
        if z0 is None:
            z0 = self.restart_draws(generator, num_continuous)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=self.device)
        # ftol disabled: acquisition values are << 1, so a relative ftol
        # would act as a loose absolute threshold and stop the maximization
        # early.
        z, loss = lbfgs_lib.lbfgs_minimize(
            self.loss_fn(score_fn), z0, maxiter=self.maxiter, ftol=0.0)
        xs, scores = torch.sigmoid(z), -loss
        # The best first, lower restart index first among equal scores.
        top = torch.sort(scores, descending=True, stable=True).indices[:count]
        return vectorized_lib.VectorizedOptimizerResult(
            kernels.MixedFeatures(
                xs[top], torch.zeros((count, 0), dtype=torch.int32, device=xs.device)),
            scores[top],
        )


@dataclasses.dataclass
class DesignerAsOptimizer:
    """Uses any Designer as a (gradient-free) acquisition optimizer: the
    acquisition is the objective of a mini-study driven by the designer."""

    designer_factory: Callable  # problem -> Designer
    num_rounds: int = 20
    batch_size: int = 10
    # Where a multi-metric score's Pareto ranks are computed.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        self.device = device_lib.resolve(self.device)

    def optimize(
        self,
        score_fn,  # list[TrialSuggestion] -> list[float] | {metric: [N] or [N,1]}
        problem,
        *,
        count: int = 1,
        score_fn_returns_dict: bool | None = None,
    ):
        """Runs a mini-study of the score function driven by the designer.

        ``score_fn`` may return a plain sequence of floats (scored against a
        synthetic MAXIMIZE "acquisition" metric, the common single-
        acquisition path) or a mapping of metric name to an [N] / [N, 1]
        array, in which case the caller's own metric goals rank the results
        (Pareto front for multi-metric). Pass ``score_fn_returns_dict`` to
        skip the classification probe.
        """
        from vizier_tpu_torch.algorithms import core as core_lib
        from vizier_tpu_torch.designers import random as random_lib
        from vizier_tpu_torch.pyvizier import base_study_config
        from vizier_tpu_torch.pyvizier import multimetric
        from vizier_tpu_torch.pyvizier import trial as trial_

        probe_scored = None
        if score_fn_returns_dict is not None:
            dict_scores = score_fn_returns_dict
        else:
            # Classify from a real single-suggestion batch: an empty-batch
            # probe misclassifies list-style fns that can't handle []. The
            # evaluation is kept as a ranked candidate so it isn't wasted
            # (auto-classification costs this one probe evaluation; callers
            # with expensive or stateful score functions can pass
            # score_fn_returns_dict to skip it).
            try:
                probe = random_lib.RandomDesigner(problem.search_space, seed=0).suggest(1)
                values = score_fn(probe)
                dict_scores = isinstance(values, dict)
                if dict_scores:
                    probe_metrics = {
                        k: float(np.asarray(v[0]).reshape(())) for k, v in values.items()
                    }
                else:
                    probe_metrics = {"acquisition": float(values[0])}
                probe_scored = (probe_metrics, probe[0])
            except (
                TypeError,
                ValueError,
                IndexError,
                KeyError,
                AssertionError,
                RuntimeError,  # includes torch's errors for an unexpected shape
            ) as e:
                # Shape or arity failures mean "score_fn can't take the
                # 1-row probe" (shape-specialized callables raise TypeError,
                # ValueError or RuntimeError; hand-guarded ones assert): fall
                # back to the problem-shape heuristic, loudly. Anything else
                # (a genuine score_fn bug) propagates to the caller instead
                # of being silently reclassified. Shape-specialized callers
                # should pass score_fn_returns_dict explicitly.
                logging.getLogger(__name__).info(
                    "DesignerAsOptimizer probe evaluation failed (%s: %s); "
                    "classifying score_fn from problem.metric_information.",
                    type(e).__name__,
                    e,
                )
                dict_scores = bool(problem.metric_information)
                probe_scored = None
        if dict_scores and not problem.metric_information:
            raise ValueError(
                "A dict-returning score_fn needs problem.metric_information "
                "to rank its metrics; pass a problem with metrics or a "
                "sequence-returning score_fn."
            )
        if dict_scores:
            metric_goals = {m.name: m.goal for m in problem.metric_information}
            inner_problem = problem
        else:
            # Single synthetic always-MAXIMIZE acquisition metric over the
            # caller's search space: the caller's own metric goals must not
            # flip the acquisition's sign.
            metric_goals = {"acquisition": base_study_config.ObjectiveMetricGoal.MAXIMIZE}
            inner_problem = base_study_config.ProblemStatement(
                search_space=problem.search_space,
                metric_information=base_study_config.MetricsConfig(
                    [
                        base_study_config.MetricInformation(
                            name="acquisition",
                            goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
                        )
                    ]
                ),
            )
        designer = self.designer_factory(inner_problem)
        # Drop the probe if its metric keys don't cover the ranking metrics
        # (dict-style score_fn with an empty metric_information problem).
        if probe_scored is not None and not set(metric_goals) <= set(probe_scored[0]):
            probe_scored = None
        scored = [probe_scored] if probe_scored is not None else []
        next_id = 1
        for _ in range(self.num_rounds):
            suggestions = designer.suggest(self.batch_size)
            if not suggestions:
                break
            values = score_fn(suggestions)
            if dict_scores:
                per_trial = [
                    {k: float(np.asarray(v[i]).reshape(())) for k, v in values.items()}
                    for i in range(len(suggestions))
                ]
            else:
                per_trial = [{"acquisition": float(v)} for v in values]
            completed = []
            for s, metrics in zip(suggestions, per_trial):
                t = s.to_trial(next_id)
                next_id += 1
                t.complete(trial_.Measurement(metrics=metrics))
                completed.append(t)
                scored.append((metrics, s))
            designer.update(core_lib.CompletedTrials(completed), core_lib.ActiveTrials())
        names = list(metric_goals)
        if len(names) == 1:
            sign = 1.0 if metric_goals[names[0]].is_maximize else -1.0
            scored.sort(key=lambda pair: -sign * pair[0][names[0]])
            return [s for _, s in scored[:count]]
        # Multi-metric: maximize-oriented Pareto rank, best ranks first.
        signs = np.asarray([1.0 if metric_goals[n].is_maximize else -1.0 for n in names])
        points = np.asarray([[m[n] for n in names] for m, _ in scored]) * signs
        ranks = multimetric.ParetoOptimalAlgorithm(self.device).pareto_rank(points)
        order = np.argsort(ranks, kind="stable")
        return [scored[i][1] for i in order[:count]]
