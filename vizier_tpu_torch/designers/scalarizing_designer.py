"""ScalarizingDesigner: multi-objective → single-objective reduction.

Counterpart of the JAX package's ``designers/scalarizing_designer.py``:
wraps any single-objective designer factory; completed trials get a
synthetic scalarized metric and the inner designer optimizes that. The
scalarization runs on the wrapper's device in float32, as the JAX package
computes it, over every feasible row of an update at once; the default inner
designer is the port's ``VizierGPBandit`` on that device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.designers import scalarization as scalarization_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

SCALARIZED_METRIC = "scalarized"


@dataclasses.dataclass
class ScalarizingDesigner(core_lib.Designer):
    problem: base_study_config.ProblemStatement
    scalarization: scalarization_lib.Scalarization = None  # type: ignore[assignment]
    designer_factory: Optional[core_lib.DesignerFactory] = None
    seed: Optional[int] = None
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        self.device = device_lib.resolve(self.device)
        metrics = [
            m for m in self.problem.metric_information if not m.is_safety_metric
        ]
        self._num_objectives = len(metrics)
        if self.scalarization is None:
            self.scalarization = scalarization_lib.ChebyshevScalarization(
                weights=tuple([1.0 / self._num_objectives] * self._num_objectives)
            )
        self._metrics_encoder = converters.MetricsEncoder(
            base_study_config.MetricsConfig(metrics)
        )
        inner_problem = base_study_config.ProblemStatement(
            search_space=self.problem.search_space,
            metric_information=base_study_config.MetricsConfig(
                [
                    base_study_config.MetricInformation(
                        name=SCALARIZED_METRIC,
                        goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
                    )
                ]
            ),
        )
        if self.designer_factory is None:
            from vizier_tpu_torch.designers import gp_bandit

            self.designer_factory = lambda p, **kw: gp_bandit.VizierGPBandit(
                p, rng_seed=self.seed or 0, device=self.device
            )
        self._inner = self.designer_factory(inner_problem)

    def scalarize(self, objectives: np.ndarray) -> np.ndarray:
        """[N, M] all-MAXIMIZE objectives → [N] float32 scalarized labels,
        computed on the wrapper's device."""
        values = self.scalarization(
            torch.as_tensor(np.asarray(objectives, dtype=np.float32), device=self.device))
        return values.cpu().numpy()

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        trials = list(completed.trials)
        objectives = self._metrics_encoder.encode(trials)  # all-MAXIMIZE
        feasible = np.all(np.isfinite(objectives), axis=1)
        values = iter(self.scalarize(objectives[feasible]) if feasible.any() else ())
        rewritten = []
        for t, ok in zip(trials, feasible):
            clone = trial_.Trial(id=t.id, parameters=t.parameters, metadata=t.metadata)
            if ok:
                clone.complete(
                    trial_.Measurement(metrics={SCALARIZED_METRIC: float(next(values))})
                )
            else:
                clone.complete(infeasibility_reason=t.infeasibility_reason or "NaN")
            rewritten.append(clone)
        self._inner.update(core_lib.CompletedTrials(rewritten), all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        return list(self._inner.suggest(count))
