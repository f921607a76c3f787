"""ScheduledDesigner: time-varying designer hyperparameters.

Copy of the JAX package's ``designers/scheduled_designer.py`` (host
bookkeeping): designer knobs follow exponential/linear schedules over the
expected trial budget, and the designer is rebuilt when the scheduled values
change. The presets ``scheduled_gp_ucb_pe`` and ``scheduled_gp_bandit``
build the port's GP designers on their ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule:
    init_value: float
    final_value: float
    rate: float = 1.0

    def __call__(self, progress: float) -> float:
        progress = min(max(progress, 0.0), 1.0)
        if self.init_value <= 0 or self.final_value <= 0:
            return self.init_value + (self.final_value - self.init_value) * progress
        log_v = math.log(self.init_value) + (
            math.log(self.final_value) - math.log(self.init_value)
        ) * (progress**self.rate)
        return math.exp(log_v)


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
    init_value: float
    final_value: float

    def __call__(self, progress: float) -> float:
        progress = min(max(progress, 0.0), 1.0)
        return self.init_value + (self.final_value - self.init_value) * progress


@dataclasses.dataclass
class ScheduledDesigner(core_lib.Designer):
    """Rebuilds an inner designer with scheduled params as trials accrue.

    ``designer_factory(problem, **scheduled_params)`` is invoked whenever the
    scheduled values change; all completed trials are replayed into the new
    instance.
    """

    problem: base_study_config.ProblemStatement
    designer_factory: Callable[..., core_lib.Designer] = None  # type: ignore[assignment]
    scheduled_params: Dict[str, Callable[[float], float]] = dataclasses.field(
        default_factory=dict
    )
    expected_total_num_trials: int = 100
    # Rebuild (and replay all trials) only when a scheduled value moves by
    # more than this relative amount — continuous schedules would otherwise
    # rebuild on every suggest.
    rebuild_tolerance: float = 0.05

    def __post_init__(self):
        if self.designer_factory is None:
            raise ValueError("designer_factory is required.")
        self._all_completed: List[trial_.Trial] = []
        self._designer: Optional[core_lib.Designer] = None
        self._current_values: Optional[Dict[str, float]] = None

    def _progress(self) -> float:
        return len(self._all_completed) / max(self.expected_total_num_trials, 1)

    def _maybe_rebuild(self) -> core_lib.Designer:
        values = {
            name: schedule(self._progress())
            for name, schedule in self.scheduled_params.items()
        }
        changed = self._designer is None or any(
            abs(values[k] - self._current_values[k])
            > self.rebuild_tolerance * max(abs(self._current_values[k]), 1e-9)
            for k in values
        )
        if changed:
            self._designer = self.designer_factory(self.problem, **values)
            self._current_values = values
            if self._all_completed:
                self._designer.update(
                    core_lib.CompletedTrials(self._all_completed),
                    core_lib.ActiveTrials(),
                )
        return self._designer

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        self._all_completed.extend(completed.trials)
        if self._designer is not None:
            self._designer.update(completed, all_active)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        return list(self._maybe_rebuild().suggest(count))


def scheduled_gp_ucb_pe(
    problem: base_study_config.ProblemStatement,
    *,
    expected_total_num_trials: int = 100,
    init_ucb: float = 2.5,
    final_ucb: float = 0.8,
    init_explore_ucb: float = 1.0,
    final_explore_ucb: float = 0.3,
    seed: Optional[int] = None,
    device: device_lib.DeviceLike = "cuda",
) -> ScheduledDesigner:
    """DEFAULT algorithm with decaying UCB + explore-region coefficients:
    early trials explore (large confidence bounds, wide promising region),
    late trials exploit."""
    from vizier_tpu_torch.designers import gp_ucb_pe

    device = device_lib.resolve(device)

    def factory(p, ucb_coefficient, explore_region_ucb_coefficient):
        return gp_ucb_pe.VizierGPUCBPEBandit(
            p,
            rng_seed=seed or 0,
            device=device,
            config=gp_ucb_pe.UCBPEConfig(
                ucb_coefficient=round(ucb_coefficient, 2),
                explore_region_ucb_coefficient=round(
                    explore_region_ucb_coefficient, 2
                ),
            ),
        )

    return ScheduledDesigner(
        problem=problem,
        designer_factory=factory,
        scheduled_params={
            "ucb_coefficient": ExponentialSchedule(init_ucb, final_ucb),
            "explore_region_ucb_coefficient": ExponentialSchedule(
                init_explore_ucb, final_explore_ucb
            ),
        },
        expected_total_num_trials=expected_total_num_trials,
    )


def scheduled_gp_bandit(
    problem: base_study_config.ProblemStatement,
    *,
    expected_total_num_trials: int = 100,
    init_ucb: float = 2.5,
    final_ucb: float = 0.8,
    seed: Optional[int] = None,
    device: device_lib.DeviceLike = "cuda",
) -> ScheduledDesigner:
    """GP bandit with a decaying UCB coefficient (explore → exploit)."""
    from vizier_tpu_torch.designers import gp_bandit

    device = device_lib.resolve(device)
    return ScheduledDesigner(
        problem=problem,
        designer_factory=lambda p, ucb_coefficient: gp_bandit.VizierGPBandit(
            p, ucb_coefficient=round(ucb_coefficient, 2), rng_seed=seed or 0,
            device=device,
        ),
        scheduled_params={
            "ucb_coefficient": ExponentialSchedule(init_ucb, final_ucb)
        },
        expected_total_num_trials=expected_total_num_trials,
    )
