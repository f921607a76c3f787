"""Multimetric utilities: Pareto optimality, hypervolume, safety checking.

Counterpart of the JAX package's ``pyvizier/multimetric.py``: numpy-facing
wrappers over the tensor ops in ``vizier_tpu_torch.ops.pareto``, which run
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


class ParetoOptimalAlgorithm:
    """Frontier membership / Pareto rank over [N, M] MAXIMIZE matrices."""

    def __init__(self, device: device_lib.DeviceLike = "cuda"):
        self._device = device_lib.resolve(device)

    def _points(self, points: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(points, dtype=np.float32), device=self._device)

    def is_pareto_optimal(self, points: np.ndarray) -> np.ndarray:
        if np.size(points) == 0:
            return np.zeros((0,), dtype=bool)
        return pareto_ops.is_frontier(self._points(points)).cpu().numpy()

    def pareto_rank(self, points: np.ndarray) -> np.ndarray:
        if np.size(points) == 0:
            return np.zeros((0,), dtype=np.int32)
        return pareto_ops.pareto_rank(self._points(points)).cpu().numpy().astype(np.int32)


# One implementation behind the naive and fast names.
FastParetoOptimalAlgorithm = ParetoOptimalAlgorithm
NaiveParetoOptimalAlgorithm = ParetoOptimalAlgorithm


class ParetoFrontier:
    """Hypervolume of a frontier w.r.t. an origin (random-direction MC).

    The directions are drawn once, from ``seed``, so every call of
    ``hypervolume`` uses the same ones.
    """

    def __init__(
        self,
        points: np.ndarray,
        origin: Optional[np.ndarray] = None,
        *,
        num_vectors: int = 10_000,
        seed: int = 0,
        device: device_lib.DeviceLike = "cuda",
    ):
        dev = device_lib.resolve(device)
        self._points = torch.as_tensor(np.asarray(points, dtype=np.float32), device=dev)
        self._origin = (
            torch.as_tensor(np.asarray(origin, dtype=np.float32), device=dev)
            if origin is not None
            else torch.zeros(self._points.shape[-1], device=dev)
        )
        generator = torch.Generator(device=dev).manual_seed(seed)
        self._directions = pareto_ops.draw_directions(
            generator, num_vectors, self._points.shape[-1]
        )

    def hypervolume(self, is_cumulative: bool = False):
        shifted = torch.clamp(self._points - self._origin[None, :], min=0.0)
        cum = pareto_ops.cum_hypervolume_origin(shifted, self._directions).cpu().numpy()
        return cum if is_cumulative else float(cum[-1])


class SafetyChecker:
    """Filters trials violating safety-metric thresholds."""

    def __init__(self, metrics: base_study_config.MetricsConfig):
        self._safety = [m for m in metrics if m.is_safety_metric]

    def warp_unsafe_trials(self, trials: Sequence[trial_.Trial]) -> Sequence[trial_.Trial]:
        """Marks unsafe completed trials infeasible (in place); returns them.

        Measurements are kept; the label encoders leave infeasible trials
        out of model training whatever their measurements.
        """
        for t in trials:
            if not self.is_safe(t):
                t.infeasibility_reason = t.infeasibility_reason or "Safety violation."
        return trials

    def is_safe(self, trial: trial_.Trial) -> bool:
        if trial.final_measurement is None:
            return True
        for info in self._safety:
            metric = trial.final_measurement.metrics.get(info.name)
            if metric is None:
                continue
            threshold = info.safety_threshold or 0.0
            if info.goal.is_maximize and metric.value < threshold:
                return False
            if info.goal.is_minimize and metric.value > threshold:
                return False
        return True
