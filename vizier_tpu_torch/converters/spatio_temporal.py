"""Spatio-temporal converters: per-step measurement curves -> arrays.

Copy of the JAX package's ``converters/spatio_temporal.py`` (host numpy):
early-stopping and curve-extrapolation models consume ``[num_trials,
num_steps]`` label matrices aligned on a common step grid; this module
extracts and aligns intermediate measurements.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class TimedLabels:
    """One trial's curve: positions [T] and values [T, M]."""

    positions: np.ndarray
    values: np.ndarray


@dataclasses.dataclass
class TimedLabelsExtractor:
    """Extracts per-trial measurement curves for the configured metrics.

    ``value_mode='cummax'`` converts each metric's curve to its running
    best (goal-aware: running min for MINIMIZE metrics) — the monotone form
    curve-extrapolation early-stopping models expect.
    """

    metrics: base_study_config.MetricsConfig
    use_steps: bool = True
    value_mode: str = "raw"  # 'raw' | 'cummax'

    def __post_init__(self):
        if self.value_mode not in ("raw", "cummax"):
            raise ValueError(f"Unknown value_mode {self.value_mode!r}.")

    def convert_trial(self, trial: trial_.Trial) -> TimedLabels:
        names = [m.name for m in self.metrics]
        positions: List[float] = []
        rows: List[List[float]] = []
        for m in trial.measurements:
            positions.append(m.steps if self.use_steps else m.elapsed_secs)
            rows.append(
                [
                    m.metrics[n].value if n in m.metrics else np.nan
                    for n in names
                ]
            )
        values = np.asarray(rows, dtype=np.float64).reshape(len(rows), len(names))
        if self.value_mode == "cummax" and len(rows):
            for j, info in enumerate(self.metrics):
                col = values[:, j]
                if info.goal.is_maximize:
                    values[:, j] = np.fmax.accumulate(col)
                else:
                    values[:, j] = np.fmin.accumulate(col)
        return TimedLabels(
            positions=np.asarray(positions, dtype=np.float64),
            values=values,
        )

    def convert(self, trials: Sequence[trial_.Trial]) -> List[TimedLabels]:
        return [self.convert_trial(t) for t in trials]

    def extract_all_timestamps(
        self, trials: Sequence[trial_.Trial]
    ) -> np.ndarray:
        """Sorted union of every trial's measurement positions."""
        curves = self.convert(trials)
        parts = [c.positions for c in curves if len(c.positions)]
        return np.unique(np.concatenate(parts)) if parts else np.zeros(0)

    def to_timestamps(
        self, positions: np.ndarray, *, max_position: Optional[float] = None
    ) -> np.ndarray:
        """Normalizes raw positions into [0, 1] (for temporal kernels)."""
        positions = np.asarray(positions, dtype=np.float64)
        if max_position is None:
            max_position = float(positions.max()) if positions.size else 1.0
        return positions / max(max_position, 1e-12)


@dataclasses.dataclass
class SparseSpatioTemporalConverter:
    """Aligns trial curves onto a common step grid → [N, T, M] with a mask.

    Values are carried forward from the last reported position (the usual
    convention for training-curve models); the mask marks grid points at or
    beyond each trial's first measurement.
    """

    extractor: TimedLabelsExtractor

    def to_arrays(
        self, trials: Sequence[trial_.Trial], *, grid: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        curves = self.extractor.convert(trials)
        if grid is None:
            all_positions = np.concatenate(
                [c.positions for c in curves if len(c.positions)] or [np.zeros(0)]
            )
            grid = np.unique(all_positions)
        n, t = len(trials), len(grid)
        m = len(self.extractor.metrics)
        values = np.full((n, t, m), np.nan)
        mask = np.zeros((n, t), dtype=bool)
        for i, c in enumerate(curves):
            if not len(c.positions):
                continue
            order = np.argsort(c.positions)
            pos, val = c.positions[order], c.values[order]
            idx = np.searchsorted(pos, grid, side="right") - 1
            valid = idx >= 0  # grid points at/after the trial's first report
            safe = np.clip(idx, 0, len(pos) - 1)
            values[i] = val[safe]
            values[i, ~valid] = np.nan
            mask[i] = valid
        return values, mask, grid


@dataclasses.dataclass
class DenseSpatioTemporalConverter:
    """Interpolated dense curves on a fixed-size grid → [N, T, M].

    Unlike the sparse carry-forward aligner, values are linearly interpolated
    inside each trial's reported range (and clamped at its ends) on an
    evenly-spaced grid — the input format for batched curve-regression
    models (``algorithms/regression.py``): fixed T regardless of each
    trial's measurement cadence.
    """

    extractor: TimedLabelsExtractor
    num_steps: int = 16

    def to_arrays(
        self, trials: Sequence[trial_.Trial], *, max_position: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        curves = self.extractor.convert(trials)
        if max_position is None:
            tops = [c.positions.max() for c in curves if len(c.positions)]
            max_position = float(max(tops)) if tops else 1.0
        grid = np.linspace(0.0, max_position, self.num_steps)
        n = len(trials)
        m = len(self.extractor.metrics)
        values = np.full((n, self.num_steps, m), np.nan)
        for i, c in enumerate(curves):
            if not len(c.positions):
                continue
            order = np.argsort(c.positions)
            pos, val = c.positions[order], c.values[order]
            for j in range(m):
                finite = np.isfinite(val[:, j])
                if finite.any():
                    values[i, :, j] = np.interp(grid, pos[finite], val[finite, j])
        return values, grid

    def to_xty(
        self,
        trials: Sequence[trial_.Trial],
        search_space,
        *,
        max_position: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(X [N, D], t [T], Y [N, T, M]): the spatio-temporal model input.

        Spatial features via the standard
        search-space encoding (continuous block + categorical indices
        appended as float columns), timestamps normalized to [0, 1].
        """
        from vizier_tpu_torch.converters import core as converters_core

        enc = converters_core.SearchSpaceEncoder(search_space)
        cont, cat = enc.encode(trials)
        x = np.concatenate([cont, cat.astype(np.float64)], axis=1)
        y, grid = self.to_arrays(trials, max_position=max_position)
        t = self.extractor.to_timestamps(grid, max_position=max_position)
        return x, t, y
