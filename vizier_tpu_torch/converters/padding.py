"""Shape-quantization schedules.

Parity with ``vizier/pyvizier/converters/padding.py:28,55``:
pads the number of trials and feature dimensions up to quantized sizes, so
the device sees a small set of shapes as a study grows and the padded-row
capacity reserved for batch picks is predictable.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List


class PaddingType(enum.Enum):
    NONE = "NONE"
    MULTIPLES_OF_10 = "MULTIPLES_OF_10"
    POWERS_OF_2 = "POWERS_OF_2"

    def pad(self, n: int) -> int:
        if n < 0:
            raise ValueError(f"Cannot pad negative size {n}.")
        if self == PaddingType.NONE:
            return n
        if self == PaddingType.MULTIPLES_OF_10:
            return max(10, math.ceil(n / 10) * 10)
        # POWERS_OF_2: next power of two, minimum 8.
        return max(8, 1 << max(0, (n - 1)).bit_length())


@dataclasses.dataclass(frozen=True)
class PaddingSchedule:
    """Per-axis padding types for (trials, continuous dims, categorical dims)."""

    num_trials: PaddingType = PaddingType.NONE
    num_features: PaddingType = PaddingType.NONE
    num_metrics: PaddingType = PaddingType.NONE

    def pad_trials(self, n: int) -> int:
        return self.num_trials.pad(n)

    def pad_features(self, n: int) -> int:
        return self.num_features.pad(n)

    def pad_metrics(self, n: int) -> int:
        return self.num_metrics.pad(n)

    def trial_bucket_grid(self, max_trials: int, start: int = 1) -> List[int]:
        """The distinct ``pad_trials`` buckets covering ``start..max_trials``.

        Every study whose trial count is in range lands in exactly one of
        these padded sizes.
        """
        if max_trials < start:
            return []
        out: List[int] = []
        n = start
        while n <= max_trials:
            bucket = self.pad_trials(n)
            out.append(bucket)
            # NONE padding makes every size its own bucket; still terminate.
            n = max(bucket, n) + 1
        return out


DEFAULT_PADDING = PaddingSchedule(
    num_trials=PaddingType.POWERS_OF_2,
    num_features=PaddingType.NONE,
    num_metrics=PaddingType.NONE,
)
