"""SurrogateConfig: the exact↔sparse auto-switch policy.

Counterpart of the JAX package's ``surrogates/config.py``. Stdlib only. The
decision is made per suggest from the study's completed-trial count:

- below ``sparse_threshold_trials`` the study runs the exact GP;
- at or above it the study switches to the sparse inducing-point surrogate
  (``surrogates.sparse_gp``);
- once sparse, a study only switches back when its trial count drops below
  ``sparse_threshold_trials - hysteresis_trials``, so a study sitting at the
  boundary cannot flap between the two surrogates on alternate suggests.

``from_env`` reads the port's ``VIZIER_TORCH_SPARSE*`` switches for the
serving runtime. The JAX package's crossover listener serves only its
speculative pre-compute plane, which the port does not have.
"""

from __future__ import annotations

import dataclasses

from vizier_tpu_torch.utils import env as env_lib

MODE_EXACT = "exact"
MODE_SPARSE = "sparse"


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """Knobs for the sparse-surrogate auto-switch."""

    # Master switch: False = exact GP always.
    sparse: bool = True
    # Completed trials at which a study crosses exact -> sparse.
    sparse_threshold_trials: int = 512
    # A sparse study only returns to exact below threshold - hysteresis.
    hysteresis_trials: int = 64
    # Inducing-point budget m; the designer pads it like a trial count.
    num_inducing: int = 128
    # Extend the auto-switch to the GP-UCB-PE designer (the service
    # DEFAULT): above the threshold its greedy batch conditions on pending
    # picks through the inducing-point posterior. False pins UCB-PE studies
    # exact regardless of size.
    sparse_ucb_pe: bool = True

    def __post_init__(self):
        if self.sparse_threshold_trials < 1:
            raise ValueError(
                f"sparse_threshold_trials must be >= 1, got {self.sparse_threshold_trials}."
            )
        if self.hysteresis_trials < 0:
            raise ValueError(f"hysteresis_trials must be >= 0, got {self.hysteresis_trials}.")
        if self.num_inducing < 1:
            raise ValueError(f"num_inducing must be >= 1, got {self.num_inducing}.")

    @classmethod
    def from_env(cls) -> "SurrogateConfig":
        """The default config with per-knob environment overrides applied."""
        return cls(
            sparse=env_lib.env_on("VIZIER_TORCH_SPARSE"),
            sparse_threshold_trials=env_lib.env_int("VIZIER_TORCH_SPARSE_THRESHOLD", 512),
            hysteresis_trials=env_lib.env_int("VIZIER_TORCH_SPARSE_HYSTERESIS", 64),
            num_inducing=env_lib.env_int("VIZIER_TORCH_SPARSE_INDUCING", 128),
            sparse_ucb_pe=env_lib.env_on("VIZIER_TORCH_SPARSE_UCB_PE"),
        )

    @classmethod
    def disabled(cls) -> "SurrogateConfig":
        """Exact GP always."""
        return cls(sparse=False)

    def mode_for(self, num_trials: int, current: str = MODE_EXACT) -> str:
        """The surrogate mode for a study with ``num_trials`` completed
        trials, given its ``current`` mode (hysteresis needs history)."""
        if not self.sparse:
            return MODE_EXACT
        if current == MODE_SPARSE:
            floor = self.sparse_threshold_trials - self.hysteresis_trials
            return MODE_SPARSE if num_trials >= floor else MODE_EXACT
        return MODE_SPARSE if num_trials >= self.sparse_threshold_trials else MODE_EXACT

    def as_dict(self) -> dict:
        """JSON-stampable form."""
        return dataclasses.asdict(self)
