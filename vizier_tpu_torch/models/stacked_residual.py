"""Stacked residual GPs: transfer learning across studies.

Counterpart of the JAX package's ``models/stacked_residual.py``: a base GP
is trained on the oldest prior study's data, and each following level on the
residuals of the stack below it at its own data; a prediction sums the
levels' means and variances. Every level is the port's masked float32 GP,
trained by the injected ARD optimizer; each level's state is a batch of one
member.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StackedResidualGP:
    """Per-level posteriors, base level first, each a batch of one."""

    levels: Tuple[gp_lib.GPState, ...]

    def predict(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        """[Q] mean (the levels' sum) and stddev (root of their variances' sum)."""
        mean = var = None
        for state in self.levels:
            m, s = state.predict(query)
            mean = m[0] if mean is None else mean + m[0]
            var = s[0] * s[0] if var is None else var + s[0] * s[0]
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def train_stacked_residual_gp(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.Optimizer,
    datasets: Sequence[gp_lib.GPData],
    generator: torch.Generator,
    *,
    num_restarts: int = lbfgs_lib.DEFAULT_RANDOM_RESTARTS,
) -> StackedResidualGP:
    """Trains one GP per dataset, each on the residuals of the stack so far.

    ``datasets[0]`` is the oldest prior and the last the current study's
    data; all share the feature widths. Each level draws its restarts from
    ``generator`` in turn and keeps its best one.
    """
    levels: List[gp_lib.GPState] = []
    coll = model.param_collection()
    for data in datasets:
        if levels:
            prior_mean, _ = StackedResidualGP(tuple(levels)).predict(data.features())
            data = dataclasses.replace(
                data, labels=torch.where(data.row_mask, data.labels - prior_mean, data.labels)
            )
        inits = coll.batch_random_init_unconstrained(generator, num_restarts)
        result = optimizer(lambda p, d=data: model.neg_log_likelihood(p, d), inits, best_n=1)
        levels.append(model.precompute(result.params, data))
    return StackedResidualGP(tuple(levels))
