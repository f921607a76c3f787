"""The sparse-GP bandit steps: train and acquisition sweep.

Counterpart of the JAX package's ``surrogates/sparse_bandit.py``, sequential
path. They mirror the exact-GP steps of ``designers.gp_bandit``:

- the same multi-restart L-BFGS over the collapsed bound, with the previous
  optimum prepended as one more restart, and a deterministic mid-scale
  restart (``_heuristic_init``) after it;
- the same acquisition machinery (``ScoringFunction``, ``TrustRegion``, the
  eagle sweep, ``designers.gp_bandit._sweep_studies``) over a
  ``SparseEnsemblePredictive``.

The cross-study flush trains S studies at once
(``_train_sparse_gp_studies``, the JAX package's ``_sparse_flush_program``
train) and takes its warm seeds and sweep from ``designers.gp_bandit``.

This module sits below the designers (``designers.gp_bandit`` imports it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.surrogates import sparse_gp


def _heuristic_init(coll, device: torch.device) -> gp_lib.Params:
    """A deterministic mid-scale restart seed for the collapsed bound.

    The trace term 1/(2σ²)·tr(Knn − Qnn) is stiff at small noise: a random
    init with a tiny ``noise_stddev`` can drive the amplitude to its lower
    clip before the noise rises, and every random restart can land in that
    degenerate corner. One init at unit scales (labels are z-scored by the
    output warper: amplitude 1, length scales 1, noise 0.1) starts inside
    the well-behaved basin; the random restarts keep their exploration role.
    """
    constrained = {
        spec.name: torch.full(
            spec.shape, 0.1 if spec.name == "noise_stddev" else 1.0,
            dtype=torch.float32, device=device,
        )
        for spec in coll.specs
    }
    return coll.unconstrain(constrained)


def _train_sparse_gp(
    model: sparse_gp.SparseGaussianProcess,
    optimizer: lbfgs_lib.LbfgsOptimizer,
    data: gp_lib.GPData,
    generator: torch.Generator,
    num_restarts: int,
    ensemble_size: int,
    warm_start: Optional[gp_lib.Params] = None,
) -> sparse_gp.SparseGPState:
    """Sparse ARD: k-center inducing selection → restarts → L-BFGS → top-k.

    The inducing set is selected once and shared by every restart. Restart
    rows in order: ``warm_start`` (when given), the heuristic row, then
    ``num_restarts`` random rows.
    """
    sdata = sparse_gp.select_inducing_kcenter(data, model.num_inducing)
    coll = model.param_collection()
    inits = coll.batch_random_init_unconstrained(generator, num_restarts)
    rows = [_heuristic_init(coll, data.device)]
    if warm_start is not None:
        rows.insert(0, warm_start)
    inits = {k: torch.cat([r[k][None] for r in rows] + [v]) for k, v in inits.items()}
    result = optimizer(
        lambda p: model.neg_log_likelihood(p, sdata), inits, best_n=ensemble_size
    )
    return model.precompute(result.params, sdata)


def _train_sparse_gp_studies(
    model: sparse_gp.SparseGaussianProcess,
    optimizer: lbfgs_lib.LbfgsOptimizer,
    data: gp_lib.GPData,
    generators: Sequence[torch.Generator],
    num_restarts: int,
    ensemble_size: int,
    warm_start: gp_lib.Params,
) -> sparse_gp.SparseGPState:
    """S studies' sparse ARD as one batch: each study's k-center inducing
    set (picked for all studies at once), then its restart rows as in
    :func:`_train_sparse_gp` (its warm row, the heuristic row, ``num_restarts``
    random rows from ``generators[s]``), one L-BFGS batch, each study's best
    ``ensemble_size``."""
    sdata = sparse_gp.select_inducing_kcenter(data, model.num_inducing)
    coll = model.param_collection()
    heuristic = _heuristic_init(coll, data.device)
    blocks = []
    for s, generator in enumerate(generators):
        inits = coll.batch_random_init_unconstrained(generator, num_restarts)
        blocks.append({
            k: torch.cat([warm_start[k][s : s + 1], heuristic[k][None], v])
            for k, v in inits.items()
        })
    inits = {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
    result = optimizer(
        lambda p: model.neg_log_likelihood(p, sdata), inits,
        best_n=ensemble_size, groups=len(generators),
    )
    return model.precompute(result.params, sdata)


def _prior_features_from_data(data: gp_lib.GPData) -> kernels.MixedFeatures:
    """Top observed points (by warped label) to seed the eagle pool.

    ``k`` follows the padded row count; slots past the valid rows are
    redirected to the best row. The exact path uses it too; a flush's
    stacked data gives each study's points ([S, k, ...]).
    """
    labels = torch.where(data.row_mask, data.labels, torch.full_like(data.labels, float("-inf")))
    k = min(10, data.num_rows)
    idx = torch.sort(labels, dim=-1, descending=True, stable=True).indices[..., :k]
    num_valid = torch.sum(data.row_mask, dim=-1, keepdim=True)
    idx = torch.where(torch.arange(k, device=idx.device) < num_valid, idx, idx[..., :1])
    return kernels.MixedFeatures(
        torch.take_along_dim(data.continuous, idx[..., None], dim=-2),
        torch.take_along_dim(data.categorical, idx[..., None], dim=-2),
    )
