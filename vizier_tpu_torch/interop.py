"""Carries GP parameters and data from numpy arrays into the port's tensors.

The JAX package's GP parameter dict and ``GPData`` use the same names and
layouts as the port's (the port adds a leading batch axis where the JAX
package ``vmap``s). These functions take either package's values as numpy
arrays (``np.asarray`` of a ``jax.Array`` works), so a caller can hand
trained parameters across and have both packages compute one posterior.
The sparse surrogate's ``SparseGPData`` (data, inducing rows, masks and
indices) crosses the same way, so both packages can share one inducing set,
and so do the multi-task GP's parameters and ``MultiTaskData``, the
per-metric posteriors of a multi-objective designer, and a stacked-residual
transfer stack (each level's parameters over its residual data).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import multitask_gp
from vizier_tpu_torch.models import stacked_residual
from vizier_tpu_torch.surrogates import sparse_gp

_PARAM_NAMES = (
    "amplitude",
    "noise_stddev",
    "continuous_length_scales",
    "categorical_length_scales",
    "warp_a",
    "warp_b",
    "mean_scale",
    # The multi-task GP's task covariance.
    "task_chol_diag",
    "task_chol_offdiag",
    "task_corr_chol_vec",
    "task_sqrt_diag",
)
_DATA_FIELDS = {
    "continuous": torch.float32,
    "categorical": torch.int32,
    "labels": torch.float32,
    "row_mask": torch.bool,
    "cont_dim_mask": torch.bool,
    "cat_dim_mask": torch.bool,
}


def gp_params_from_numpy(
    params: Mapping[str, Any], device: device_lib.DeviceLike
) -> Dict[str, torch.Tensor]:
    """A GP parameter dict (constrained or unconstrained) as float32 tensors.

    Shapes are kept as given: a single parameter set has no batch axis, an
    ensemble or restart batch leads with it.
    """
    unknown = set(params) - set(_PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown GP parameters {sorted(unknown)}; expected {_PARAM_NAMES}.")
    dev = device_lib.resolve(device)
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=dev) for k, v in params.items()
    }


def gp_data_from_numpy(data: Any, device: device_lib.DeviceLike) -> gp_lib.GPData:
    """A ``GPData`` from any object with its six fields (e.g. the JAX package's)."""
    dev = device_lib.resolve(device)
    return gp_lib.GPData(
        **{
            name: torch.as_tensor(np.array(getattr(data, name)), device=dev).to(dtype)
            for name, dtype in _DATA_FIELDS.items()
        }
    )


def sparse_gp_data_from_numpy(sdata: Any, device: device_lib.DeviceLike) -> sparse_gp.SparseGPData:
    """A ``SparseGPData`` from any object with its fields (e.g. the JAX
    package's): ``data`` with the six ``GPData`` fields, the inducing rows
    ``z_continuous`` / ``z_categorical``, ``inducing_mask`` and
    ``inducing_indices``."""
    dev = device_lib.resolve(device)
    as_tensor = lambda name, dtype: torch.as_tensor(  # noqa: E731
        np.array(getattr(sdata, name)), device=dev
    ).to(dtype)
    return sparse_gp.SparseGPData(
        data=gp_data_from_numpy(sdata.data, dev),
        z_continuous=as_tensor("z_continuous", torch.float32),
        z_categorical=as_tensor("z_categorical", torch.int32),
        inducing_mask=as_tensor("inducing_mask", torch.bool),
        inducing_indices=as_tensor("inducing_indices", torch.int64),
    )


def multitask_data_from_numpy(data: Any, device: device_lib.DeviceLike) -> multitask_gp.MultiTaskData:
    """A ``MultiTaskData`` from any object with its fields (e.g. the JAX
    package's): ``features_data`` with the six ``GPData`` fields,
    ``task_labels`` [M, N] and ``task_mask`` [M, N]."""
    dev = device_lib.resolve(device)
    return multitask_gp.MultiTaskData(
        features_data=gp_data_from_numpy(data.features_data, dev),
        task_labels=torch.as_tensor(np.array(data.task_labels, dtype=np.float32), device=dev),
        task_mask=torch.as_tensor(np.array(data.task_mask, dtype=bool), device=dev),
    )


def gp_states_from_numpy(
    model: gp_lib.VizierGaussianProcess,
    params: Mapping[str, Any],
    datas: Sequence[Any],
) -> List[gp_lib.GPState]:
    """Per-metric posteriors from a multi-objective designer's trained values:
    constrained ``params`` with leading axes [M, E] (metric, ensemble member)
    and one data object per metric, precomputed by ``model`` on its device."""
    tensors = gp_params_from_numpy(params, model.device)
    return [
        model.precompute_constrained(
            {k: v[j] for k, v in tensors.items()}, gp_data_from_numpy(data, model.device)
        )
        for j, data in enumerate(datas)
    ]


def stacked_residual_from_numpy(
    model: gp_lib.VizierGaussianProcess,
    levels_params: Sequence[Mapping[str, Any]],
    levels_data: Sequence[Any],
) -> stacked_residual.StackedResidualGP:
    """A stacked-residual stack from each level's constrained parameters (one
    set, no batch axis: the JAX package's ``level.params``) and its residual
    data (``level.data``), base level first, precomputed by ``model``."""
    levels = []
    for params, data in zip(levels_params, levels_data):
        tensors = gp_params_from_numpy(params, model.device)
        levels.append(model.precompute_constrained(
            {k: v[None] for k, v in tensors.items()}, gp_data_from_numpy(data, model.device)))
    return stacked_residual.StackedResidualGP(tuple(levels))
