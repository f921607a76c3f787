"""Carries GP parameters and data from numpy arrays into the port's tensors.

The JAX package's GP parameter dict and ``GPData`` use the same names and
layouts as the port's (the port adds a leading batch axis where the JAX
package ``vmap``s). These functions take either package's values as numpy
arrays (``np.asarray`` of a ``jax.Array`` works), so a caller can hand
trained parameters across and have both packages compute one posterior.
The sparse surrogate's ``SparseGPData`` (data, inducing rows, masks and
indices) crosses the same way, so both packages can share one inducing set.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.surrogates import sparse_gp

_PARAM_NAMES = (
    "amplitude",
    "noise_stddev",
    "continuous_length_scales",
    "categorical_length_scales",
    "warp_a",
    "warp_b",
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
