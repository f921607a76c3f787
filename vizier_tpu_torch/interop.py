"""Carries GP parameters and data from numpy arrays into the port's tensors.

The JAX package's GP parameter dict and ``GPData`` use the same names and
layouts as the port's (the port adds a leading batch axis where the JAX
package ``vmap``s). These functions take either package's values as numpy
arrays (``np.asarray`` of a ``jax.Array`` works), so a caller can hand
trained parameters across and have both packages compute one posterior.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import gp as gp_lib

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
