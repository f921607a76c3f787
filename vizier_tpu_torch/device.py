"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller says.

    Raises instead of falling back to the CPU when CUDA is asked for and no
    GPU is present. On CUDA it pins float32 matrix products and convolutions
    to full precision (TF32 off): the Gram, predict and Cholesky paths are
    held to the float32 reference, and TF32 keeps about three digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vizier_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain PyTorch path."
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev!r}; use 'cuda' or 'cpu'.")
    return dev


def check(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raises when ``tensor`` is not on the entry point's ``device``."""
    if tensor.device != device:
        raise ValueError(f"{what} is on {tensor.device}, expected {device}.")
