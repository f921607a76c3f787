"""Device selection for the port's entry points."""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]

# torch.linalg's CUDA kernels live in a library PyTorch loads on the first
# linalg call on a card, through a wrapper that refuses a second entry ("lazy
# wrapper should be called at most once"): threads that make their first
# linalg call at once (concurrent ``designer.suggest`` calls, each training
# its own GP) race on it. ``resolve`` loads it once, under this lock, before
# any entry point runs.
_LINALG_LOCK = threading.Lock()
_linalg_loaded = False


def _load_cuda_linalg(dev: torch.device) -> None:
    global _linalg_loaded
    if _linalg_loaded:
        return
    with _LINALG_LOCK:
        if not _linalg_loaded:
            torch.linalg.cholesky_ex(torch.ones((1, 1), device=dev))
            _linalg_loaded = True


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller says.

    Raises instead of falling back to the CPU when CUDA is asked for and no
    GPU is present. On CUDA it pins float32 matrix products and convolutions
    to full precision (TF32 off): the Gram, predict and Cholesky paths are
    held to the float32 reference, and TF32 keeps about three digits. It also
    loads torch.linalg's CUDA library once, so threads may then make their
    first linalg calls at once.
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
        _load_cuda_linalg(dev)
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev!r}; use 'cuda' or 'cpu'.")
    return dev


def check(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raises when ``tensor`` is not on the entry point's ``device``."""
    if tensor.device != device:
        raise ValueError(f"{what} is on {tensor.device}, expected {device}.")
