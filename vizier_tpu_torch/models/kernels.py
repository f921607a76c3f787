"""ARD Matern-5/2 kernel over mixed continuous + categorical features.

Counterpart of the JAX package's ``models/kernels.py``. Parameters carry a leading
batch axis ``B`` (restarts or ensemble members, the JAX package's ``vmap``
axis); features are shared across the batch (``[N, D]``) or batched
(``[B, N, D]``, input warping). The result is ``[B, N, M]``.

``matern52_ard`` dispatches on the device of its features: a CUDA tensor goes
to the hand-written kernels in ``csrc/matern52.cu`` (K1 forward, K2
backward, joined by an ``autograd.Function``); a CPU tensor goes to the plain
version, which mirrors the JAX function line for line, including its switch
to the ``||a||² − 2a·b + ||b||²`` expansion above 64 dims. The CUDA kernel
keeps exact differences at every width.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from vizier_tpu_torch.ops import native

Tensor = torch.Tensor

_SQRT5 = 2.2360679774997896
_DIRECT_DIST_MAX_DIM = 64

# Launches of each CUDA wrapper, one per call that launched its kernels.
LAUNCHES: Dict[str, int] = {"matern52_ard_fwd": 0, "matern52_ard_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def matern52(sq_dist: Tensor) -> Tensor:
    """Matern-5/2 of a *squared* scaled distance."""
    d = torch.sqrt(torch.clamp(sq_dist, min=1e-20))
    return (1.0 + _SQRT5 * d + (5.0 / 3.0) * sq_dist) * torch.exp(-_SQRT5 * d)


def _batched(x: Tensor, batch: int) -> Tensor:
    return x if x.dim() == 3 else x.unsqueeze(0).expand(batch, *x.shape)


def scaled_sq_distance_continuous(x1: Tensor, x2: Tensor, inv: Tensor) -> Tensor:
    """[(B,) N, D], [(B,) M, D], inverse length scales [B, D] -> [B, N, M].

    Exact differences for D <= 64: the matmul expansion loses ~1e-3 to
    float32 cancellation on near-duplicate points, which poisons the
    Cholesky diagonal. Wider spaces use the expansion with clamping.
    """
    a = _batched(x1, inv.shape[0]) * inv[:, None, :]
    b = _batched(x2, inv.shape[0]) * inv[:, None, :]
    if x1.shape[-1] <= _DIRECT_DIST_MAX_DIM:
        diff = a[:, :, None, :] - b[:, None, :, :]
        return torch.sum(diff * diff, dim=-1)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).transpose(-1, -2)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def categorical_sq_distance(z1: Tensor, z2: Tensor, inv_sq: Tensor) -> Tensor:
    """[N, S] int, [M, S] int, squared inverse scales [B, S] -> [B, N, M]."""
    if z1.shape[-1] == 0:
        return torch.zeros(
            (inv_sq.shape[0], z1.shape[0], z2.shape[0]), dtype=torch.float32, device=z1.device
        )
    mismatch = (z1[:, None, :] != z2[None, :, :]).to(torch.float32)  # [N, M, S]
    return torch.einsum("nms,bs->bnm", mismatch, inv_sq)


class MixedFeatures(NamedTuple):
    """Plain-tensor view of model inputs (already scaled/indexed)."""

    continuous: Tensor  # [N, Dc] (or [B, N, Dc]) float32
    categorical: Tensor  # [N, Ds] int32


def matern52_ard_fwd_plain(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
) -> Tensor:
    """Plain PyTorch version of K1: the kernel matrix [B, N, M]."""
    sq = scaled_sq_distance_continuous(x1, x2, inv_cont)
    sq = sq + categorical_sq_distance(z1, z2, inv_sq_cat)
    return (amplitude * amplitude)[:, None, None] * matern52(sq)


def matern52_ard_bwd_plain(
    grad: Tensor, x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K2, in the kernel's closed form.

    Returns the gradients with respect to (amplitude [B], inv_cont [B, Dc],
    inv_sq_cat [B, Ds], x1, x2) given ``grad`` [B, N, M], using
    dk/d(r²) = −(5/6)·amp²·(1 + √5 r)·exp(−√5 r) on exact differences.
    """
    batch = amplitude.shape[0]
    diff = _batched(x1, batch)[:, :, None, :] - _batched(x2, batch)[:, None, :, :]
    scaled = diff * inv_cont[:, None, None, :]
    sq = torch.sum(scaled * scaled, dim=-1)
    mismatch = (z1[:, None, :] != z2[None, :, :]).to(torch.float32)  # [N, M, S]
    sq = sq + torch.einsum("nms,bs->bnm", mismatch, inv_sq_cat)
    r = torch.sqrt(torch.clamp(sq, min=1e-20))
    ex = torch.exp(-_SQRT5 * r)
    amp = amplitude[:, None, None]
    g_amp = torch.sum(grad * 2.0 * amp * (1.0 + _SQRT5 * r + (5.0 / 3.0) * sq) * ex, dim=(1, 2))
    w = grad * amp * amp * (-5.0 / 6.0) * (1.0 + _SQRT5 * r) * ex  # dL/d(r²)
    g_inv = 2.0 * inv_cont * torch.einsum("bnm,bnmd->bd", w, diff * diff)
    g_inv_sq = torch.einsum("bnm,nms->bs", w, mismatch)
    gx = 2.0 * w[..., None] * diff * (inv_cont * inv_cont)[:, None, None, :]
    gx1 = gx.sum(dim=2)
    gx2 = -gx.sum(dim=1)
    if x1.dim() == 2:
        gx1 = gx1.sum(dim=0)
    if x2.dim() == 2:
        gx2 = gx2.sum(dim=0)
    return g_amp, g_inv, g_inv_sq, gx1, gx2


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
) -> Tuple[int, int, int, int, int, int, int]:
    """Validates the kernels' inputs; returns (B, N, M, Dc, Ds, stride1, stride2)."""
    device = x1.device
    for name, t, dtype in (
        ("x1", x1, torch.float32), ("z1", z1, torch.int32),
        ("x2", x2, torch.float32), ("z2", z2, torch.int32),
        ("amplitude", amplitude, torch.float32), ("inv_cont", inv_cont, torch.float32),
        ("inv_sq_cat", inv_sq_cat, torch.float32),
    ):
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}.")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    batch, dc = inv_cont.shape
    ds = inv_sq_cat.shape[1]
    n, m = x1.shape[-2], x2.shape[-2]
    if amplitude.shape != (batch,) or inv_sq_cat.shape[0] != batch:
        raise ValueError("amplitude/inv_sq_cat must share inv_cont's batch size.")
    if x1.shape[-1] != dc or x2.shape[-1] != dc:
        raise ValueError(f"Continuous widths {x1.shape}, {x2.shape} != {dc}.")
    if z1.shape != (n, ds) or z2.shape != (m, ds):
        raise ValueError(f"Categorical shapes {z1.shape}, {z2.shape} != ({n}|{m}, {ds}).")
    for x in (x1, x2):
        if x.dim() == 3 and x.shape[0] != batch:
            raise ValueError(f"Batched features {x.shape} must have batch {batch}.")
    if batch < 1 or batch > 65535 or (n + 7) // 8 > 65535:
        raise ValueError(f"Unsupported launch shape B={batch}, N={n}.")
    stride1 = n * dc if x1.dim() == 3 else 0
    stride2 = m * dc if x2.dim() == 3 else 0
    return batch, n, m, dc, ds, stride1, stride2


def matern52_ard_fwd_cuda(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
) -> Tensor:
    """K1: launches the forward kernel; returns [B, N, M]."""
    batch, n, m, dc, ds, s1, s2 = _check_cuda(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat)
    out = torch.empty((batch, n, m), dtype=torch.float32, device=x1.device)
    if n == 0 or m == 0:
        return out
    lib = native.library()
    # The runtime launches on its current device: make it the tensors' one.
    with torch.cuda.device(x1.device):
        status = lib.matern52_ard_fwd(
            _ptr(x1), _ptr(z1), _ptr(x2), _ptr(z2), _ptr(amplitude), _ptr(inv_cont),
            _ptr(inv_sq_cat), s1, s2, batch, n, m, dc, ds, _ptr(out),
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
        native.check(status, "matern52_ard_fwd")
    LAUNCHES["matern52_ard_fwd"] += 1
    return out


def matern52_ard_bwd_cuda(
    grad: Tensor, x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    *, need_x1: bool = False, need_x2: bool = False,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """K2: launches the backward kernels.

    Returns the gradients with respect to (amplitude, inv_cont, inv_sq_cat,
    x1, x2); the feature gradients are None unless asked for.
    """
    batch, n, m, dc, ds, s1, s2 = _check_cuda(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat)
    grad = grad.contiguous()
    if grad.shape != (batch, n, m) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be float32 [{batch}, {n}, {m}], got {grad.shape}.")
    lib = native.library()
    device = x1.device
    p = 1 + dc + ds
    blocks = lib.matern52_bwd_num_blocks(n, m)
    grads = torch.empty((batch, p), dtype=torch.float32, device=device)
    partials = torch.empty((batch, max(blocks, 1), p), dtype=torch.float32, device=device)
    need_w = (need_x1 or need_x2) and dc > 0
    w = torch.empty((batch, n, m), dtype=torch.float32, device=device) if need_w else None
    gx1 = torch.empty_like(x1) if need_x1 else None
    gx2 = torch.empty_like(x2) if need_x2 else None
    if need_x1 and not need_w:
        gx1.zero_()
    if need_x2 and not need_w:
        gx2.zero_()
    with torch.cuda.device(device):
        status = lib.matern52_ard_bwd(
            _ptr(grad), _ptr(x1), _ptr(z1), _ptr(x2), _ptr(z2), _ptr(amplitude),
            _ptr(inv_cont), _ptr(inv_sq_cat), s1, s2, batch, n, m, dc, ds,
            _ptr(grads), _ptr(partials), _ptr(w), _ptr(gx1), _ptr(gx2),
            torch.cuda.current_stream(device).cuda_stream,
        )
        native.check(status, "matern52_ard_bwd")
    LAUNCHES["matern52_ard_bwd"] += 1
    return grads[:, 0], grads[:, 1 : 1 + dc], grads[:, 1 + dc :], gx1, gx2


class _Matern52ArdCuda(torch.autograd.Function):
    """K1 forward with K2 as its backward."""

    @staticmethod
    def forward(ctx, x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat):
        ctx.save_for_backward(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat)
        return matern52_ard_fwd_cuda(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat)

    @staticmethod
    def backward(ctx, grad):
        x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat = ctx.saved_tensors
        g_amp, g_inv, g_inv_sq, gx1, gx2 = matern52_ard_bwd_cuda(
            grad, x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat,
            need_x1=ctx.needs_input_grad[0], need_x2=ctx.needs_input_grad[2],
        )
        return gx1, None, gx2, None, g_amp, g_inv, g_inv_sq


def matern52_ard(
    f1: MixedFeatures,
    f2: MixedFeatures,
    *,
    amplitude: Tensor,
    continuous_length_scales: Tensor,
    categorical_length_scales: Tensor,
    continuous_dim_mask: Optional[Tensor] = None,
    categorical_dim_mask: Optional[Tensor] = None,
) -> Tensor:
    """Batched mixed-feature ARD Matern-5/2 kernel matrix [B, N, M].

    ``amplitude`` [B], ``continuous_length_scales`` [B, Dc] and
    ``categorical_length_scales`` [B, Ds]; masked dims drop out of the
    distance. CUDA features go to K1/K2, CPU features to the plain version.
    """
    inv = 1.0 / continuous_length_scales
    if continuous_dim_mask is not None:
        inv = torch.where(continuous_dim_mask, inv, torch.zeros_like(inv))
    inv_sq = 1.0 / (categorical_length_scales * categorical_length_scales)
    if categorical_dim_mask is not None:
        inv_sq = torch.where(categorical_dim_mask, inv_sq, torch.zeros_like(inv_sq))
    args = (
        f1.continuous, f1.categorical, f2.continuous, f2.categorical,
        amplitude, inv, inv_sq,
    )
    if f1.continuous.is_cuda:
        return _Matern52ArdCuda.apply(*(a.contiguous() for a in args))
    return matern52_ard_fwd_plain(*args)
