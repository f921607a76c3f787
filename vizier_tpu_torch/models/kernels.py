"""ARD Matern-5/2 kernel over mixed continuous + categorical features.

Counterpart of the JAX package's ``models/kernels.py``. Parameters carry a leading
batch axis ``B`` (restarts or ensemble members, the JAX package's ``vmap``
axis, times the studies of a cross-study flush). Each input (continuous
features, categorical codes, row masks) is shared across the batch
(``[N, D]``, ``[N]``) or has one block per group of ``B / S`` consecutive
members (``[S, N, D]``, ``[S, N]``): a study's restarts read their study's
rows without copies. ``S`` is ``B`` for input warping's per-member
features. The result is ``[B, N, M]``.

``matern52_ard`` dispatches on the device of its features: a CUDA tensor goes
to the hand-written kernels in ``csrc/matern52.cu`` (K1 forward, K2
backward, joined by an ``autograd.Function``); a CPU tensor goes to the plain
version, which mirrors the JAX function line for line, including its switch
to the ``||a||² − 2a·b + ||b||²`` expansion above 64 dims. The CUDA kernel
keeps exact differences at every width.

Two optional modes fold the JAX package's ``models/gp.py`` masking into the
kernel: row masks zero every pair with a padded row (``GPState.predict``'s
``k*``), and a per-batch diagonal value gives ``_masked_gram``'s
``K + (noise² + jitter)·I`` on valid rows and identity on padded rows. When
both sides are the same tensors (the Gram) the CUDA kernels compute each
distinct pair once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch

from vizier_tpu_torch.ops import native

Tensor = torch.Tensor

_SQRT5 = 2.2360679774997896
_DIRECT_DIST_MAX_DIM = 64

# Launches of each CUDA wrapper, one per call that launched its kernels, by
# mode: "gram" (both sides the same tensors: _masked_gram), "cross"
# (row-masked cross kernel: predict) and "other" (neither). A K2 launch that
# also runs its feature-gradient kernel (an acquisition's gradient with
# respect to its query points, input warping) counts as "features" instead.
# A wrapper's total is the sum over its modes.
LAUNCHES_BY_MODE: Dict[str, Dict[str, int]] = {
    "matern52_ard_fwd": {"gram": 0, "cross": 0, "other": 0},
    "matern52_ard_bwd": {"gram": 0, "cross": 0, "other": 0, "features": 0},
}


def reset_launch_counts() -> None:
    for modes in LAUNCHES_BY_MODE.values():
        for mode in modes:
            modes[mode] = 0


def _count_launch(name: str, symmetric: int, masked: bool, features: bool = False) -> None:
    mode = "features" if features else "gram" if symmetric else "cross" if masked else "other"
    LAUNCHES_BY_MODE[name][mode] += 1


class LaunchShape(NamedTuple):
    """All of a launch but its values: sizes, each input's leading axis
    (None: not given, 0: shared by every member, S: one block per group or
    member), the mode and whether a noise diagonal is added."""

    batch: int
    n: int
    m: int
    dc: int
    ds: int
    x1: Optional[int]
    z1: Optional[int]
    x2: Optional[int]
    z2: Optional[int]
    mask1: Optional[int]
    mask2: Optional[int]
    symmetric: int
    diag: bool


# While a set, each CUDA wrapper adds (its name, LaunchShape) of every launch
# to it: a caller that must hold each shape it ran to the plain version sets
# it, runs, and reads it back.
LAUNCH_SHAPES: Optional[Set[Tuple[str, LaunchShape]]] = None


def launch_shape(x1, z1, x2, z2, inv_cont, inv_sq_cat, mask1, mask2, diag,
                 symmetric: int) -> LaunchShape:
    def lead(t: Optional[Tensor], base_dim: int) -> Optional[int]:
        return None if t is None else (t.shape[0] if t.dim() > base_dim else 0)

    return LaunchShape(
        inv_cont.shape[0], x1.shape[-2], x2.shape[-2], inv_cont.shape[1], inv_sq_cat.shape[1],
        lead(x1, 2), lead(z1, 2), lead(x2, 2), lead(z2, 2), lead(mask1, 1), lead(mask2, 1),
        int(symmetric), diag is not None)


def _record_shape(name: str, c: _Launch, x1, z1, x2, z2, inv_cont, inv_sq_cat, mask1, mask2,
                  diag) -> None:
    if LAUNCH_SHAPES is not None:
        LAUNCH_SHAPES.add((name, launch_shape(x1, z1, x2, z2, inv_cont, inv_sq_cat, mask1,
                                              mask2, diag, c.symmetric)))


def matern52(sq_dist: Tensor) -> Tensor:
    """Matern-5/2 of a *squared* scaled distance."""
    d = torch.sqrt(torch.clamp(sq_dist, min=1e-20))
    return (1.0 + _SQRT5 * d + (5.0 / 3.0) * sq_dist) * torch.exp(-_SQRT5 * d)


def _batched(x: Tensor, batch: int) -> Tensor:
    return x if x.dim() == 3 else x.unsqueeze(0).expand(batch, *x.shape)


def group_count(batch: int, *inputs: Optional[Tensor], base_dims: Tuple[int, ...]) -> int:
    """The number S of groups the batched ``inputs`` hold (1 when all are
    shared). ``base_dims[i]`` is input i's rank when shared; a batched input
    has one more leading axis, of length S, and S must divide ``batch``."""
    groups = {t.shape[0] for t, d in zip(inputs, base_dims) if t is not None and t.dim() > d}
    if len(groups) > 1:
        raise ValueError(f"Batched inputs disagree on their group count: {sorted(groups)}.")
    s = groups.pop() if groups else 1
    if s < 1 or batch % s:
        raise ValueError(f"{s} groups do not divide a batch of {batch}.")
    return s


def per_member(t: Optional[Tensor], groups: int, batch: int, base_dim: int) -> Optional[Tensor]:
    """A grouped input [S, ...] repeated to one block per member [B, ...];
    a shared (or absent) input as it is."""
    if t is None or t.dim() == base_dim or groups == batch:
        return t
    return torch.repeat_interleave(t, batch // groups, dim=0)


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


def _mismatch(z1: Tensor, z2: Tensor) -> Tensor:
    """[(B,) N, M, S] float mismatches of [(B,) N, S] and [(B,) M, S] codes."""
    return (z1[..., :, None, :] != z2[..., None, :, :]).to(torch.float32)


def categorical_sq_distance(z1: Tensor, z2: Tensor, inv_sq: Tensor) -> Tensor:
    """[(B,) N, S] int, [(B,) M, S] int, squared inverse scales [B, S] -> [B, N, M]."""
    if z1.shape[-1] == 0:
        return torch.zeros(
            (inv_sq.shape[0], z1.shape[-2], z2.shape[-2]), dtype=torch.float32, device=z1.device
        )
    if z1.dim() == 2 and z2.dim() == 2:
        return torch.einsum("nms,bs->bnm", _mismatch(z1, z2), inv_sq)
    batch = inv_sq.shape[0]
    mismatch = _mismatch(_batched(z1, batch), _batched(z2, batch))  # [B, N, M, S]
    return torch.einsum("bnms,bs->bnm", mismatch, inv_sq)


class MixedFeatures(NamedTuple):
    """Plain-tensor view of model inputs (already scaled/indexed)."""

    continuous: Tensor  # [N, Dc] (or [S, N, Dc]) float32
    categorical: Tensor  # [N, Ds] (or [S, N, Ds]) int32


def pair_mask(mask1: Optional[Tensor], mask2: Optional[Tensor]) -> Optional[Tensor]:
    """[(B,) N, M] (or [(B,) 1, M] / [(B,) N, 1]) validity of each pair, None
    when unmasked; masks are [N] / [M] or per member [B, N] / [B, M]."""
    if mask1 is None and mask2 is None:
        return None
    if mask1 is None:
        return mask2[..., None, :]
    if mask2 is None:
        return mask1[..., :, None]
    return mask1[..., :, None] & mask2[..., None, :]


def apply_masks(
    k: Tensor, mask1: Optional[Tensor], mask2: Optional[Tensor], diag: Optional[Tensor]
) -> Tensor:
    """The JAX package's masking around the kernel matrix [B, N, M]: zero where
    either row is padded; with ``diag`` [B] (square Gram, ``mask1`` the row
    mask) add ``diag`` on the valid diagonal and 1 on the padded one."""
    pair = pair_mask(mask1, mask2)
    if pair is not None:
        k = torch.where(pair, k, torch.zeros_like(k))
    if diag is not None:
        d = diag[:, None].expand(-1, k.shape[-1])
        if mask1 is not None:
            d = torch.where(mask1, d, torch.ones_like(d))
        k = k + torch.diag_embed(d)
    return k


def gram_diag_grad(grad: Tensor, mask: Optional[Tensor]) -> Tensor:
    """[B] gradient of the diagonal value: grad's valid diagonal, summed
    (``mask`` [N], or [S, N] for S groups of members)."""
    d = torch.diagonal(grad, dim1=-2, dim2=-1)
    if mask is not None:
        mask = per_member(mask, mask.shape[0] if mask.dim() == 2 else 1, d.shape[0], 1)
        d = torch.where(mask, d, torch.zeros_like(d))
    return torch.sum(d, dim=-1)


def matern52_ard_fwd_plain(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    mask1: Optional[Tensor] = None, mask2: Optional[Tensor] = None,
    diag: Optional[Tensor] = None,
) -> Tensor:
    """Plain PyTorch version of K1: the (masked) kernel matrix [B, N, M].

    Grouped inputs are repeated to one block per member first, so each
    member computes exactly what an ungrouped call on its own rows would.
    """
    batch = amplitude.shape[0]
    s = group_count(batch, x1, z1, x2, z2, mask1, mask2, base_dims=(2, 2, 2, 2, 1, 1))
    x1, z1, x2, z2 = (per_member(t, s, batch, 2) for t in (x1, z1, x2, z2))
    mask1, mask2 = (per_member(t, s, batch, 1) for t in (mask1, mask2))
    sq = scaled_sq_distance_continuous(x1, x2, inv_cont)
    sq = sq + categorical_sq_distance(z1, z2, inv_sq_cat)
    k = (amplitude * amplitude)[:, None, None] * matern52(sq)
    return apply_masks(k, mask1, mask2, diag)


def matern52_ard_bwd_plain(
    grad: Tensor, x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    mask1: Optional[Tensor] = None, mask2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K2, in the kernel's closed form.

    Returns the gradients with respect to (amplitude [B], inv_cont [B, Dc],
    inv_sq_cat [B, Ds], x1, x2) given ``grad`` [B, N, M], using
    dk/d(r²) = −(5/6)·amp²·(1 + √5 r)·exp(−√5 r) on exact differences.
    Pairs outside the row masks contribute nothing; the diagonal value's
    gradient is ``gram_diag_grad``. Grouped inputs (``[S, ...]``) are
    repeated to one block per member; a grouped side's feature gradient is
    then summed over its group's members.
    """
    batch = amplitude.shape[0]
    s = group_count(batch, x1, z1, x2, z2, mask1, mask2, base_dims=(2, 2, 2, 2, 1, 1))
    grouped = (x1.dim() == 3, x2.dim() == 3)
    x1, z1, x2, z2 = (per_member(t, s, batch, 2) for t in (x1, z1, x2, z2))
    mask1, mask2 = (per_member(t, s, batch, 1) for t in (mask1, mask2))
    pair = pair_mask(mask1, mask2)
    if pair is not None:
        grad = torch.where(pair, grad, torch.zeros_like(grad))
    diff = _batched(x1, batch)[:, :, None, :] - _batched(x2, batch)[:, None, :, :]
    scaled = diff * inv_cont[:, None, None, :]
    sq = torch.sum(scaled * scaled, dim=-1)
    mismatch = _mismatch(_batched(z1, batch), _batched(z2, batch))  # [B, N, M, S]
    sq = sq + torch.einsum("bnms,bs->bnm", mismatch, inv_sq_cat)
    r = torch.sqrt(torch.clamp(sq, min=1e-20))
    ex = torch.exp(-_SQRT5 * r)
    amp = amplitude[:, None, None]
    g_amp = torch.sum(grad * 2.0 * amp * (1.0 + _SQRT5 * r + (5.0 / 3.0) * sq) * ex, dim=(1, 2))
    w = grad * amp * amp * (-5.0 / 6.0) * (1.0 + _SQRT5 * r) * ex  # dL/d(r²)
    g_inv = 2.0 * inv_cont * torch.einsum("bnm,bnmd->bd", w, diff * diff)
    g_inv_sq = torch.einsum("bnm,bnms->bs", w, mismatch)
    gx = 2.0 * w[..., None] * diff * (inv_cont * inv_cont)[:, None, None, :]
    gx1 = gx.sum(dim=2)
    gx2 = -gx.sum(dim=1)

    def fold(g: Tensor, was_grouped: bool) -> Tensor:
        if not was_grouped:
            return g.sum(dim=0)
        return g.reshape(s, batch // s, *g.shape[1:]).sum(dim=1)

    return g_amp, g_inv, g_inv_sq, fold(gx1, grouped[0]), fold(gx2, grouped[1])


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class _Launch(NamedTuple):
    """A validated launch: sizes, group strides and mode."""

    batch: int
    n: int
    m: int
    dc: int
    ds: int
    strides: Tuple[int, int, int, int, int, int]  # x1, x2, z1, z2, mask1, mask2
    group: int
    symmetric: int


def _check_cuda(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    mask1: Optional[Tensor], mask2: Optional[Tensor], diag: Optional[Tensor],
) -> _Launch:
    """Validates the kernels' inputs and works out their group strides."""
    device = x1.device
    for name, t, dtype in (
        ("x1", x1, torch.float32), ("z1", z1, torch.int32),
        ("x2", x2, torch.float32), ("z2", z2, torch.int32),
        ("amplitude", amplitude, torch.float32), ("inv_cont", inv_cont, torch.float32),
        ("inv_sq_cat", inv_sq_cat, torch.float32), ("mask1", mask1, torch.bool),
        ("mask2", mask2, torch.bool), ("diag", diag, torch.float32),
    ):
        if t is None:
            continue
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
    if z1.shape[-2:] != (n, ds) or z2.shape[-2:] != (m, ds):
        raise ValueError(f"Categorical shapes {z1.shape}, {z2.shape} != ({n}|{m}, {ds}).")
    if batch < 1:
        raise ValueError(f"Unsupported launch shape B={batch}, N={n}, M={m}.")
    groups = group_count(batch, x1, z1, x2, z2, mask1, mask2, base_dims=(2, 2, 2, 2, 1, 1))
    for t, rows in ((mask1, n), (mask2, m)):
        if t is not None and t.shape[-1] != rows:
            raise ValueError(f"Row masks must be [{n}] and [{m}] (or per group).")
    if diag is not None and (diag.shape != (batch,) or n != m):
        raise ValueError(f"diag must be [{batch}] on a square kernel matrix, got N={n}, M={m}.")
    if batch > 65535 or n * m > 2**31 - 1:
        raise ValueError(f"Unsupported launch shape B={batch}, N={n}, M={m}.")

    def stride(t: Optional[Tensor], base_dim: int) -> int:
        return t[0].numel() if t is not None and t.dim() > base_dim else 0

    strides = (stride(x1, 2), stride(x2, 2), stride(z1, 2), stride(z2, 2),
               stride(mask1, 1), stride(mask2, 1))
    # The Gram: both sides are the same storage, batching and mask.
    symmetric = (
        x1.data_ptr() == x2.data_ptr() and x1.shape == x2.shape
        and z1.data_ptr() == z2.data_ptr() and z1.shape == z2.shape
        and _ptr(mask1) == _ptr(mask2)
        and (mask1 is None or mask1.shape == mask2.shape)
    )
    return _Launch(batch, n, m, dc, ds, strides, batch // groups, int(symmetric))


def matern52_ard_fwd_cuda(
    x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    mask1: Optional[Tensor] = None, mask2: Optional[Tensor] = None,
    diag: Optional[Tensor] = None,
) -> Tensor:
    """K1: launches the forward kernel; returns [B, N, M]."""
    c = _check_cuda(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2, diag)
    out = torch.empty((c.batch, c.n, c.m), dtype=torch.float32, device=x1.device)
    if c.n == 0 or c.m == 0:
        return out
    lib = native.library()
    # The runtime launches on its current device: make it the tensors' one.
    with torch.cuda.device(x1.device):
        status = lib.matern52_ard_fwd(
            _ptr(x1), _ptr(z1), _ptr(x2), _ptr(z2), _ptr(amplitude), _ptr(inv_cont),
            _ptr(inv_sq_cat), _ptr(mask1), _ptr(mask2), _ptr(diag), *c.strides, c.group,
            c.batch, c.n, c.m, c.dc, c.ds, c.symmetric, _ptr(out),
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
        native.check(status, "matern52_ard_fwd")
    _count_launch("matern52_ard_fwd", c.symmetric, mask1 is not None or mask2 is not None)
    _record_shape("matern52_ard_fwd", c, x1, z1, x2, z2, inv_cont, inv_sq_cat, mask1, mask2, diag)
    return out


def matern52_ard_bwd_cuda(
    grad: Tensor, x1: Tensor, z1: Tensor, x2: Tensor, z2: Tensor,
    amplitude: Tensor, inv_cont: Tensor, inv_sq_cat: Tensor,
    mask1: Optional[Tensor] = None, mask2: Optional[Tensor] = None,
    *, need_x1: bool = False, need_x2: bool = False,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """K2: launches the backward kernels.

    Returns the gradients with respect to (amplitude, inv_cont, inv_sq_cat,
    x1, x2); the feature gradients are None unless asked for.
    """
    c = _check_cuda(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2, None)
    batch, n, m, dc, ds = c.batch, c.n, c.m, c.dc, c.ds
    grad = grad.contiguous()
    if grad.shape != (batch, n, m) or grad.dtype != torch.float32 or grad.device != x1.device:
        raise ValueError(f"grad must be float32 [{batch}, {n}, {m}] on {x1.device}.")
    lib = native.library()
    device = x1.device
    p = 1 + dc + ds
    need_w = (need_x1 or need_x2) and dc > 0
    # The feature gradients need dL/d(r²) of every ordered pair.
    upper_tiles = int(c.symmetric and not need_w)
    blocks = lib.matern52_bwd_num_blocks(batch, n, m, upper_tiles)
    grads = torch.empty((batch, p), dtype=torch.float32, device=device)
    partials = torch.empty((batch, max(blocks, 1), p), dtype=torch.float32, device=device)
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
            _ptr(inv_cont), _ptr(inv_sq_cat), _ptr(mask1), _ptr(mask2), *c.strides, c.group,
            batch, n, m, dc, ds, upper_tiles,
            _ptr(grads), _ptr(partials), _ptr(w), _ptr(gx1), _ptr(gx2),
            torch.cuda.current_stream(device).cuda_stream,
        )
        native.check(status, "matern52_ard_bwd")
    _count_launch("matern52_ard_bwd", c.symmetric, mask1 is not None or mask2 is not None,
                  features=need_w)
    _record_shape("matern52_ard_bwd", c, x1, z1, x2, z2, inv_cont, inv_sq_cat, mask1, mask2, None)
    return grads[:, 0], grads[:, 1 : 1 + dc], grads[:, 1 + dc :], gx1, gx2


class _Matern52ArdCuda(torch.autograd.Function):
    """K1 forward with K2 as its backward."""

    @staticmethod
    def forward(ctx, x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2, diag):
        ctx.save_for_backward(x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2)
        return matern52_ard_fwd_cuda(
            x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2, diag)

    @staticmethod
    def backward(ctx, grad):
        x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2 = ctx.saved_tensors
        g_amp, g_inv, g_inv_sq, gx1, gx2 = matern52_ard_bwd_cuda(
            grad, x1, z1, x2, z2, amplitude, inv_cont, inv_sq_cat, mask1, mask2,
            need_x1=ctx.needs_input_grad[0], need_x2=ctx.needs_input_grad[2],
        )
        g_diag = gram_diag_grad(grad, mask1) if ctx.needs_input_grad[9] else None
        return gx1, None, gx2, None, g_amp, g_inv, g_inv_sq, None, None, g_diag


def matern52_ard(
    f1: MixedFeatures,
    f2: MixedFeatures,
    *,
    amplitude: Tensor,
    continuous_length_scales: Tensor,
    categorical_length_scales: Tensor,
    continuous_dim_mask: Optional[Tensor] = None,
    categorical_dim_mask: Optional[Tensor] = None,
    row_mask1: Optional[Tensor] = None,
    row_mask2: Optional[Tensor] = None,
    diag: Optional[Tensor] = None,
) -> Tensor:
    """Batched mixed-feature ARD Matern-5/2 kernel matrix [B, N, M].

    ``amplitude`` [B], ``continuous_length_scales`` [B, Dc] and
    ``categorical_length_scales`` [B, Ds]; masked dims drop out of the
    distance. ``row_mask1`` [N] / ``row_mask2`` [M] zero the pairs with a
    padded row; ``diag`` [B] (square matrix, ``row_mask1`` the row mask) is
    added on the valid diagonal, and the padded diagonal is 1. Features,
    codes, row masks and dim masks may each carry a leading group axis S
    (S divides B: member b belongs to group b // (B / S)). CUDA features go
    to K1/K2, CPU features to the plain version.
    """
    batch = amplitude.shape[0]

    def member_dim_mask(mask: Optional[Tensor]) -> Optional[Tensor]:
        return per_member(mask, mask.shape[0], batch, 1) if mask is not None else None

    inv = 1.0 / continuous_length_scales
    if continuous_dim_mask is not None:
        mask = member_dim_mask(continuous_dim_mask)
        inv = torch.where(mask, inv, torch.zeros_like(inv))
    inv_sq = 1.0 / (categorical_length_scales * categorical_length_scales)
    if categorical_dim_mask is not None:
        mask = member_dim_mask(categorical_dim_mask)
        inv_sq = torch.where(mask, inv_sq, torch.zeros_like(inv_sq))
    args = (
        f1.continuous, f1.categorical, f2.continuous, f2.categorical,
        amplitude, inv, inv_sq, row_mask1, row_mask2, diag,
    )
    if f1.continuous.is_cuda:
        return _Matern52ArdCuda.apply(*(None if a is None else a.contiguous() for a in args))
    return matern52_ard_fwd_plain(*args)
