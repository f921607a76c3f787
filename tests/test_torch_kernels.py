"""The port's ARD Matern-5/2 kernel against the JAX package's.

The same numpy-seeded inputs go through ``vizier_tpu.models.kernels`` (on the
CPU) and ``vizier_tpu_torch.models.kernels`` with CPU tensors, which take the
plain PyTorch path. The CUDA kernels (K1, K2) are held against that plain
path in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vizier_tpu.models import kernels as jk
from vizier_tpu_torch.models import kernels as tk

# Float32 on both sides; the sums over D run in another order.
_RTOL, _ATOL = 1e-5, 1e-6
_GRAD_RTOL = 1e-4


def _inputs(seed, n, m, dc, ds, *, cont_mask=None, cat_mask=None, ls_range=(0.2, 2.0)):
    rng = np.random.default_rng(seed)
    return dict(
        x1=rng.uniform(size=(n, dc)).astype(np.float32),
        x2=rng.uniform(size=(m, dc)).astype(np.float32),
        z1=rng.integers(0, 3, size=(n, ds)).astype(np.int32),
        z2=rng.integers(0, 3, size=(m, ds)).astype(np.int32),
        amp=np.float32(rng.uniform(0.5, 2.0)),
        cont_ls=rng.uniform(*ls_range, size=dc).astype(np.float32),
        cat_ls=rng.uniform(*ls_range, size=ds).astype(np.float32),
        cont_mask=np.ones(dc, bool) if cont_mask is None else np.asarray(cont_mask, bool),
        cat_mask=np.ones(ds, bool) if cat_mask is None else np.asarray(cat_mask, bool),
    )


def _jax_kernel(a, amp=None, cont_ls=None, cat_ls=None):
    return jk.matern52_ard(
        jk.MixedFeatures(jnp.asarray(a["x1"]), jnp.asarray(a["z1"])),
        jk.MixedFeatures(jnp.asarray(a["x2"]), jnp.asarray(a["z2"])),
        amplitude=a["amp"] if amp is None else amp,
        continuous_length_scales=jnp.asarray(a["cont_ls"]) if cont_ls is None else cont_ls,
        categorical_length_scales=jnp.asarray(a["cat_ls"]) if cat_ls is None else cat_ls,
        continuous_dim_mask=jnp.asarray(a["cont_mask"]),
        categorical_dim_mask=jnp.asarray(a["cat_mask"]),
    )


def _torch_kernel(a, device="cpu", requires_grad=False):
    t = lambda x, dtype=None: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    amp = t(np.asarray([a["amp"]]))
    cont_ls, cat_ls = t(a["cont_ls"][None]), t(a["cat_ls"][None])
    for p in (amp, cont_ls, cat_ls):
        p.requires_grad_(requires_grad)
    out = tk.matern52_ard(
        tk.MixedFeatures(t(a["x1"]), t(a["z1"])),
        tk.MixedFeatures(t(a["x2"]), t(a["z2"])),
        amplitude=amp,
        continuous_length_scales=cont_ls,
        categorical_length_scales=cat_ls,
        continuous_dim_mask=t(a["cont_mask"]),
        categorical_dim_mask=t(a["cat_mask"]),
    )
    return out, (amp, cont_ls, cat_ls)


_CASES = {
    "continuous": dict(n=17, m=23, dc=5, ds=0),
    "mixed": dict(n=19, m=11, dc=4, ds=3),
    "masked": dict(n=13, m=13, dc=6, ds=3, cont_mask=[1, 1, 0, 1, 0, 0], cat_mask=[1, 0, 1]),
    "categorical_only": dict(n=9, m=7, dc=0, ds=4),
    # Above 64 dims both packages switch to the ||a||^2 - 2ab + ||b||^2 form.
    "wide_expansion": dict(n=12, m=9, dc=80, ds=2, ls_range=(2.0, 6.0)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_matern52_ard_matches_jax(case):
    a = _inputs(0, **_CASES[case])
    want = np.asarray(_jax_kernel(a))
    got, _ = _torch_kernel(a)
    assert got.shape == (1,) + want.shape
    np.testing.assert_allclose(got[0].numpy(), want, rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("case", ["continuous", "mixed", "masked"])
def test_matern52_ard_gradient_matches_jax_grad(case):
    a = _inputs(1, **_CASES[case])
    weights = np.random.default_rng(2).normal(size=(a["x1"].shape[0], a["x2"].shape[0]))
    weights = weights.astype(np.float32)

    def loss(amp, cont_ls, cat_ls):
        return jnp.sum(jnp.asarray(weights) * _jax_kernel(a, amp, cont_ls, cat_ls))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.float32(a["amp"]), jnp.asarray(a["cont_ls"]), jnp.asarray(a["cat_ls"])
    )
    out, params = _torch_kernel(a, requires_grad=True)
    got = torch.autograd.grad(
        torch.sum(torch.tensor(weights) * out[0]), params, materialize_grads=True
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=_GRAD_RTOL, atol=1e-5)


def _plain_args(a):
    t = torch.tensor
    inv = np.where(a["cont_mask"], 1.0 / a["cont_ls"], 0.0).astype(np.float32)
    inv_sq = np.where(a["cat_mask"], 1.0 / a["cat_ls"] ** 2, 0.0).astype(np.float32)
    return (
        t(a["x1"]), t(a["z1"]), t(a["x2"]), t(a["z2"]),
        t(np.asarray([a["amp"]])), t(inv[None]), t(inv_sq[None]),
    )


@pytest.mark.parametrize("same_points", [False, True])
def test_closed_form_backward_matches_autograd(same_points):
    """K2's plain version (dk/d(r²) = −5/6(1+√5r)e^{−√5r}) against autograd of
    the plain forward, which differentiates sqrt(max(r², 1e-20)) as the JAX
    package does. With x1 = x2 the diagonal has r = 0, where the two
    derivatives differ but are multiplied by zero distance gradients."""
    a = _inputs(3, n=10, m=14, dc=5, ds=2)
    if same_points:
        a["x2"], a["z2"] = a["x1"], a["z1"]
    args = [x.clone().requires_grad_(x.is_floating_point()) for x in _plain_args(a)]
    out = tk.matern52_ard_fwd_plain(*args)
    grad = torch.tensor(np.random.default_rng(4).normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, [args[4], args[5], args[6], args[0], args[2]], grad)
    got = tk.matern52_ard_bwd_plain(grad, *[x.detach() for x in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=_GRAD_RTOL, atol=1e-5)


def test_masked_dims_do_not_change_the_kernel():
    """Padded/masked feature dims drop out of the distance (ROADMAP C1)."""
    a = _inputs(5, n=8, m=8, dc=4, ds=2, cont_mask=[1, 1, 0, 0], cat_mask=[1, 0])
    base, _ = _torch_kernel(a)
    b = dict(a)
    rng = np.random.default_rng(6)
    b["x1"] = a["x1"].copy()
    b["x1"][:, 2:] = rng.uniform(size=(8, 2))
    b["z1"] = a["z1"].copy()
    b["z1"][:, 1] = rng.integers(0, 3, size=8)
    moved, _ = _torch_kernel(b)
    torch.testing.assert_close(moved, base, rtol=0, atol=0)


def test_cpu_tensors_never_build_the_cuda_library(monkeypatch):
    from vizier_tpu_torch.ops import native

    def refuse():
        raise AssertionError("CPU tensors must take the plain version")

    monkeypatch.setattr(native, "library", refuse)
    before = dict(tk.LAUNCHES)
    a = _inputs(7, n=5, m=6, dc=3, ds=1)
    out, params = _torch_kernel(a, requires_grad=True)
    out.sum().backward()
    assert out.shape == (1, 5, 6)
    assert tk.LAUNCHES == before
