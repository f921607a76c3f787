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
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import types as jtypes
from vizier_tpu.models import gp as jgp
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
    before = {name: dict(modes) for name, modes in tk.LAUNCHES_BY_MODE.items()}
    a = _inputs(7, n=5, m=6, dc=3, ds=1)
    out, params = _torch_kernel(a, requires_grad=True)
    out.sum().backward()
    assert out.shape == (1, 5, 6)
    assert tk.LAUNCHES_BY_MODE == before


def _padded_gp_data(seed, n, n_pad, dc, dc_pad, ds):
    """The JAX package's GPData with padded rows and padded continuous dims."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, dc)).astype(np.float32)
    z = rng.integers(0, 3, size=(n, ds)).astype(np.int32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    features = jtypes.ContinuousAndCategorical(
        continuous=jtypes.PaddedArray.from_array(x, (n_pad, dc_pad)),
        categorical=jtypes.PaddedArray.from_array(z, (n_pad, ds), fill_value=0),
    )
    labels = jtypes.PaddedArray.from_array(y, (n_pad, 1), fill_value=np.nan)
    return jgp.GPData.from_model_data(jtypes.ModelData(features, labels))


def _gp_params(seed, dc_pad, ds, ls_range=(0.2, 2.0)):
    rng = np.random.default_rng(seed)
    return {
        "amplitude": np.float32(rng.uniform(0.5, 2.0)),
        "noise_stddev": np.float32(rng.uniform(0.01, 0.3)),
        "continuous_length_scales": rng.uniform(*ls_range, dc_pad).astype(np.float32),
        "categorical_length_scales": rng.uniform(0.5, 2.0, ds).astype(np.float32),
    }


def _torch_kernel_args(jdata, params):
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return dict(
        amplitude=t([params["amplitude"]]),
        continuous_length_scales=t(params["continuous_length_scales"][None]),
        categorical_length_scales=t(params["categorical_length_scales"][None]),
        continuous_dim_mask=t(jdata.cont_dim_mask),
        categorical_dim_mask=t(jdata.cat_dim_mask),
    )


# Padded rows and padded continuous dims. The wide case takes both packages'
# >64-D expansion, whose float32 cancellation at short scaled distances
# differs between the two matmuls: longer length scales keep it within the
# tolerance, as in _CASES["wide_expansion"].
_GRAM_CASES = {
    "padded_rows_and_dims": dict(n=21, n_pad=32, dc=3, dc_pad=5, ds=2),
    "continuous_only": dict(n=30, n_pad=30, dc=4, dc_pad=4, ds=0),
    "wide": dict(n=9, n_pad=16, dc=70, dc_pad=72, ds=1, ls_range=(2.0, 6.0)),
}


@pytest.mark.parametrize("case", sorted(_GRAM_CASES))
def test_masked_gram_mode_matches_the_jax_masked_gram(case):
    """The kernel's Gram mode (row masks + noise diagonal) against the JAX
    package's ``VizierGaussianProcess._masked_gram``, float32 tolerance."""
    shape = dict(_GRAM_CASES[case])
    ls_range = shape.pop("ls_range", (0.2, 2.0))
    jdata = _padded_gp_data(0, **shape)
    params = _gp_params(1, shape["dc_pad"], shape["ds"], ls_range)
    jmodel = jgp.VizierGaussianProcess(num_continuous=shape["dc_pad"], num_categorical=shape["ds"])
    want = np.asarray(jmodel._masked_gram({k: jnp.asarray(v) for k, v in params.items()}, jdata))
    f = tk.MixedFeatures(torch.tensor(np.asarray(jdata.continuous)),
                         torch.tensor(np.asarray(jdata.categorical)))
    mask = torch.tensor(np.asarray(jdata.row_mask))
    noise = torch.tensor([params["noise_stddev"] ** 2 + 1e-5], dtype=torch.float32)
    got = tk.matern52_ard(f, f, row_mask1=mask, row_mask2=mask, diag=noise,
                          **_torch_kernel_args(jdata, params))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=_RTOL, atol=_ATOL)
    pad = ~np.asarray(jdata.row_mask)
    np.testing.assert_array_equal(got[pad][:, pad], np.eye(int(pad.sum()), dtype=np.float32))
    assert np.all(got[pad][:, ~pad] == 0) and np.all(got[~pad][:, pad] == 0)


def test_masked_cross_mode_matches_the_jax_predict_k_star():
    """The kernel's cross mode (data-side row mask) against the masked k* that
    the JAX package's ``GPState.predict`` forms."""
    jdata = _padded_gp_data(2, n=23, n_pad=32, dc=3, dc_pad=5, ds=2)
    params = _gp_params(3, 5, 2)
    jmodel = jgp.VizierGaussianProcess(num_continuous=5, num_categorical=2)
    rng = np.random.default_rng(4)
    q = rng.uniform(size=(15, 5)).astype(np.float32)
    zq = rng.integers(0, 3, size=(15, 2)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    k_star = jmodel._kernel(jp, jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq)), jdata.features(), jdata)
    want = np.asarray(jnp.where(jdata.row_mask[None, :], k_star, 0.0))
    got = tk.matern52_ard(
        tk.MixedFeatures(torch.tensor(q), torch.tensor(zq)),
        tk.MixedFeatures(torch.tensor(np.asarray(jdata.continuous)),
                         torch.tensor(np.asarray(jdata.categorical))),
        row_mask2=torch.tensor(np.asarray(jdata.row_mask)),
        **_torch_kernel_args(jdata, params),
    )[0].numpy()
    np.testing.assert_allclose(got, want, rtol=_RTOL, atol=_ATOL)
    assert np.all(got[:, ~np.asarray(jdata.row_mask)] == 0)


@pytest.mark.parametrize("masked", [False, True])
def test_gram_diag_grad_matches_autograd(masked):
    """The CUDA path's diagonal gradient (a sum of the incoming gradient's
    valid diagonal) against autograd of the plain masking."""
    rng = np.random.default_rng(5)
    k = torch.tensor(rng.normal(size=(3, 6, 6)).astype(np.float32))
    grad = torch.tensor(rng.normal(size=(3, 6, 6)).astype(np.float32))
    mask = torch.tensor([True, True, False, True, False, True]) if masked else None
    diag = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    (want,) = torch.autograd.grad(tk.apply_masks(k, mask, mask, diag), diag, grad)
    torch.testing.assert_close(tk.gram_diag_grad(grad, mask), want, rtol=0, atol=1e-6)


def test_masked_backward_matches_autograd_of_the_masked_forward():
    """K2's plain version with row masks: pairs outside the masks contribute
    nothing, as the reference's ``where`` blocks their gradient."""
    a = _inputs(6, n=10, m=12, dc=4, ds=2)
    args = [x.clone().requires_grad_(x.is_floating_point()) for x in _plain_args(a)]
    mask1 = torch.arange(10) < 8
    mask2 = torch.arange(12) < 9
    out = tk.matern52_ard_fwd_plain(*args, mask1, mask2)
    grad = torch.tensor(np.random.default_rng(7).normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, [args[4], args[5], args[6], args[0], args[2]], grad)
    got = tk.matern52_ard_bwd_plain(grad, *[x.detach() for x in args], mask1, mask2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=_GRAD_RTOL, atol=1e-5)


# -- grouped inputs: a cross-study flush's per-study rows, codes and masks --

_GROUPED = {
    # (studies S, members per study G, N, M, Dc, Ds, gram)
    "gram_restarts": (3, 2, 16, 16, 4, 0, True),
    "gram_mixed": (2, 3, 12, 12, 3, 2, True),
    "cross_one_member": (4, 1, 7, 16, 4, 0, False),
    "cross_mixed": (2, 2, 5, 9, 3, 2, False),
    "categorical_only": (3, 1, 8, 8, 0, 3, True),
}


def _grouped_inputs(seed, s, g, n, m, dc, ds, gram):
    rng = np.random.default_rng(seed)
    b = s * g
    x1 = rng.uniform(size=(s, n, dc)).astype(np.float32)
    z1 = rng.integers(0, 3, size=(s, n, ds)).astype(np.int32)
    x2 = x1 if gram else rng.uniform(size=(s, m, dc)).astype(np.float32)
    z2 = z1 if gram else rng.integers(0, 3, size=(s, m, ds)).astype(np.int32)
    valid1 = rng.integers(n // 2, n + 1, size=s)
    valid2 = valid1 if gram else rng.integers(m // 2, m + 1, size=s)
    mask1 = np.arange(n)[None, :] < valid1[:, None]
    mask2 = np.arange(m)[None, :] < valid2[:, None]
    return dict(
        x1=x1, z1=z1, x2=x2, z2=z2, mask1=mask1, mask2=mask2,
        amp=rng.uniform(0.5, 2.0, size=b).astype(np.float32),
        cont_ls=rng.uniform(0.2, 2.0, size=(b, dc)).astype(np.float32),
        cat_ls=rng.uniform(0.2, 2.0, size=(b, ds)).astype(np.float32),
        noise=rng.uniform(0.05, 0.2, size=b).astype(np.float32),
        g=g, gram=gram,
    )


def _torch_grouped(a, member=None):
    """The port's kernel on the grouped inputs, or (``member`` b) on member
    b's own study rows with today's shared-input interface."""
    t = torch.tensor
    g, gram = a["g"], a["gram"]
    sel = slice(None) if member is None else slice(member, member + 1)
    study = slice(None) if member is None else member // g
    x1, z1 = t(a["x1"][study]), t(a["z1"][study])
    f1 = tk.MixedFeatures(x1, z1)
    f2 = f1 if gram else tk.MixedFeatures(t(a["x2"][study]), t(a["z2"][study]))
    mask1 = t(a["mask1"][study])
    mask2 = mask1 if gram else t(a["mask2"][study])
    noise = t(a["noise"][sel])
    return tk.matern52_ard(
        f1, f2, amplitude=t(a["amp"][sel]),
        continuous_length_scales=t(a["cont_ls"][sel]),
        categorical_length_scales=t(a["cat_ls"][sel]),
        row_mask1=mask1, row_mask2=mask2,
        diag=noise * noise + 1e-5 if gram else None,
    )


@pytest.mark.parametrize("case", sorted(_GROUPED))
def test_grouped_plain_kernel_equals_the_loop_over_members(case):
    """K1's plain version with per-study rows, codes and masks (group size G)
    gives every member exactly what today's shared-input call on its own
    study's inputs gives."""
    a = _grouped_inputs(1, *_GROUPED[case])
    got = _torch_grouped(a)
    b = got.shape[0]
    want = torch.cat([_torch_grouped(a, member) for member in range(b)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(_GROUPED))
def test_grouped_plain_kernel_matches_the_jax_kernel_vmapped_over_studies(case):
    """The same inputs through the JAX package: ``matern52_ard`` (with
    ``_masked_gram``'s masks and diagonal for a Gram, ``predict``'s k* mask
    for a cross kernel) vmapped over studies and members."""
    a = _grouped_inputs(2, *_GROUPED[case])
    s, g, gram = a["x1"].shape[0], a["g"], a["gram"]
    study = np.repeat(np.arange(s), g)

    def one(x1, z1, x2, z2, m1, m2, amp, cls, zls, noise):
        k = jk.matern52_ard(
            jk.MixedFeatures(x1, z1), jk.MixedFeatures(x2, z2), amplitude=amp,
            continuous_length_scales=cls, categorical_length_scales=zls,
        )
        k = jnp.where(m1[:, None] & m2[None, :], k, 0.0)
        if gram:
            d = jnp.where(m1, noise * noise + 1e-5, 1.0)
            k = k + jnp.diag(d)
        return k

    want = jax.vmap(one)(*(jnp.asarray(a[k][study]) for k in ("x1", "z1", "x2", "z2", "mask1", "mask2")),
                         *(jnp.asarray(a[k]) for k in ("amp", "cont_ls", "cat_ls", "noise")))
    np.testing.assert_allclose(_torch_grouped(a).numpy(), np.asarray(want), rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("case", ["gram_mixed", "cross_mixed"])
def test_grouped_plain_backward_equals_the_loop_over_members(case):
    """K2's plain version with grouped inputs: per-member parameter
    gradients equal the loop over members; a grouped side's feature
    gradient sums its group's members."""
    a = _grouped_inputs(3, *_GROUPED[case])
    t = torch.tensor
    g = a["g"]
    b = a["amp"].shape[0]
    rng = np.random.default_rng(4)
    n, m = a["x1"].shape[1], a["x2"].shape[1]
    grad = t(rng.normal(size=(b, n, m)).astype(np.float32))
    inv = 1.0 / t(a["cont_ls"])
    inv_sq = 1.0 / t(a["cat_ls"]) ** 2
    got = tk.matern52_ard_bwd_plain(
        grad, t(a["x1"]), t(a["z1"]), t(a["x2"]), t(a["z2"]), t(a["amp"]), inv, inv_sq,
        t(a["mask1"]), t(a["mask2"]))
    per_member = [
        tk.matern52_ard_bwd_plain(
            grad[i : i + 1], t(a["x1"][i // g]), t(a["z1"][i // g]), t(a["x2"][i // g]),
            t(a["z2"][i // g]), t(a["amp"][i : i + 1]), inv[i : i + 1], inv_sq[i : i + 1],
            t(a["mask1"][i // g]), t(a["mask2"][i // g]))
        for i in range(b)
    ]
    for k in range(3):
        torch.testing.assert_close(got[k], torch.cat([p[k] for p in per_member]), rtol=0, atol=0)
    for k in (3, 4):
        want = torch.stack([sum(per_member[s * g + j][k] for j in range(g)) for s in range(b // g)])
        torch.testing.assert_close(got[k], want, rtol=1e-6, atol=1e-6)


def test_grouped_inputs_must_agree_on_the_study_count():
    a = _grouped_inputs(5, 3, 2, 6, 6, 2, 0, False)
    t = torch.tensor
    with pytest.raises(ValueError):
        tk.matern52_ard(
            tk.MixedFeatures(t(a["x1"]), t(a["z1"])),
            tk.MixedFeatures(t(a["x2"][:2]), t(a["z2"][:2])),
            amplitude=t(a["amp"]), continuous_length_scales=t(a["cont_ls"]),
            categorical_length_scales=t(a["cat_ls"]),
        )


# -- the launch layouts the card's smoke script records and checks --

_LAYOUTS = {
    # The mixed-space DEFAULT's sweep cross: one study block, data rows masked.
    "cross_one_study": tk.LaunchShape(1, 50, 32, 2, 1, 1, 1, 1, 1, None, 1, 0, False),
    # The ZDT1 bandit's per-metric Gram and sweep: shared inputs.
    "gram_shared": tk.LaunchShape(4, 64, 64, 6, 0, 0, 0, 0, 0, 0, 0, 1, True),
    "cross_shared": tk.LaunchShape(1, 50, 64, 6, 0, 0, 0, 0, 0, None, 0, 0, False),
    # A lockstep flush's cold Gram (8 studies x 5 restarts) and sparse Knm.
    "gram_grouped": tk.LaunchShape(40, 16, 16, 2, 0, 8, 8, 8, 8, 8, 8, 1, True),
    "cross_grouped_both_masked": tk.LaunchShape(48, 40, 24, 3, 2, 8, 8, 8, 8, 8, 8, 0, False),
    "cross_member_x1": tk.LaunchShape(2, 30, 30, 8, 4, 2, 0, 0, 0, None, None, 0, False),
    # Joint qEI's K(q, q): each of 50 candidate batches a group, no masks.
    "gram_grouped_unmasked": tk.LaunchShape(50, 5, 5, 20, 0, 50, 50, 50, 50, None, None, 1,
                                            False),
}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_chip_smoke_rebuilds_each_recorded_launch_layout(name):
    """chip_smoke holds K1/K2 to their plain versions at every layout the
    regret phase recorded: the inputs it builds have that layout exactly
    (launch_shape gives it back), and the plain version runs on them."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    layout = _LAYOUTS[name]
    args, masks = chip_smoke._case_at(torch.Generator().manual_seed(0), layout, device="cpu")
    x1, z1, x2, z2, _, inv, inv_sq = args
    symmetric = int(x1 is x2 and z1 is z2 and masks[0] is masks[1])
    assert tk.launch_shape(x1, z1, x2, z2, inv, inv_sq, *masks, symmetric) == layout
    out = tk.matern52_ard_fwd_plain(*args, *masks)
    assert out.shape == (layout.batch, layout.n, layout.m)
    assert bool(torch.isfinite(out).all())
    for m in masks[:2]:
        if m is not None:
            assert bool(m.any(dim=-1).all()) and not bool(m.all())


def test_concurrent_first_launches_build_the_kernel_library_once(monkeypatch):
    """Threads whose first launches meet call ``native.library()`` at once:
    one runs the build at a time (nvcc writes one partial file per process)."""
    import threading
    import time
    import types

    from vizier_tpu_torch.ops import native

    inside, most = [0], [0]
    lock = threading.Lock()

    def build(source, build_dir):
        del source, build_dir
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.05)
        with lock:
            inside[0] -= 1
        return types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
            "matern52_bwd_num_blocks", "matern52_occupancy", "matern52_force_tile",
            "matern52_ard_fwd", "matern52_ard_bwd")})

    monkeypatch.setattr(native, "build", build)
    native.library.cache_clear()
    try:
        threads = [threading.Thread(target=native.library) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert most[0] == 1
    finally:
        native.library.cache_clear()
