"""K2's feature gradients (with respect to the points) against ``jax.grad``.

The same numpy-seeded inputs go through the JAX package's
``models/kernels.py`` ``matern52_ard`` (with ``_masked_gram``'s or
``predict``'s row masks around it, vmapped over a batch's members) and the
port's plain feature gradients: ``matern52_ard_bwd_plain`` (K2 whole) and
``matern52_ard_features_plain`` (the feature kernel alone). The CUDA kernels
are held against these plain versions in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import types

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

# Float32 on both sides. The JAX package differentiates x·inv − x'·inv
# through sqrt(max(r², 1e-20)); the port sums 2·inv²·w·(x − x') in closed
# form. Entries are sums over pairs of terms of both signs, so each is held
# to 1e-4 relative plus 1e-5 of the largest entry.
_RTOL, _ATOL_OF_MAX = 1e-4, 1e-5

# (members B, rows N, M, Dc, Ds) and how each side is laid out: "shared"
# ([N, D]), "batched" (one block per member, [B, N, D]) or "grouped" (one
# block per study, [S, N, D], members b // (B / S)); valid rows per side
# (None: no row mask); masked dims.
_CASES = {
    "continuous": dict(b=1, n=17, m=23, dc=5, ds=0),
    "mixed": dict(b=1, n=19, m=11, dc=4, ds=3),
    "masked_dims": dict(b=1, n=13, m=13, dc=6, ds=3, cont_mask=[1, 1, 0, 1, 0, 0],
                        cat_mask=[1, 0, 1]),
    "padded_rows": dict(b=1, n=12, m=30, dc=3, ds=2, valid1=10, valid2=21),
    "dc1": dict(b=1, n=9, m=14, dc=1, ds=0),
    "dc20": dict(b=1, n=16, m=64, dc=20, ds=0, valid2=60),
    "dc64": dict(b=1, n=8, m=12, dc=64, ds=0),
    "shared_side": dict(b=3, n=10, m=15, dc=4, ds=2, side2="batched", valid2=12),
    "batched_side": dict(b=3, n=10, m=15, dc=4, ds=2, side1="batched", valid1=8),
    "grouped": dict(b=4, n=9, m=13, dc=5, ds=2, side1="grouped", side2="grouped",
                    studies=2, valid1=7, valid2=11),
}


def _inputs(seed, b, n, m, dc, ds, *, side1="shared", side2="shared", studies=None,
            valid1=None, valid2=None, cont_mask=None, cat_mask=None):
    rng = np.random.default_rng(seed)

    def lead(side):
        return {"shared": (), "batched": (b,), "grouped": (studies,)}[side]

    def mask(side, rows, valid):
        if valid is None:
            return None
        count = int(np.prod(lead(side), dtype=int))
        # Block i of a batched or grouped mask has valid - i rows.
        limit = valid - np.arange(max(count, 1))
        out = np.arange(rows)[None, :] < limit[:, None]
        return out.reshape(lead(side) + (rows,))

    return dict(
        x1=rng.uniform(size=lead(side1) + (n, dc)).astype(np.float32),
        z1=rng.integers(0, 3, size=lead(side1) + (n, ds)).astype(np.int32),
        x2=rng.uniform(size=lead(side2) + (m, dc)).astype(np.float32),
        z2=rng.integers(0, 3, size=lead(side2) + (m, ds)).astype(np.int32),
        mask1=mask(side1, n, valid1), mask2=mask(side2, m, valid2),
        amp=rng.uniform(0.5, 2.0, size=b).astype(np.float32),
        cont_ls=rng.uniform(0.2, 2.0, size=(b, dc)).astype(np.float32),
        cat_ls=rng.uniform(0.2, 2.0, size=(b, ds)).astype(np.float32),
        cont_mask=np.ones(dc, bool) if cont_mask is None else np.asarray(cont_mask, bool),
        cat_mask=np.ones(ds, bool) if cat_mask is None else np.asarray(cat_mask, bool),
        weights=rng.normal(size=(b, n, m)).astype(np.float32),
        sides=(side1, side2), studies=studies,
    )


def _member_index(a, side):
    """Member b's block of an input laid out as ``side``, or None (shared)."""
    b = a["amp"].shape[0]
    if side == "shared":
        return None
    if side == "batched":
        return np.arange(b)
    return np.arange(b) // (b // a["studies"])


def _jax_feature_grads(a):
    """jax.grad of sum_b sum(weights_b * masked K_b) with respect to x1, x2:
    the JAX kernel vmapped over the members, each reading its block."""
    idx1, idx2 = (_member_index(a, side) for side in a["sides"])

    def take(x, idx):
        return x if idx is None else x[idx]

    def one(x1, z1, x2, z2, m1, m2, amp, cls, zls, w):
        k = jk.matern52_ard(
            jk.MixedFeatures(x1, z1), jk.MixedFeatures(x2, z2), amplitude=amp,
            continuous_length_scales=cls, categorical_length_scales=zls,
            continuous_dim_mask=jnp.asarray(a["cont_mask"]),
            categorical_dim_mask=jnp.asarray(a["cat_mask"]),
        )
        if m1 is not None:
            k = jnp.where(m1[:, None], k, 0.0)
        if m2 is not None:
            k = jnp.where(m2[None, :], k, 0.0)
        return jnp.sum(w * k)

    def loss(x1, x2):
        args = (take(x1, idx1), take(jnp.asarray(a["z1"]), idx1), take(x2, idx2),
                take(jnp.asarray(a["z2"]), idx2))
        masks = tuple(None if m is None else take(jnp.asarray(m), i)
                      for m, i in ((a["mask1"], idx1), (a["mask2"], idx2)))
        in_axes = (None if idx1 is None else 0, None if idx1 is None else 0,
                   None if idx2 is None else 0, None if idx2 is None else 0,
                   None if masks[0] is None or idx1 is None else 0,
                   None if masks[1] is None or idx2 is None else 0, 0, 0, 0, 0)
        per_member = jax.vmap(one, in_axes=in_axes)(
            *args, *masks, jnp.asarray(a["amp"]), jnp.asarray(a["cont_ls"]),
            jnp.asarray(a["cat_ls"]), jnp.asarray(a["weights"]))
        return jnp.sum(per_member)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a["x1"]), jnp.asarray(a["x2"]))
    return np.asarray(g1), np.asarray(g2)


def _torch_args(a):
    """The port's K2 inputs: (grad, x1, z1, x2, z2, amp, inv, inv_sq, mask1,
    mask2), the scales zeroed on masked dims as ``matern52_ard`` does."""
    t = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    inv = np.where(a["cont_mask"], 1.0 / a["cont_ls"], 0.0).astype(np.float32)
    inv_sq = np.where(a["cat_mask"], 1.0 / a["cat_ls"] ** 2, 0.0).astype(np.float32)
    return (t(a["weights"]), t(a["x1"]), t(a["z1"]), t(a["x2"]), t(a["z2"]), t(a["amp"]),
            t(inv), t(inv_sq), t(a["mask1"]), t(a["mask2"]))


def _plain_feature_grads(version, args):
    if version == "bwd_plain":
        return tk.matern52_ard_bwd_plain(*args)[3:]
    return tk.matern52_ard_features_plain(*args)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=_RTOL, atol=_ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("version", ["bwd_plain", "features_plain"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_feature_gradients_match_jax_grad(case, version):
    a = _inputs(0, **_CASES[case])
    want1, want2 = _jax_feature_grads(a)
    got1, got2 = _plain_feature_grads(version, _torch_args(a))
    assert got1.shape == want1.shape and got2.shape == want2.shape
    _assert_close(got1.numpy(), want1)
    _assert_close(got2.numpy(), want2)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_the_feature_kernels_plain_version_is_k2s_feature_side(case):
    """The feature kernel's plain contract gives K2's plain feature
    gradients bit for bit, each side alone too."""
    args = _torch_args(_inputs(1, **_CASES[case]))
    whole = tk.matern52_ard_bwd_plain(*args)[3:]
    assert all(torch.equal(g, w) for g, w in zip(tk.matern52_ard_features_plain(*args), whole))
    alone = tk.matern52_ard_features_plain(*args, need_x2=False)
    assert alone[1] is None and torch.equal(alone[0], whole[0])
    assert tk.matern52_ard_features_plain(*args, need_x1=False)[0] is None


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


@pytest.mark.parametrize("version", ["bwd_plain", "features_plain"])
@pytest.mark.parametrize("dims", [(3, 5, 2), (20, 20, 0)], ids=["padded_dims", "dc20"])
def test_masked_gram_feature_gradient_matches_jax_grad(dims, version):
    """The Gram through ``_masked_gram``'s row masks (padded rows and padded
    dims): jax.grad with respect to the data's features against the port's
    two sides summed (both sides are the same points)."""
    dc, dc_pad, ds = dims
    jdata = _padded_gp_data(2, 21, 32, dc, dc_pad, ds)
    rng = np.random.default_rng(3)
    params = {"amplitude": np.float32(rng.uniform(0.5, 2.0)),
              "noise_stddev": np.float32(0.1),
              "continuous_length_scales": rng.uniform(0.2, 2.0, dc_pad).astype(np.float32),
              "categorical_length_scales": rng.uniform(0.5, 2.0, ds).astype(np.float32)}
    weights = rng.normal(size=(32, 32)).astype(np.float32)
    jmodel = jgp.VizierGaussianProcess(num_continuous=dc_pad, num_categorical=ds)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(x):
        return jnp.sum(weights * jmodel._masked_gram(jp, jdata.replace(continuous=x)))

    want = np.asarray(jax.grad(loss)(jdata.continuous))
    x = torch.tensor(np.asarray(jdata.continuous))
    z = torch.tensor(np.asarray(jdata.categorical))
    mask = torch.tensor(np.asarray(jdata.row_mask))
    inv = torch.where(torch.tensor(np.asarray(jdata.cont_dim_mask)),
                      1.0 / torch.tensor(params["continuous_length_scales"]), 0.0)[None]
    inv_sq = torch.where(torch.tensor(np.asarray(jdata.cat_dim_mask)),
                         1.0 / torch.tensor(params["categorical_length_scales"]) ** 2, 0.0)[None]
    args = (torch.tensor(weights)[None], x, z, x, z, torch.tensor([params["amplitude"]]), inv,
            inv_sq, mask, mask)
    gx1, gx2 = _plain_feature_grads(version, args)
    _assert_close((gx1 + gx2).numpy(), want)
    assert not np.any(want[~np.asarray(jdata.row_mask)])


# -- the autograd function's flags: parameters held constant ------------------


def _flag_recording_kernels(monkeypatch):
    """Stands the plain versions in for K1 and K2 under the CUDA autograd
    function (there is no card here) and records K2's flags per call."""
    calls = []

    def bwd(grad, *args, need_params=True, need_x1=False, need_x2=False):
        calls.append(dict(need_params=need_params, need_x1=need_x1, need_x2=need_x2))
        if need_params:
            g = tk.matern52_ard_bwd_plain(grad, *args)
            return g[:3] + (g[3] if need_x1 else None, g[4] if need_x2 else None)
        return (None, None, None) + tk.matern52_ard_features_plain(
            grad, *args, need_x1=need_x1, need_x2=need_x2)

    monkeypatch.setattr(tk, "matern52_ard_fwd_cuda", tk.matern52_ard_fwd_plain)
    monkeypatch.setattr(tk, "matern52_ard_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("case", ["dc20", "mixed", "grouped"])
def test_detached_parameters_take_the_feature_kernel_alone(monkeypatch, case):
    """With the parameters constant (an acquisition's query gradient), the
    backward asks K2 for the query side's gradient only, returns None for
    the parameters, and gives the full path's point gradient bit for bit;
    with the parameters requiring a gradient it asks for them too."""
    calls = _flag_recording_kernels(monkeypatch)
    grad, x1, z1, x2, z2, amp, inv, inv_sq, mask1, mask2 = _torch_args(
        _inputs(4, **_CASES[case]))
    results = {}
    for params_need_grad in (False, True):
        leaves = [t.clone().requires_grad_(params_need_grad) for t in (amp, inv, inv_sq)]
        x = x1.clone().requires_grad_(True)
        out = tk._Matern52ArdCuda.apply(x, z1, x2, z2, *leaves, mask1, mask2, None)
        wanted = [x] + (leaves if params_need_grad else [])
        results[params_need_grad] = torch.autograd.grad(out, wanted, grad)
    assert calls == [dict(need_params=False, need_x1=True, need_x2=False),
                     dict(need_params=True, need_x1=True, need_x2=False)]
    assert torch.equal(results[False][0], results[True][0])
    want = tk.matern52_ard_bwd_plain(grad, x1, z1, x2, z2, amp, inv, inv_sq, mask1, mask2)
    assert torch.equal(results[True][0], want[3])
    for got, w in zip(results[True][1:], want[:3]):
        assert torch.equal(got, w)


def test_detached_parameters_get_no_gradient_from_the_backward(monkeypatch):
    """The backward itself, called as autograd calls it: the parameter
    gradients are None when no parameter needs one, as is x2's."""
    _flag_recording_kernels(monkeypatch)
    grad, x1, z1, x2, z2, amp, inv, inv_sq, mask1, mask2 = _torch_args(
        _inputs(5, **_CASES["padded_rows"]))
    ctx = types.SimpleNamespace(
        saved_tensors=(x1, z1, x2, z2, amp, inv, inv_sq, mask1, mask2),
        needs_input_grad=(True,) + (False,) * 9)
    got = tk._Matern52ArdCuda.backward(ctx, grad)
    assert len(got) == 10 and all(g is None for i, g in enumerate(got) if i != 0)
    want = tk.matern52_ard_bwd_plain(grad, x1, z1, x2, z2, amp, inv, inv_sq, mask1, mask2)
    assert torch.equal(got[0], want[3])
