"""The CUDA kernels (K1, K2) and the port's CUDA path, on the card.

Every test here needs a CUDA device: it is marked ``gpu`` and skips where
none is present. The file imports neither JAX nor the JAX package, so it
also runs on a GPU machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.designers import gp_ucb_pe
from vizier_tpu_torch.models import kernels as tk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(device, b, n, m, dc, ds, same=False, batched=False, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x1 = torch.rand((b, n, dc) if batched else (n, dc), generator=gen, device=device)
    x2 = x1 if same else torch.rand((m, dc), generator=gen, device=device)
    z1 = torch.randint(0, 3, (n, ds), generator=gen, device=device, dtype=torch.int32)
    z2 = z1 if same else torch.randint(0, 3, (m, ds), generator=gen, device=device, dtype=torch.int32)
    amp = 0.5 + torch.rand((b,), generator=gen, device=device)
    inv = 1.0 / (0.5 + torch.rand((b, dc), generator=gen, device=device))
    inv_sq = 1.0 / (0.5 + torch.rand((b, ds), generator=gen, device=device)) ** 2
    return x1, z1, x2, z2, amp, inv, inv_sq


def _masks(device, b, n, m, valid1=None, valid2=None, same=False, diag=False):
    """Row masks with the first ``valid`` rows real (None: no mask), and the
    Gram's diagonal value (noise² + jitter) when asked for."""
    mask = lambda rows, valid: None if valid is None else torch.arange(rows, device=device) < valid  # noqa: E731
    mask1 = mask(n, valid1)
    mask2 = mask1 if same else mask(m, valid2)
    d = 0.01 + 0.1 * torch.arange(1, b + 1, device=device, dtype=torch.float32) if diag else None
    return mask1, mask2, d


def _fwd_tol(dc):
    # The plain >64-D forward uses the matmul expansion (float32 cancellation).
    return 1e-3 if dc > 64 else 1e-5


def _assert_grads_close(got_g, want_g):
    for g, w in zip(got_g, want_g):
        if g is None:
            continue
        # Sums over N·M pairs in another order: relative to the largest entry.
        scale = float(torch.max(torch.abs(w))) if w.numel() else 1.0
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)


def _assert_params_within_rounding(got_g, grad, args, mask1=None, mask2=None):
    """Each entry of the parameter gradients within 1e-4 of the sum of its
    terms' magnitudes (the plain version at |grad|: every term is grad times
    a factor of one sign), the bound on float32 sums in another order."""
    want = tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2)[:3]
    sums = tk.matern52_ard_bwd_plain(torch.abs(grad), *args, mask1, mask2)[:3]
    for g, w, t in zip(got_g[:3], want, sums):
        assert torch.all(torch.abs(g - w) <= 1e-4 * torch.abs(t))


@pytest.mark.parametrize(
    "shape",
    [
        dict(b=3, n=64, m=64, dc=20, ds=0, same=True),
        dict(b=1, n=50, m=200, dc=20, ds=0),
        dict(b=2, n=40, m=33, dc=8, ds=4, batched=True),
        dict(b=2, n=31, m=29, dc=80, ds=0),
        dict(b=1, n=7, m=5, dc=0, ds=3),
        dict(b=1, n=1, m=37, dc=20, ds=0),
        dict(b=5, n=300, m=1000, dc=20, ds=2),
        dict(b=5, n=131, m=131, dc=20, ds=0, same=True),
        dict(b=1, n=67, m=67, dc=80, ds=3, same=True, batched=True),
        dict(b=1, n=1024, m=1024, dc=20, ds=0),
    ],
    ids=["gram", "cross", "mixed_batched", "wide", "categorical_only", "one_row_ragged",
         "big_tiles_ragged", "gram_ragged", "gram_wide_batched", "square_cross_b1"],
)
def test_cuda_kernels_match_plain(cuda_device, shape):
    args = _args(cuda_device, **shape)
    want = tk.matern52_ard_fwd_plain(*args)
    got = tk.matern52_ard_fwd_cuda(*args)
    tol = _fwd_tol(shape["dc"])
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    grad = torch.randn(want.shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, need_x1=True, need_x2=True)
    want_g = tk.matern52_ard_bwd_plain(grad, *args)
    _assert_grads_close(got_g, want_g)
    _assert_params_within_rounding(got_g, grad, args)
    if shape.get("same"):
        # Without feature gradients K2 takes the symmetric path.
        sym_g = tk.matern52_ard_bwd_cuda(grad, *args)
        _assert_grads_close(sym_g[:3], want_g[:3])
        _assert_params_within_rounding(sym_g, grad, args)


@pytest.mark.parametrize(
    "case",
    [
        dict(b=5, n=1024, dc=20, ds=0, valid=1000),
        dict(b=1, n=1024, dc=20, ds=0, valid=1000),
        dict(b=2, n=77, dc=0, ds=3, valid=70),
        dict(b=2, n=100, dc=80, ds=0, valid=97),
        dict(b=3, n=90, dc=6, ds=2, valid=85, batched=True),
    ],
    ids=["gram_1000_of_1024_b5", "gram_1000_of_1024_b1", "categorical_only", "wide",
         "batched"],
)
def test_masked_gram_matches_plain(cuda_device, case):
    b, n, dc, ds = case["b"], case["n"], case["dc"], case["ds"]
    args = _args(cuda_device, b, n, n, dc, ds, same=True, batched=case.get("batched", False))
    mask1, mask2, diag = _masks(cuda_device, b, n, n, case["valid"], same=True, diag=True)
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, diag)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
    tol = _fwd_tol(dc)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # The padded block is exactly the identity, the cross terms exactly zero,
    # and the two triangles hold the same floats.
    pad = ~mask1
    assert torch.equal(got[:, pad][:, :, pad], torch.eye(int(pad.sum()), device=cuda_device).expand(b, -1, -1))
    assert torch.all(got[:, pad][:, :, ~pad] == 0) and torch.all(got[:, ~pad][:, :, pad] == 0)
    assert torch.equal(got, got.transpose(-1, -2))
    grad = torch.randn(want.shape, generator=torch.Generator(device=cuda_device).manual_seed(2),
                       device=cuda_device)
    want_g = tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2)
    first = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    _assert_grads_close(first[:3], want_g[:3])
    _assert_params_within_rounding(first, grad, args, mask1, mask2)
    # Fixed-order reductions: the same inputs give the same bits.
    second = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    for a, c in zip(first[:3], second[:3]):
        assert torch.equal(a, c)


# The main path's cross kernels against 1024 data rows, 1000 of them real:
# one pick's predict, the sweep's 50 queries, and the PE conditioning's
# predict at every row of the data and pending points (separate tensors, so
# not the symmetric Gram).
_MAIN_CROSS_QUERIES = [1, 50, 1024]


def _check_cross(device, b, n, m, valid1, valid2):
    """K1 and K2 (feature gradients included, parameter gradients
    deterministic) against their plain versions at a masked cross shape:
    ``valid1`` / ``valid2`` real rows on each side (None: no mask)."""
    args = _args(device, b, n, m, 20, 0)
    mask1, mask2, _ = _masks(device, b, n, m, valid1, valid2)
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[..., valid2:] == 0)
    if valid1 is not None:
        assert torch.all(got[:, valid1:] == 0)
    grad = torch.randn(want.shape, device=device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, need_x1=True, need_x2=True)
    _assert_grads_close(got_g, tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2))
    _assert_params_within_rounding(got_g, grad, args, mask1, mask2)
    again = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, need_x1=True, need_x2=True)
    for a, c in zip(got_g[:3], again[:3]):
        assert torch.equal(a, c)


def _check_masked_cross(device, queries):
    _check_cross(device, 1, queries, 1024, None, 1000)


@pytest.mark.parametrize("queries", _MAIN_CROSS_QUERIES)
def test_masked_cross_matches_plain(cuda_device, queries):
    _check_masked_cross(cuda_device, queries)


@pytest.mark.parametrize("tile", [0, 1], ids=["big", "tiny"])
@pytest.mark.parametrize("queries", _MAIN_CROSS_QUERIES)
def test_every_tile_matches_plain_at_the_main_path_cross_shapes(cuda_device, queries, tile):
    """Whichever tile the shape chooses, each one the library has is right."""
    from vizier_tpu_torch.ops import native

    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        _check_masked_cross(cuda_device, queries)
    finally:
        lib.matern52_force_tile(-1)


def test_gram_gradient_reaches_the_noise_through_the_diagonal(cuda_device):
    """_masked_gram on the card against the CPU plain path, noise included."""
    b, n, valid = 2, 40, 33
    args = _args(cuda_device, b, n, n, 4, 2, same=True)
    x, z, _, _, amp, inv, inv_sq = args
    mask = torch.arange(n, device=cuda_device) < valid
    noise = torch.tensor([0.1, 0.3], device=cuda_device)
    weights = torch.randn((b, n, n), device=cuda_device)

    def loss(device):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (amp, 1.0 / inv, noise)]
        f = tk.MixedFeatures(x.to(device), z.to(device))
        m = mask.to(device)
        out = tk.matern52_ard(
            f, f, amplitude=leaves[0], continuous_length_scales=leaves[1],
            categorical_length_scales=(1.0 / inv_sq.sqrt()).to(device),
            row_mask1=m, row_mask2=m, diag=leaves[2] * leaves[2] + 1e-5,
        )
        value = torch.sum(weights.to(device) * out)
        return value, torch.autograd.grad(value, leaves)

    tk.reset_launch_counts()
    got, got_grads = loss(cuda_device)
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["gram"] == 1
    assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"]["gram"] == 1
    want, want_grads = loss("cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def test_autograd_through_the_kernels_matches_the_cpu_plain_path(cuda_device):
    args = _args(cuda_device, b=2, n=30, m=30, dc=5, ds=2, batched=True)
    x1, z1, x2, z2, amp, inv, inv_sq = args
    ls = (1.0 / inv).requires_grad_(True)
    cat_ls = (1.0 / inv_sq.sqrt()).requires_grad_(True)
    amp = amp.clone().requires_grad_(True)
    x1 = x1.clone().requires_grad_(True)
    weights = torch.randn((2, 30, 30), device=cuda_device)

    def loss(device):
        to = lambda t: t.detach().to(device).requires_grad_(t.requires_grad)  # noqa: E731
        leaves = [to(t) for t in (amp, ls, cat_ls, x1)]
        out = tk.matern52_ard(
            tk.MixedFeatures(leaves[3], z1.to(device)), tk.MixedFeatures(x2.to(device), z2.to(device)),
            amplitude=leaves[0], continuous_length_scales=leaves[1],
            categorical_length_scales=leaves[2],
        )
        value = torch.sum(weights.to(device) * out)
        return value, torch.autograd.grad(value, leaves)

    tk.reset_launch_counts()
    got, got_grads = loss(cuda_device)
    assert sum(tk.LAUNCHES_BY_MODE["matern52_ard_fwd"].values()) == 1
    assert sum(tk.LAUNCHES_BY_MODE["matern52_ard_bwd"].values()) == 1
    want, want_grads = loss("cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    for g, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def test_designer_suggests_through_the_kernels(cuda_device):
    problem = vz.ProblemStatement()
    for name in ("x", "y"):
        problem.search_space.root.add_float_param(name, 0.0, 1.0)
    problem.search_space.root.add_categorical_param("c", ["a", "b", "c"])
    problem.metric_information.append(vz.MetricInformation(name="obj"))
    rng = np.random.default_rng(0)
    trials = []
    for i in range(16):
        t = vz.Trial(id=i + 1, parameters={"x": float(rng.uniform()), "y": float(rng.uniform()),
                                           "c": "abc"[i % 3]})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        trials.append(t)
    designer = gp_ucb_pe.VizierGPUCBPEBandit(
        problem, ard_restarts=2, max_acquisition_evaluations=2000
    )
    designer.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    tk.reset_launch_counts()
    suggestions = designer.suggest(3)
    torch.cuda.synchronize()
    assert len(suggestions) == 3
    for name in ("matern52_ard_fwd", "matern52_ard_bwd"):
        assert sum(tk.LAUNCHES_BY_MODE[name].values()) > 0
    for s in suggestions:
        assert 0.0 <= s.parameters.get_value("x") <= 1.0
        assert s.parameters.get_value("c") in ("a", "b", "c")


# The sparse surrogate's shapes at 1000 trials x 20-D (SurrogateConfig's
# defaults: 128 inducing points, 5 picks per request): Knm in the cold (6
# restarts) and warm (3) trains, the per-pick re-conditioning's Knm over
# 1000 rows + pending picks and 128 slots + augments of 133, the PE
# conditioning's predict at every all-points row, the sweep's 50 queries and
# one pick's query against the trained (128) and augmented (133) slots.
_SPARSE_CROSS = {
    "knm_cold": dict(b=6, n=1024, m=128, valid1=1000, valid2=128),
    "knm_warm": dict(b=3, n=1024, m=128, valid1=1000, valid2=128),
    "knm_per_pick": dict(b=1, n=1024, m=133, valid1=1003, valid2=130),
    "pe_conditioning": dict(b=1, n=1024, m=128, valid1=None, valid2=128),
    "sweep": dict(b=1, n=50, m=128, valid1=None, valid2=128),
    "sweep_augmented": dict(b=1, n=50, m=133, valid1=None, valid2=130),
    "one_query": dict(b=1, n=1, m=128, valid1=None, valid2=128),
}




@pytest.mark.parametrize("tile", [-1, 0, 1], ids=["chosen", "big", "tiny"])
@pytest.mark.parametrize("shape", list(_SPARSE_CROSS), ids=list(_SPARSE_CROSS))
def test_sparse_cross_shapes_match_plain_at_every_tile(cuda_device, shape, tile):
    """K1 and K2 (deterministic) with both row masks, each tile forced in turn."""
    from vizier_tpu_torch.ops import native

    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        _check_cross(cuda_device, **_SPARSE_CROSS[shape])
    finally:
        lib.matern52_force_tile(-1)


@pytest.mark.parametrize(
    "b,m,valid", [(6, 128, 128), (3, 128, 128), (1, 128, 128), (1, 133, 130)],
    ids=["cold_train", "warm_train", "precompute", "per_pick_ragged"],
)
def test_kmm_matches_plain_with_the_reference_diagonal(cuda_device, b, m, valid):
    """Kmm: K1's Gram mode with diagonal value 1e-4. The valid diagonal is
    bitwise amp² + 1e-4 (the reference's replaced diagonal) and the CPU's."""
    args = _args(cuda_device, b, m, m, 20, 0, same=True)
    amp = args[4]
    mask1, mask2, _ = _masks(cuda_device, b, m, m, valid, same=True)
    jitter = torch.full((b,), 1e-4, device=cuda_device)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, jitter)
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, jitter)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, got.transpose(-1, -2))
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    assert torch.equal(diag[:, :valid], (amp * amp + 1e-4)[:, None].expand(-1, valid))
    assert torch.all(diag[:, valid:] == 1.0)
    cpu = tk.matern52_ard_fwd_plain(*(a.cpu() for a in args), mask1.cpu(), mask2.cpu(), jitter.cpu())
    assert torch.equal(diag.cpu(), torch.diagonal(cpu, dim1=-2, dim2=-1))
    grad = torch.randn(want.shape, device=cuda_device)
    first = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    _assert_grads_close(first[:3], tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2)[:3])
    _assert_params_within_rounding(first, grad, args, mask1, mask2)
    second = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    for a, c in zip(first[:3], second[:3]):
        assert torch.equal(a, c)


def _gp_data(device, n, valid, dc, ds, duplicates=0, seed=0):
    from vizier_tpu_torch.models import gp as tgp

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, dc), generator=gen)
    z = torch.randint(0, 3, (n, ds), generator=gen, dtype=torch.int32)
    if duplicates:
        x[valid - duplicates:valid] = x[:duplicates]
        z[valid - duplicates:valid] = z[:duplicates]
    row_mask = torch.arange(n) < valid
    labels = torch.where(row_mask, torch.randn(n, generator=gen), torch.zeros(n))
    return tgp.GPData(
        continuous=x.to(device), categorical=z.to(device), labels=labels.to(device),
        row_mask=row_mask.to(device), cont_dim_mask=torch.ones(dc, dtype=torch.bool, device=device),
        cat_dim_mask=torch.ones(ds, dtype=torch.bool, device=device),
    )


@pytest.mark.parametrize(
    "case",
    [dict(n=1024, valid=1000, dc=20, ds=0), dict(n=1024, valid=1000, dc=20, ds=2, duplicates=300),
     dict(n=128, valid=90, dc=20, ds=0)],
    ids=["main_path", "duplicates", "fewer_valid_than_m"],
)
def test_kcenter_picks_the_same_rows_on_the_card(cuda_device, case):
    from vizier_tpu_torch.surrogates import sparse_gp as tsg

    got = tsg.select_inducing_kcenter(_gp_data(cuda_device, **case), 128)
    want = tsg.select_inducing_kcenter(_gp_data("cpu", **case), 128)
    assert torch.equal(got.inducing_indices.cpu(), want.inducing_indices)
    assert torch.equal(got.inducing_mask.cpu(), want.inducing_mask)


def test_sparse_posterior_on_the_card_matches_the_cpu(cuda_device):
    """Predictions within 1e-3 (unit-variance labels): both sides factor the
    same float32 matrices in different orders."""
    from vizier_tpu_torch.models import gp as tgp
    from vizier_tpu_torch.surrogates import sparse_gp as tsg

    def posterior(device):
        data = _gp_data(device, 512, 500, 20, 0)
        base = tgp.VizierGaussianProcess(num_continuous=20, num_categorical=0, device=device)
        model = tsg.SparseGaussianProcess(base=base, num_inducing=64)
        params = {
            "amplitude": torch.tensor([1.2], device=device),
            "noise_stddev": torch.tensor([0.1], device=device),
            "continuous_length_scales": torch.full((1, 20), 0.8, device=device),
        }
        state = model.precompute_constrained(params, tsg.select_inducing_kcenter(data, 64))
        query = torch.rand((64, 20), generator=torch.Generator().manual_seed(3)).to(device)
        return state.predict(tk.MixedFeatures(query, torch.zeros((64, 0), dtype=torch.int32,
                                                                 device=device)))

    for got, want in zip(posterior(cuda_device), posterior("cpu")):
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)


def test_sparse_designer_suggests_through_the_kernels(cuda_device):
    """The sparse DEFAULT path on the card: K2 runs in cross mode (Knm)."""
    from vizier_tpu_torch.surrogates import SurrogateConfig

    problem = vz.ProblemStatement()
    for name in ("x", "y"):
        problem.search_space.root.add_float_param(name, 0.0, 1.0)
    problem.metric_information.append(vz.MetricInformation(name="obj"))
    rng = np.random.default_rng(0)
    trials = []
    for i in range(40):
        t = vz.Trial(id=i + 1, parameters={"x": float(rng.uniform()), "y": float(rng.uniform())})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        trials.append(t)
    designer = gp_ucb_pe.VizierGPUCBPEBandit(
        problem, ard_restarts=2, max_acquisition_evaluations=2000, warm_ard_restarts=1,
        surrogate=SurrogateConfig(sparse_threshold_trials=32, hysteresis_trials=8, num_inducing=16),
    )
    designer.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    tk.reset_launch_counts()
    suggestions = designer.suggest(3)
    torch.cuda.synchronize()
    assert designer.surrogate_mode == "sparse" and len(suggestions) == 3
    for name, mode in (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                       ("matern52_ard_bwd", "gram"), ("matern52_ard_bwd", "cross")):
        assert tk.LAUNCHES_BY_MODE[name][mode] > 0, (name, mode)
    for s in suggestions:
        assert 0.0 <= s.parameters.get_value("x") <= 1.0
