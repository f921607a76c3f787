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
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

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
    if valid2 is not None:
        assert torch.all(got[..., valid2:] == 0)
    if valid1 is not None:
        assert torch.all(got[:, valid1:] == 0)
    # Seeded: the default CUDA generator starts from another seed in each
    # process, so an unseeded draw made each run check other inputs.
    grad = torch.randn(want.shape, generator=torch.Generator(device=device).manual_seed(4),
                       device=device)
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


# The multi-objective phase's shapes (two objectives, 1000 trials x 20-D):
# each metric's PE conditioning and sweep predict against 1024 rows (1010
# real after two requests), and the multi-task GP's k*, an unmasked cross
# (the task mask applies to the Kronecker product), at 1, 50 and 1024
# queries.
_MO_CROSS = {
    "per_metric_pe_conditioning": dict(b=1, n=1024, m=1024, valid1=None, valid2=1010),
    "per_metric_sweep": dict(b=1, n=50, m=1024, valid1=None, valid2=1010),
    "multitask_kstar_one": dict(b=1, n=1, m=1024, valid1=None, valid2=None),
    "multitask_kstar_sweep": dict(b=1, n=50, m=1024, valid1=None, valid2=None),
    "multitask_kstar_pe": dict(b=1, n=1024, m=1024, valid1=None, valid2=None),
}


@pytest.mark.parametrize("tile", [-1, 0, 1], ids=["chosen", "big", "tiny"])
@pytest.mark.parametrize("shape", list(_MO_CROSS), ids=list(_MO_CROSS))
def test_multiobjective_cross_shapes_match_plain_at_every_tile(cuda_device, shape, tile):
    from vizier_tpu_torch.ops import native

    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        _check_cross(cuda_device, **_MO_CROSS[shape])
    finally:
        lib.matern52_force_tile(-1)


@pytest.mark.parametrize(
    "b,valid",
    [(2, 1005), (4, 1015), (4, None), (1, None)],
    ids=["per_metric_warm_train", "bandit_per_metric_train", "multitask_kx_train",
         "multitask_kx_per_pick"],
)
def test_multiobjective_grams_match_plain(cuda_device, b, valid):
    """The per-metric masked Grams (noise diagonal) and the multi-task Kx, K1's
    Gram mode without masks or diagonal: triangles bit-identical, K2's
    symmetric path deterministic."""
    args = _args(cuda_device, b, 1024, 1024, 20, 0, same=True)
    mask1, mask2, diag = _masks(cuda_device, b, 1024, 1024, valid, same=True, diag=valid is not None)
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, diag)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, got.transpose(-1, -2))
    grad = torch.randn(want.shape, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device)
    first = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    _assert_grads_close(first[:3], tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2)[:3])
    _assert_params_within_rounding(first, grad, args, mask1, mask2)
    second = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    for a, c in zip(first[:3], second[:3]):
        assert torch.equal(a, c)


def _multitask(device, kind="SEPARABLE"):
    """A two-task model, data over 256 rows (250 real; task 1 lacks row 7)
    and parameters for two restarts (a negative task correlation)."""
    from vizier_tpu_torch.models import multitask_gp as tmt

    data = _gp_data(device, 256, 250, 20, 0)
    gen = torch.Generator().manual_seed(5)
    labels = torch.stack([data.labels, (-data.labels + 0.3 * torch.randn(256, generator=gen)
                                        .to(device))])
    mask = torch.stack([data.row_mask, data.row_mask.clone()])
    mask[1, 7] = False
    mt_data = tmt.MultiTaskData(features_data=data, task_labels=labels * mask, task_mask=mask)
    model = tmt.MultiTaskGaussianProcess(20, 0, 2, tmt.MultiTaskType[kind], device=device)
    params = {
        "amplitude": torch.tensor([1.2, 0.9], device=device),
        "noise_stddev": torch.tensor([0.1, 0.2], device=device),
        "continuous_length_scales": torch.full((2, 20), 0.8, device=device),
        "task_chol_diag": torch.tensor([[1.0, 0.7], [0.8, 1.1]], device=device),
        "task_chol_offdiag": torch.tensor([[-0.6], [0.3]], device=device),
        "task_corr_chol_vec": torch.tensor([[-0.6], [0.3]], device=device),
        "task_sqrt_diag": torch.tensor([[0.9, 0.7], [0.6, 0.8]], device=device),
    }
    names = {s.name for s in model.param_collection().specs}
    return model, mt_data, {k: v for k, v in params.items() if k in names}


@pytest.mark.parametrize("kind", ["SEPARABLE", "SEPARABLE_LKJ", "SEPARABLE_DIAG"])
def test_multitask_joint_gram_on_the_card_matches_the_cpu(cuda_device, kind):
    """The joint Gram (Kx from K1's Gram, the Kronecker product with B, the
    task mask and the diagonal) on the card against the CPU plain path, and
    the NLL, its gradient and the per-task predictions from it."""
    card_model, card_data, card_params = _multitask(cuda_device, kind)
    cpu_model, cpu_data, cpu_params = _multitask("cpu", kind)
    got = card_model._joint_gram(card_params, card_data)
    want = cpu_model._joint_gram(cpu_params, cpu_data)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, got.transpose(-1, -2))

    def nll_and_grad(model, data, params):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in model.param_collection().unconstrain(params).items()}
        loss = model.neg_log_likelihood(leaves, data)
        loss.sum().backward()
        return loss.detach().cpu(), {k: v.grad.cpu() for k, v in leaves.items()}

    got_nll, got_grad = nll_and_grad(card_model, card_data, card_params)
    want_nll, want_grad = nll_and_grad(cpu_model, cpu_data, cpu_params)
    torch.testing.assert_close(got_nll, want_nll, rtol=1e-4, atol=0)
    for k, g in want_grad.items():
        scale = float(torch.max(torch.abs(g)))
        torch.testing.assert_close(got_grad[k], g, rtol=1e-3, atol=1e-3 * scale)
    query = torch.rand((64, 20), generator=torch.Generator().manual_seed(3))
    zeros = torch.zeros((64, 0), dtype=torch.int32)
    got_pred = card_model.precompute_constrained(card_params, card_data).predict(
        tk.MixedFeatures(query.to(cuda_device), zeros.to(cuda_device)))
    want_pred = cpu_model.precompute_constrained(cpu_params, cpu_data).predict(
        tk.MixedFeatures(query, zeros))
    for g, w in zip(got_pred, want_pred):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=0)


def _two_objective_problem_and_trials(n=20):
    problem = vz.ProblemStatement()
    for name in ("x", "y"):
        problem.search_space.root.add_float_param(name, 0.0, 1.0)
    for name in ("f1", "f2"):
        problem.metric_information.append(
            vz.MetricInformation(name=name, goal=vz.ObjectiveMetricGoal.MINIMIZE))
    rng = np.random.default_rng(0)
    trials = []
    for i in range(n):
        x, y = float(rng.uniform()), float(rng.uniform())
        t = vz.Trial(id=i + 1, parameters={"x": x, "y": y})
        g = (y - 0.5) ** 2
        t.complete(vz.Measurement(metrics={"f1": (1 + g) * np.cos(x * np.pi / 2),
                                           "f2": (1 + g) * np.sin(x * np.pi / 2)}))
        trials.append(t)
    return problem, trials


@pytest.mark.parametrize("multitask", [False, True], ids=["independent", "separable"])
def test_multiobjective_designer_suggests_through_the_kernels(cuda_device, multitask):
    """Two objectives on the card: per-metric GPs (K1 Gram and masked cross,
    K2 Gram) or the SEPARABLE multi-task GP (K1 Gram for Kx, unmasked cross
    for k*, K2 Gram)."""
    problem, trials = _two_objective_problem_and_trials()
    config = gp_ucb_pe.UCBPEConfig(
        multitask_type=gp_ucb_pe.MultiTaskType.SEPARABLE if multitask
        else gp_ucb_pe.MultiTaskType.INDEPENDENT)
    designer = gp_ucb_pe.VizierGPUCBPEBandit(
        problem, config=config, ard_restarts=2, max_acquisition_evaluations=2000)
    designer.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    tk.reset_launch_counts()
    suggestions = designer.suggest(3)
    torch.cuda.synchronize()
    assert len(suggestions) == 3
    k_star = "other" if multitask else "cross"
    for name, mode in (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", k_star),
                       ("matern52_ard_bwd", "gram")):
        assert tk.LAUNCHES_BY_MODE[name][mode] > 0, (name, mode)
    for s in suggestions:
        assert 0.0 <= s.parameters.get_value("x") <= 1.0
        mean = s.metadata.ns("gp_ucb_pe").ns("prediction_in_warped_y_space")["mean"]
        assert len(mean.strip("[]").split(",")) == 2


# -- a cross-study flush's grouped inputs: per-study rows, codes and masks --


def _flush_args(device, studies, group, n, m, dc, ds, same=False, valid=None, step=0,
                valid1=None, step1=0, diag=None, seed=5):
    """A flush's grouped kernel inputs: each input one block per study, the
    batch ``studies`` groups of ``group`` members, study s with ``valid +
    step * s`` valid rows (``valid1 + step1 * s`` on the first side)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = studies * group
    x1 = torch.rand((studies, n, dc), generator=gen, device=device)
    x2 = x1 if same else torch.rand((studies, m, dc), generator=gen, device=device)
    z1 = torch.randint(0, 3, (studies, n, ds), generator=gen, device=device, dtype=torch.int32)
    z2 = z1 if same else torch.randint(0, 3, (studies, m, ds), generator=gen, device=device,
                                       dtype=torch.int32)
    amp = 0.5 + torch.rand((b,), generator=gen, device=device)
    inv = 1.0 / (0.5 + torch.rand((b, dc), generator=gen, device=device))
    inv_sq = 1.0 / (0.5 + torch.rand((b, ds), generator=gen, device=device)) ** 2
    per_study = torch.arange(studies, device=device)[:, None]
    rows = lambda count, first, inc: torch.arange(count, device=device)[None, :] < first + inc * per_study  # noqa: E731
    mask2 = None if valid is None else rows(m, valid, step)
    mask1 = mask2 if same else (None if valid1 is None else rows(n, valid1, step1))
    d = None if diag is None else torch.full((b,), diag, device=device)
    return (x1, z1, x2, z2, amp, inv, inv_sq), (mask1, mask2, d)


_FLUSH_SHAPES = {
    "exact_cold_gram_8x5": dict(studies=8, group=5, n=512, m=512, dc=20, ds=0, same=True,
                                valid=480, step=2, diag=1e-3),
    "exact_warm_gram_8x2": dict(studies=8, group=2, n=512, m=512, dc=20, ds=0, same=True,
                                valid=480, step=2, diag=1e-3),
    "pe_cross_8": dict(studies=8, group=1, n=512, m=512, dc=20, ds=0, valid=480, step=2),
    "sweep_cross_8": dict(studies=8, group=1, n=50, m=512, dc=20, ds=0, valid=480, step=2),
    "sparse_knm_8x6": dict(studies=8, group=6, n=1024, m=128, dc=20, ds=0, valid=128,
                           valid1=1000, step1=2),
    "sparse_knm_8x3": dict(studies=8, group=3, n=1024, m=128, dc=20, ds=0, valid=128,
                           valid1=1000, step1=2),
    "kmm_8x6": dict(studies=8, group=6, n=128, m=128, dc=20, ds=0, same=True, valid=128,
                    diag=1e-4),
    "sparse_kstar_8": dict(studies=8, group=1, n=50, m=133, dc=20, ds=0, valid=130),
    # Each pick's re-conditioning: the exact all-points Gram, and the sparse
    # Knm (per-study rows and inducing slots valid), Kmm and PE k*.
    "exact_pick_gram_8": dict(studies=8, group=1, n=512, m=512, dc=20, ds=0, same=True,
                              valid=483, step=2, diag=1e-3),
    "sparse_knm_pick_8": dict(studies=8, group=1, n=1024, m=133, dc=20, ds=0, valid=128, step=1,
                              valid1=1003, step1=2),
    "kmm_pick_8": dict(studies=8, group=1, n=133, m=133, dc=20, ds=0, same=True, valid=130,
                       diag=1e-4),
    "sparse_pe_kstar_8": dict(studies=8, group=1, n=1024, m=128, dc=20, ds=0, valid=128),
    "categorical_only_4x2": dict(studies=4, group=2, n=60, m=60, dc=0, ds=4, same=True,
                                 valid=50, step=2, diag=1e-3),
}


@pytest.mark.parametrize("shape", sorted(_FLUSH_SHAPES))
def test_grouped_kernels_match_plain_at_the_flush_shapes(cuda_device, shape):
    """K1 and K2 with per-study rows, codes and masks against their plain
    versions (which repeat each study's inputs to its members)."""
    args, (mask1, mask2, diag) = _flush_args(cuda_device, **_FLUSH_SHAPES[shape])
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, diag)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    grad = torch.randn(want.shape, generator=torch.Generator(device=cuda_device).manual_seed(2),
                       device=cuda_device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, need_x1=True, need_x2=True)
    _assert_grads_close(got_g, tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2))
    _assert_params_within_rounding(got_g, grad, args, mask1, mask2)


@pytest.mark.parametrize("shape", ["exact_cold_gram_8x5", "sweep_cross_8", "sparse_knm_8x3"])
def test_each_member_of_a_grouped_launch_computes_its_shared_launch(cuda_device, shape):
    """Member b of a grouped K1 launch gives, bit for bit, what today's
    shared-input launch on its study's rows gives (whatever tile either
    takes); K2's parameter gradients agree to float32 rounding (the block
    partition of the sums follows the tile)."""
    spec = _FLUSH_SHAPES[shape]
    args, (mask1, mask2, diag) = _flush_args(cuda_device, **spec)
    x1, z1, x2, z2, amp, inv, inv_sq = args
    g = spec["group"]
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
    grad = torch.randn(got.shape, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2)
    for b in range(amp.shape[0]):
        s = b // g
        pick = lambda t: None if t is None else t[s]  # noqa: E731
        one = (x1[s], z1[s], x1[s] if x2 is x1 else x2[s], z1[s] if z2 is z1 else z2[s],
               amp[b : b + 1], inv[b : b + 1], inv_sq[b : b + 1])
        m1, m2 = pick(mask1), (pick(mask1) if mask2 is mask1 else pick(mask2))
        d = None if diag is None else diag[b : b + 1]
        if x2 is x1:
            one = (one[0], one[1], one[0], one[1]) + one[4:]
        want = tk.matern52_ard_fwd_cuda(*one, m1, m2, d)
        assert torch.equal(got[b : b + 1], want)
        want_g = tk.matern52_ard_bwd_cuda(grad[b : b + 1], *one, m1, m2)
        for a, w in zip(got_g[:3], want_g[:3]):
            if w.numel():
                torch.testing.assert_close(a[b : b + 1], w, rtol=1e-5,
                                           atol=1e-5 * float(w.abs().max()))


def test_a_flush_of_designers_matches_each_study_alone_on_the_card(cuda_device):
    """Three studies through ``UCBPEProgram`` as one flush and one by one:
    every pick in bounds, each study's trained factor finite in both, the
    same data in both, and the trained NLLs within 1e-3 relative (batched
    and single Choleskys are different routines on the card, so the two
    L-BFGS runs end near, not at, the same optimum)."""
    from vizier_tpu_torch.compute import registry

    def designer(study):
        problem = vz.ProblemStatement()
        for j in range(4):
            problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
        problem.metric_information.append(vz.MetricInformation(name="y"))
        d = gp_ucb_pe.VizierGPUCBPEBandit(problem, rng_seed=study, ard_restarts=2,
                                          max_acquisition_evaluations=500)
        rng = np.random.default_rng(study)
        trials = []
        for i in range(40 + study):
            x = rng.uniform(size=4)
            t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(4)})
            t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.5) ** 2))}))
            trials.append(t)
        d.update(vz.CompletedTrials(trials))
        return d

    def nll(state):
        coll = state.model.param_collection()
        return float(state.model.neg_log_likelihood(coll.unconstrain(state.params), state.data)[0])

    flush = [designer(s) for s in range(3)]
    program, _ = registry.resolve(flush[0], 3)
    items = [program.prepare(d, 3) for d in flush]
    outputs = program.device_program(items, pad_to=4)
    for study, (d, item, output) in enumerate(zip(flush, items, outputs)):
        suggestions = program.finalize(d, item, output)
        assert len(suggestions) == 3
        for s in suggestions:
            assert all(0.0 <= s.parameters.get_value(f"x{j}") <= 1.0 for j in range(4))
        (state,), _ = d._cached_states
        assert bool(torch.isfinite(state.chol).all())
        alone = designer(study)
        alone.suggest(3)
        (alone_state,), _ = alone._cached_states
        assert bool(torch.isfinite(alone_state.chol).all())
        for field in ("continuous", "categorical", "labels", "row_mask"):
            assert torch.equal(getattr(state.data, field), getattr(alone_state.data, field))
        got, want = nll(state), nll(alone_state)
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (study, got, want)


# -- the regret phase's shapes: a function's 5 seeds per flush, padded to 8 --
#
# Rows padded to the next power of two (16 at 10 trials ... 256 at 130-140),
# the all-points rows to pad(n + 10) with n to n + 9 valid; Dc = 20 (Sphere,
# Rastrigin) and 2 (Branin); the mixed-space DEFAULT alone at Dc = 2, Ds = 1;
# the GP bandit alone on ZDT1 (Dc = 6) and Branin.
_REGRET_GRAMS = {
    "cold_gram_8x5_256_dc20": dict(studies=8, group=5, n=256, m=256, dc=20, ds=0, same=True,
                                   valid=140, diag=1e-3),
    "cold_gram_8x5_128_dc20": dict(studies=8, group=5, n=128, m=128, dc=20, ds=0, same=True,
                                   valid=120, diag=1e-3),
    "cold_gram_8x5_16_dc2": dict(studies=8, group=5, n=16, m=16, dc=2, ds=0, same=True,
                                 valid=10, diag=1e-3),
    "cold_gram_8x5_256_dc2": dict(studies=8, group=5, n=256, m=256, dc=2, ds=0, same=True,
                                  valid=140, diag=1e-3),
    "pick_gram_8_256_dc20": dict(studies=8, group=1, n=256, m=256, dc=20, ds=0, same=True,
                                 valid=149, diag=1e-3),
    "pick_gram_8_32_dc2": dict(studies=8, group=1, n=32, m=32, dc=2, ds=0, same=True,
                               valid=29, diag=1e-3),
    "mixed_gram_5_32_dc2_ds1": dict(studies=1, group=5, n=32, m=32, dc=2, ds=1, same=True,
                                    valid=27, diag=1e-3),
}
_REGRET_CROSS = {
    "pe_8_256x256_dc20": dict(studies=8, group=1, n=256, m=256, dc=20, ds=0, valid=140),
    "pe_8_256x128_dc20": dict(studies=8, group=1, n=256, m=128, dc=20, ds=0, valid=120),
    "pe_8_32x16_dc2": dict(studies=8, group=1, n=32, m=16, dc=2, ds=0, valid=10),
    "sweep_8_50x256_dc20": dict(studies=8, group=1, n=50, m=256, dc=20, ds=0, valid=145),
    "sweep_8_50x32_dc2": dict(studies=8, group=1, n=50, m=32, dc=2, ds=0, valid=20),
    "one_query_8_1x32_dc2": dict(studies=8, group=1, n=1, m=32, dc=2, ds=0, valid=20),
    "mixed_sweep_1_50x32_dc2_ds1": dict(studies=1, group=1, n=50, m=32, dc=2, ds=1, valid=29),
    # The GP bandit alone: its sweep on ZDT1 (Dc = 6) and on Branin.
    "zdt1_sweep_1_50x64_dc6": dict(studies=1, group=1, n=50, m=64, dc=6, ds=0, valid=55),
    "bandit_sweep_1_50x32_dc2": dict(studies=1, group=1, n=50, m=32, dc=2, ds=0, valid=30),
}


def _check_grouped(device, spec):
    args, (mask1, mask2, diag) = _flush_args(device, **spec)
    want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, diag)
    got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    grad = torch.randn(want.shape, generator=torch.Generator(device=device).manual_seed(2),
                       device=device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, need_x1=True, need_x2=True)
    _assert_grads_close(got_g, tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2))
    _assert_params_within_rounding(got_g, grad, args, mask1, mask2)


@pytest.mark.parametrize("shape", sorted(_REGRET_GRAMS))
def test_grouped_kernels_match_plain_at_the_regret_grams(cuda_device, shape):
    _check_grouped(cuda_device, _REGRET_GRAMS[shape])


@pytest.mark.parametrize("tile", [-1, 0, 1], ids=["chosen", "big", "tiny"])
@pytest.mark.parametrize("shape", sorted(_REGRET_CROSS))
def test_regret_cross_shapes_match_plain_at_every_tile(cuda_device, shape, tile):
    """K1 and K2 at the regret flushes' cross shapes, each tile forced in turn."""
    from vizier_tpu_torch.ops import native

    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        _check_grouped(cuda_device, _REGRET_CROSS[shape])
    finally:
        lib.matern52_force_tile(-1)


def _lockstep_branin_round():
    """Five Branin2d studies (seeds 1-5) at 10 completed trials, their
    suggest(10) submitted at once to the regret run's executor. Returns
    (executor stats, [(experimenter, suggestions)])."""
    import threading

    from vizier_tpu_torch.benchmarks import regret
    from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory

    executor, stats = regret.make_executor()
    studies = []
    for seed in range(1, 6):
        exp = experimenter_factory.shifted_bbob_instance("Branin", seed, dim=2)
        designer = regret.make_designer(exp.problem_statement(), seed, 2000, "cuda")
        seeds = [s.to_trial(i + 1) for i, s in enumerate(designer.suggest(10))]
        exp.evaluate(seeds)
        designer.update(vz.CompletedTrials(seeds))
        studies.append((exp, designer))
    results = [None] * 5
    barrier = threading.Barrier(5)

    def suggest(i):
        barrier.wait()
        results[i] = executor.suggest(studies[i][1], 10)

    threads = [threading.Thread(target=suggest, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        executor.close()
    return stats, [(exp, r) for (exp, _), r in zip(studies, results)]


def test_a_lockstep_round_of_branin_studies_flushes_once_without_fallback(cuda_device):
    """One lockstep round of five Branin2d studies: one flush of all five,
    no fallback or slot error, every pick finite and in bounds."""
    from vizier_tpu_torch.benchmarks import regret

    stats, rounds = _lockstep_branin_round()
    assert stats.get("batch_flushes") == 1 and stats.get("batched_suggests") == 5
    assert stats.get("batch_fallbacks") == 0 and stats.get("batch_slot_errors") == 0
    for exp, suggestions in rounds:
        assert len(suggestions) == 10
        regret.check_suggestions([s.to_trial(1) for s in suggestions], exp.problem_statement(),
                                 "Branin2d")


def test_every_layout_a_lockstep_round_launches_matches_plain(cuda_device):
    """The wrappers record each launch's layout while LAUNCH_SHAPES is set;
    chip_smoke's check holds K1/K2 to their plain versions at each layout of
    a lockstep Branin2d round, at every tile."""
    import importlib.util
    import pathlib

    from vizier_tpu_torch.ops import native

    tk.LAUNCH_SHAPES = set()
    try:
        _lockstep_branin_round()
        recorded = tk.LAUNCH_SHAPES
    finally:
        tk.LAUNCH_SHAPES = None
    names = {name for name, _ in recorded}
    assert names == {"matern52_ard_fwd", "matern52_ard_bwd"}
    # The flush's grouped Gram: 5 studies padded to 8 slots, a block each.
    assert any(shape.symmetric and shape.x1 == 8 and shape.dc == 2 for _, shape in recorded)
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    worst = chip_smoke.check_recorded_shapes(tk, native.library(), recorded, "lockstep round")
    assert worst["layouts"] == len({shape for _, shape in recorded})


# -- the gp-surface layouts: joint qEI, set-PE, stacked residual, Adam --------

# Joint qEI's and set-PE's k* over a pool of 50 candidate batches (the 250 /
# 200 flattened points against the data rows), their K(q, q) blocks
# (candidate p is group p of a [50·E] batch), and the stacked-residual
# levels' Grams (4 restarts, noise diagonal) and sweeps at 1024 and 128 rows.
_SURFACE_SHAPES = {
    "qei_kstar_1_250x1024": dict(studies=1, group=1, n=250, m=1024, dc=20, ds=0, valid=1000),
    "set_pe_kstar_1_200x1024": dict(studies=1, group=1, n=200, m=1024, dc=20, ds=0, valid=1006),
    "qei_kqq_50_5x5": dict(studies=50, group=1, n=5, m=5, dc=20, ds=0, same=True),
    "set_pe_kqq_50x2_4x4": dict(studies=50, group=2, n=4, m=4, dc=20, ds=0, same=True),
    "stacked_gram_1x4_1024": dict(studies=1, group=4, n=1024, m=1024, dc=20, ds=0, same=True,
                                  valid=1000, diag=1e-3),
    "stacked_gram_1x4_128": dict(studies=1, group=4, n=128, m=128, dc=20, ds=0, same=True,
                                 valid=100, diag=1e-3),
    "stacked_sweep_1_50x128": dict(studies=1, group=1, n=50, m=128, dc=20, ds=0, valid=100),
}


@pytest.mark.parametrize("tile", [-1, 0, 1], ids=["chosen", "big", "tiny"])
@pytest.mark.parametrize("shape", sorted(_SURFACE_SHAPES))
def test_gp_surface_layouts_match_plain_at_every_tile(cuda_device, shape, tile):
    from vizier_tpu_torch.ops import native

    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        _check_grouped(cuda_device, _SURFACE_SHAPES[shape])
    finally:
        lib.matern52_force_tile(-1)


def _surface_problem(dim=6):
    problem = vz.ProblemStatement()
    for j in range(dim):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(vz.MetricInformation(name="y"))
    return problem


def _surface_trials(n, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(size=dim)
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(dim)})
        t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.5) ** 2))}))
        out.append(t)
    return out


def test_joint_qei_launches_one_kstar_per_sweep_iteration(cuda_device):
    """A joint qEI suggest on the card: one masked k* launch per sweep
    iteration (the pool's candidates share it), and the batch in bounds."""
    from vizier_tpu_torch.designers import gp_bandit

    designer = gp_bandit.VizierGPBandit(
        _surface_problem(), acquisition="qei", max_acquisition_evaluations=2000)
    designer.update(vz.CompletedTrials(_surface_trials(40)))
    tk.reset_launch_counts()
    suggestions = designer.suggest(4)
    assert [s.metadata.ns("gp_bandit")["acquisition_kind"] for s in suggestions] == [
        "qei_joint"] * 4
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["cross"] == 2000 // 50


def test_every_layout_of_the_gp_surface_matches_plain(cuda_device):
    """Joint qEI, set-PE, transfer priors and Adam on the card record their
    launch layouts; chip_smoke's check holds K1/K2 to their plain versions at
    each, at every tile."""
    import importlib.util
    import pathlib

    from vizier_tpu_torch.designers import gp_bandit
    from vizier_tpu_torch.ops import native
    from vizier_tpu_torch.optimizers import lbfgs

    kw = dict(max_acquisition_evaluations=500)
    tk.LAUNCH_SHAPES = set()
    try:
        qei = gp_bandit.VizierGPBandit(_surface_problem(), acquisition="qei", **kw)
        qei.update(vz.CompletedTrials(_surface_trials(30)))
        qei.suggest(3)
        set_pe = gp_ucb_pe.VizierGPUCBPEBandit(
            _surface_problem(), ard_optimizer=lbfgs.AdamOptimizer(maxiter=20),
            config=gp_ucb_pe.UCBPEConfig(optimize_set_acquisition_for_exploration=True), **kw)
        set_pe.update(vz.CompletedTrials(_surface_trials(30)))
        set_pe.suggest(3)
        priors = gp_bandit.VizierGPBandit(_surface_problem(), **kw)
        priors.update(vz.CompletedTrials(_surface_trials(10, seed=1)))
        priors.set_priors([_surface_trials(40, seed=2)])
        (pick,) = priors.suggest(1)
        assert pick.metadata.ns("gp_bandit")["acquisition_kind"] == "ucb+priors"
        recorded = tk.LAUNCH_SHAPES
    finally:
        tk.LAUNCH_SHAPES = None
    # The K(q, q) blocks: each candidate batch a group of the launch.
    assert any(shape.symmetric and shape.x1 == 50 and shape.n == 3 for _, shape in recorded)
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    worst = chip_smoke.check_recorded_shapes(tk, native.library(), recorded, "gp surface")
    assert worst["layouts"] == len({shape for _, shape in recorded})


# -- the algorithms slice: NSGA2's ranking, the scalarizations, the wrappers --


def test_nsga2_survival_ranking_on_the_card_equals_the_cpu(cuda_device):
    """Layers identical and crowding distances bit-identical (float32), ties
    and non-finite rows included."""
    from vizier_tpu_torch.designers import evolution

    rng = np.random.default_rng(0)
    objectives = rng.normal(size=(300, 2))
    objectives[::9] = objectives[1::9][: len(objectives[::9])]
    objectives[:, 0] = np.round(objectives[:, 0], 1)
    objectives[4] = np.nan
    card = evolution.survival_ranking(objectives, cuda_device)
    cpu = evolution.survival_ranking(objectives, torch.device("cpu"))
    np.testing.assert_array_equal(card[0], cpu[0])
    assert card[1].tobytes() == cpu[1].tobytes()


@pytest.mark.parametrize("name", ["LinearScalarization", "ChebyshevScalarization",
                                  "HyperVolumeScalarization"])
def test_scalarizations_on_the_card_are_bit_identical_to_the_cpu(cuda_device, name):
    from vizier_tpu_torch.designers import scalarization

    rows = torch.from_numpy(np.random.default_rng(1).normal(size=(1000, 3)).astype(np.float32))
    fn = getattr(scalarization, name)(weights=(0.2, 0.5, 0.3))
    assert fn(rows.to(cuda_device)).cpu().numpy().tobytes() == fn(rows).numpy().tobytes()


def test_nsga2_route_serves_on_the_card(cuda_device):
    from vizier_tpu_torch.pythia import local_policy_supporters
    from vizier_tpu_torch.pyvizier import study_config
    from vizier_tpu_torch.service import policy_factory

    problem = _surface_problem()
    problem.metric_information.append(vz.MetricInformation(name="z"))
    supporter = local_policy_supporters.InRamPolicySupporter(
        study_config.StudyConfig.from_problem(problem))
    policy = policy_factory.DefaultPolicyFactory()(problem, "NSGA2", supporter, "nsga2")
    for _ in range(3):
        for t in supporter.SuggestTrials(policy, 8):
            x = np.array([t.parameters.get_value(p.name) for p in problem.search_space.parameters])
            t.complete(vz.Measurement(metrics={"y": float(np.sum(x)), "z": float(-np.sum(x))}))
    assert len(supporter.GetTrials(status_matches=vz.TrialStatus.COMPLETED)) == 24


# -- the algorithm extras: L-BFGS-B through K2's feature gradient --------------


def test_feature_gradient_at_the_lbfgsb_layout_matches_plain(cuda_device):
    """K2's feature side at L-BFGS-B's layout: 16 restarts' query points
    against 1024 data rows (1000 real), B = 1, Dc = 20. The query side's
    gradient (side 0) in both K2 modes against the plain versions, the
    parameter gradients too when asked for; each mode's launch counts once,
    as "features" with the parameters and "features_only" without."""
    args = _args(cuda_device, 1, 16, 1024, 20, 0)
    _, mask2, _ = _masks(cuda_device, 1, 16, 1024, None, 1000)
    grad = torch.randn((1, 16, 1024), generator=torch.Generator(device=cuda_device).manual_seed(5),
                       device=cuda_device)
    want = tk.matern52_ard_bwd_plain(grad, *args, None, mask2)
    for mode, run in (("features", {}), ("features_only", dict(need_params=False))):
        tk.reset_launch_counts()
        got = tk.matern52_ard_bwd_cuda(grad, *args, None, mask2, need_x1=True, **run)
        assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"][mode] == 1
        assert sum(tk.LAUNCHES_BY_MODE["matern52_ard_bwd"].values()) == 1
        assert got[4] is None
        if run:
            assert got[:3] == (None, None, None)
            _assert_grads_close(got[3:4], want[3:4])
        else:
            _assert_grads_close(got[:4], want[:4])
            _assert_params_within_rounding(got, grad, args, None, mask2)


# The feature kernel's layouts: L-BFGS-B's, side 1 (x2's gradient), a
# flush's grouped rows and masks, masked dims with a batched x1, categorical
# dims beside the continuous ones, Dc = 64 (the exact path's widest in the
# reference) and Dc = 80 (two passes of 32 dims and a third of 16), a shared
# query side against grouped data rows, and other sides past 8 x 128 rows.
_FEATURE_LAYOUTS = {
    "lbfgsb": dict(b=1, n=16, m=1024, dc=20, ds=0, valid2=1000, sides=(True, False)),
    "side1": dict(b=1, n=50, m=300, dc=20, ds=0, valid1=45, sides=(False, True)),
    "grouped": dict(studies=2, group=3, n=40, m=70, dc=6, ds=2, valid=60, step=3, valid1=35,
                    step1=1),
    "masked_dims_batched": dict(b=2, n=30, m=45, dc=8, ds=4, batched=True, masked_dims=True),
    "mixed": dict(b=3, n=20, m=200, dc=5, ds=3, valid1=18, valid2=190),
    "dc64": dict(b=1, n=16, m=500, dc=64, ds=0, valid2=480),
    "dc80": dict(b=2, n=12, m=300, dc=80, ds=2),
    "shared_queries_grouped_data": dict(studies=2, group=2, n=16, m=129, dc=20, ds=0,
                                        valid=120, step=5, shared_x1=True),
    "long_other_side": dict(b=1, n=3, m=2500, dc=20, ds=0, valid2=2400),
}


def _feature_layout(device, spec):
    """(args, mask1, mask2, need_x1, need_x2) for one of _FEATURE_LAYOUTS."""
    spec = dict(spec)
    if "studies" in spec:
        studies, group = spec.pop("studies"), spec.pop("group")
        shared_x1 = spec.pop("shared_x1", False)
        args, (mask1, mask2, _) = _flush_args(device, studies, group, **spec)
        if shared_x1:
            args = (args[0][0].contiguous(), args[1][0].contiguous()) + args[2:]
            mask1 = None
        return args, mask1, mask2, True, True
    need_x1, need_x2 = spec.pop("sides", (True, True))
    masked_dims = spec.pop("masked_dims", False)
    valid1, valid2 = spec.pop("valid1", None), spec.pop("valid2", None)
    args = _args(device, **spec)
    if masked_dims:
        inv, inv_sq = args[5].clone(), args[6].clone()
        inv[:, spec["dc"] // 2:] = 0.0
        inv_sq[:, spec["ds"] // 2:] = 0.0
        args = args[:5] + (inv, inv_sq)
    mask1, mask2, _ = _masks(device, spec["b"], spec["n"], spec["m"], valid1, valid2)
    return args, mask1, mask2, need_x1, need_x2


@pytest.mark.parametrize("layout", sorted(_FEATURE_LAYOUTS))
def test_feature_kernel_matches_plain_in_both_modes(cuda_device, layout):
    """The feature kernel alone and after the parameter kernel against the
    plain versions (1e-4 of the largest entry), each run twice with the same
    floats, and the same floats in both modes."""
    args, mask1, mask2, need_x1, need_x2 = _feature_layout(cuda_device, _FEATURE_LAYOUTS[layout])
    b, n, m = args[4].shape[0], args[0].shape[-2], args[2].shape[-2]
    grad = torch.randn((b, n, m), generator=torch.Generator(device=cuda_device).manual_seed(7),
                       device=cuda_device)
    sides = dict(need_x1=need_x1, need_x2=need_x2)
    want = tk.matern52_ard_features_plain(grad, *args, mask1, mask2, **sides)
    got = {}
    for mode, run in (("features", {}), ("features_only", dict(need_params=False))):
        first = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, **sides, **run)
        again = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, **sides, **run)
        for g, h, w in zip(first[3:], again[3:], want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, h)
        _assert_grads_close(first[3:], want)
        got[mode] = first
    assert got["features_only"][:3] == (None, None, None)
    for g, h in zip(got["features"][3:], got["features_only"][3:]):
        assert (g is None and h is None) or torch.equal(g, h)
    _assert_params_within_rounding(got["features"], grad, args, mask1, mask2)


def test_a_query_gradient_launches_one_kernel_and_no_scratch(cuda_device):
    """A backward with the parameters detached and the query side's gradient
    only: one device kernel (the profiler's count against the wrapper's one
    "features_only" call), and no [B, N, M] scratch: the backward allocates
    the query gradient alone."""
    from torch.profiler import ProfilerActivity, profile

    args = _args(cuda_device, 1, 16, 1024, 20, 0)
    _, mask2, _ = _masks(cuda_device, 1, 16, 1024, None, 1000)
    x1 = args[0].clone().requires_grad_(True)
    out = tk.matern52_ard(
        tk.MixedFeatures(x1, args[1]), tk.MixedFeatures(args[2], args[3]),
        amplitude=args[4], continuous_length_scales=1.0 / args[5],
        categorical_length_scales=torch.ones((1, 0), device=cuda_device), row_mask2=mask2)
    grad = torch.randn(out.shape, device=cuda_device)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (gx1,) = torch.autograd.grad(out, x1, grad)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert kernels and all("matern52_bwd_features_kernel" in k for k in kernels)
    assert len(kernels) == 1
    assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"] == dict(
        gram=0, cross=0, other=0, features=0, features_only=1)
    want = tk.matern52_ard_bwd_plain(grad, x1.detach(), *args[1:], None, mask2)[3]
    _assert_grads_close([gx1], [want])
    # The kernel's own allocations: the [16, 20] query gradient only.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tk.matern52_ard_bwd_cuda(grad, x1.detach(), *args[1:], None, mask2, need_params=False,
                             need_x1=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 4 * 16 * 1024


def _lbfgsb_score(device, n=1000, n_pad=1024, dim=20):
    """A UCB ScoringFunction with its trust region over a posterior of n
    random rows (unit-scale parameters), on ``device``."""
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((n_pad, dim), generator=gen)
    labels = torch.sin(3 * x).sum(-1) + 0.1 * torch.randn(n_pad, generator=gen)
    mask = torch.arange(n_pad) < n
    data = gp_lib.GPData(
        continuous=x.to(device), categorical=torch.zeros((n_pad, 0), dtype=torch.int32,
                                                         device=device),
        labels=torch.where(mask, labels, torch.zeros_like(labels)).to(device),
        row_mask=mask.to(device), cont_dim_mask=torch.ones(dim, dtype=torch.bool, device=device),
        cat_dim_mask=torch.ones(0, dtype=torch.bool, device=device))
    model = gp_lib.VizierGaussianProcess(num_continuous=dim, num_categorical=0, device=device)
    params = {"amplitude": torch.ones(1, device=device),
              "noise_stddev": torch.full((1,), 0.1, device=device),
              "continuous_length_scales": torch.ones((1, dim), device=device)}
    state = model.precompute_constrained(params, data)
    return acquisitions.ScoringFunction(
        predictive=gp_lib.EnsemblePredictive(state), acquisition=acquisitions.UCB(1.8),
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
        trust_region=acquisitions.TrustRegion.from_data(data))


def test_lbfgsb_step_gradient_on_the_card_matches_the_cpu(cuda_device):
    """The L-BFGS-B loss's gradient at 16 restarts' starting points through
    K1/K2 on the card against the plain autograd on the CPU, within 1e-3
    relative to its largest entry; K2's feature kernel ran once, alone."""
    from vizier_tpu_torch.optimizers import lbfgsb_optimizer

    z0 = 2.0 * torch.randn((16, 20), generator=torch.Generator().manual_seed(1))
    grads = {}
    for device in (cuda_device, torch.device("cpu")):
        opt = lbfgsb_optimizer.LBFGSBOptimizer(device=device)
        z = z0.to(device).requires_grad_(True)
        tk.reset_launch_counts()
        loss = opt.loss_fn(_lbfgsb_score(device).score)(z)
        (grads[device.type],) = torch.autograd.grad(loss.sum(), z)
        if device.type == "cuda":
            # The GP's parameters are constants: the feature kernel alone.
            assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"]["features_only"] == 1
            assert sum(tk.LAUNCHES_BY_MODE["matern52_ard_bwd"].values()) == 1
    want = grads["cpu"]
    torch.testing.assert_close(grads["cuda"].cpu(), want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


def test_the_runtimes_coalescer_and_fallback_around_a_small_default(cuda_device):
    """The serving runtime's coalescer, breaker and quasi-random fallback
    around the DEFAULT on the card (no protobuf): 4 coalesced requests make
    one computation with no fallback stamp; a failing computation degrades
    to stamped points; the breaker opens after 3 failures and a probe on the
    card closes it."""
    import threading
    import time

    from vizier_tpu_torch import reliability
    from vizier_tpu_torch.pythia import local_policy_supporters, policy as policy_lib
    from vizier_tpu_torch.service import policy_factory
    from vizier_tpu_torch.serving import coalescer as coalescer_lib
    from vizier_tpu_torch.serving import config as serving_config
    from vizier_tpu_torch.serving import runtime as runtime_lib

    rt = runtime_lib.ServingRuntime(
        serving_config.ServingConfig(batching=False),
        reliability=reliability.ReliabilityConfig(breaker_cooldown_secs=0.2))
    factory = policy_factory.DefaultPolicyFactory(rt, device="cuda")
    config = vz.StudyConfig(algorithm="DEFAULT")
    for j in range(4):
        config.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    config.metric_information.append(vz.MetricInformation(name="obj"))
    config.metadata.ns("gp_ucb_pe")["max_acquisition_evaluations"] = "500"
    supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid="s")
    rng = np.random.default_rng(0)
    for _ in range(12):
        t = vz.Trial(parameters={f"x{j}": float(rng.uniform()) for j in range(4)})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        supporter.AddTrials([t])
    calls = []

    def request(fail=False):
        descriptor = supporter.study_descriptor()

        def compute():
            calls.append(fail)
            if fail:
                raise RuntimeError("injected")
            return factory(config, "DEFAULT", supporter, "s").suggest(
                policy_lib.SuggestRequest(study_descriptor=descriptor, count=2))

        return rt.guarded_suggest("s", compute, lambda reason: reliability.suggest_fallback(
            config.to_problem(), 2, study_name="s", max_trial_id=descriptor.max_trial_id,
            reason=reason))

    key = coalescer_lib.suggest_key("s", "h", "DEFAULT", 12, 2)
    outs = [None] * 4
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait()
        outs[i] = rt.coalescer.coalesce(key, request)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert calls == [False] and all(o is outs[0] for o in outs)
    assert len(outs[0].decision.suggestions) == 2 and not any(
        reliability.is_fallback_suggestion(s.metadata) for s in outs[0].decision.suggestions)
    for _ in range(3):
        out = request(fail=True)
        assert len(out.fallbacks) == 2 and reliability.is_fallback_suggestion(out.fallbacks[0].metadata)
    assert rt.breakers.get("s").state == "open"
    assert request().fallbacks and len(calls) == 4
    time.sleep(0.25)
    assert request().decision is not None and rt.breakers.get("s").state == "closed"
    rt.shutdown()


def test_a_speculative_hit_and_a_shed_on_the_card(cuda_device):
    """The runtime's speculative engine and admission gate around a small
    DEFAULT on the card, through the protobuf-free entries: a completion
    parks one batch computed on the card by the engine's worker, the next
    suggest at that frontier is served from it stamped ``speculative=hit``
    with no kernel launch, and while one tenant's computation holds the only
    admission slot another tenant is shed with a retry-after hint."""
    from vizier_tpu_torch import reliability
    from vizier_tpu_torch.pythia import local_policy_supporters, policy as policy_lib
    from vizier_tpu_torch.service import policy_factory
    from vizier_tpu_torch.serving import admission, speculative
    from vizier_tpu_torch.serving import config as serving_config
    from vizier_tpu_torch.serving import runtime as runtime_lib

    rt = runtime_lib.ServingRuntime(
        serving_config.ServingConfig(),
        speculative=speculative.SpeculativeConfig(speculative=True, default_count=2),
        admission=admission.AdmissionConfig(enabled=True, max_inflight=1))
    factory = policy_factory.DefaultPolicyFactory(rt, device="cuda")
    config = vz.StudyConfig(algorithm="DEFAULT")
    for j in range(4):
        config.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    config.metric_information.append(vz.MetricInformation(name="obj"))
    config.metadata.ns("gp_ucb_pe")["max_acquisition_evaluations"] = "500"
    name = "owners/a/studies/s"
    supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid=name)
    rng = np.random.default_rng(0)
    for _ in range(12):
        t = vz.Trial(parameters={f"x{j}": float(rng.uniform()) for j in range(4)})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        supporter.AddTrials([t])
    shed = []

    def fallback(reason):
        return reliability.suggest_fallback(config.to_problem(), 2, study_name=name,
                                            max_trial_id=supporter.study_descriptor().max_trial_id,
                                            reason=reason)

    def live(count=2):
        descriptor = supporter.study_descriptor()

        def compute():
            if not speculative.in_speculative_compute():
                shed.append(rt.admitted_suggest("owners/b/studies/s", None, fallback))
            return factory(config, "DEFAULT", supporter, name).suggest(
                policy_lib.SuggestRequest(study_descriptor=descriptor, count=count))

        return rt.admitted_suggest(name, lambda: rt.guarded_suggest(name, compute, fallback),
                                   fallback)

    def frontier():
        trials = supporter.GetTrials()
        return speculative.make_fingerprint(
            b"config", [t.id for t in trials if t.status == vz.TrialStatus.COMPLETED],
            [t.id for t in trials if t.status == vz.TrialStatus.ACTIVE])

    rt.bind_speculative(lambda study: (frontier(), supporter.study_descriptor().max_trial_id),
                        lambda study, count, max_id: live(count), runtime_lib.accept_guarded)

    def suggest():
        return rt.speculative_suggest(name, 2, frontier, live, runtime_lib.stamp_speculative_hit,
                                      lambda out: out.error is None)

    try:
        first = suggest()
        assert first.decision is not None and len(first.suggestions) == 2
        assert isinstance(shed[0].error, admission.AdmissionShedError)
        assert "retry_after_ms=" in str(shed[0].error)
        for s in first.suggestions:
            t = s.to_trial()
            t.complete(vz.Measurement(metrics={"obj": 0.5}))
            supporter.AddTrials([t])
        rt.notify_trial_event(name)
        assert rt.speculative_engine.wait_idle(120.0)
        parked = rt.designer_cache.peek(name).speculative
        assert parked is not None and len(shed) == 1
        tk.reset_launch_counts()
        hit = suggest()
        assert sum(sum(m.values()) for m in tk.LAUNCHES_BY_MODE.values()) == 0
        assert all(s.metadata.ns("serving").get("speculative") == "hit" for s in hit.suggestions)
        assert [s.parameters.as_dict() for s in hit.suggestions] == [
            s.parameters.as_dict() for s in parked.response.suggestions]
        counters = rt.snapshot()
        assert counters["speculative_hits"] == 1 and counters["speculative_errors"] == 0
        assert counters["admission_sheds"] == 1
    finally:
        rt.shutdown()


def test_two_frontends_studies_routed_by_the_router_fuse_into_one_flush(cuda_device):
    """The fleet's routing onto one shared runtime, small: the port's
    ``StudyRouter`` places 4 studies of 10-13 trials x 4-D (one padding
    bucket with their 2 pending picks) on two frontend
    ids (each owning at least one), each frontend sends its own studies'
    ``suggest(2)`` on a thread of its own, and the one runtime serves all 4
    in one flush through the kernels, with no fallback or slot error."""
    import dataclasses
    import threading

    from vizier_tpu_torch.distributed import routing
    from vizier_tpu_torch.pythia import local_policy_supporters, policy as policy_lib
    from vizier_tpu_torch.service import policy_factory
    from vizier_tpu_torch.serving import config as serving_config
    from vizier_tpu_torch.serving import runtime as runtime_lib

    router = routing.StudyRouter(["frontend-0", "frontend-1"])
    names = [f"owners/fleet/studies/s{i}" for i in range(4)]
    assert {router.replica_for(n) for n in names} == {"frontend-0", "frontend-1"}
    rt = runtime_lib.ServingRuntime(dataclasses.replace(
        serving_config.ServingConfig(), batch_max_wait_ms=2000.0))
    factory = policy_factory.DefaultPolicyFactory(rt, device="cuda")
    studies = {}
    for i, name in enumerate(names):
        config = vz.StudyConfig(algorithm="DEFAULT")
        for j in range(4):
            config.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
        config.metric_information.append(vz.MetricInformation(name="obj"))
        config.metadata.ns("gp_ucb_pe")["max_acquisition_evaluations"] = "500"
        supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid=name)
        rng = np.random.default_rng(i)
        for _ in range(10 + i):
            t = vz.Trial(parameters={f"x{j}": float(rng.uniform()) for j in range(4)})
            t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
            supporter.AddTrials([t])
        studies[name] = (config, supporter)
    results, errors = {}, []

    def handle(name):
        try:
            config, supporter = studies[name]
            policy = factory(config, "DEFAULT", supporter, name)
            results[name] = policy.suggest(policy_lib.SuggestRequest(
                study_descriptor=supporter.study_descriptor(), count=2)).suggestions
        except BaseException as e:  # surfaced below
            errors.append(e)

    def frontend(own):
        handlers = [threading.Thread(target=handle, args=(n,)) for n in own]
        for t in handlers:
            t.start()
        for t in handlers:
            t.join(timeout=300)

    by_frontend = {}
    for name in names:
        by_frontend.setdefault(router.replica_for(name), []).append(name)
    tk.reset_launch_counts()
    before = rt.stats.snapshot()
    threads = [threading.Thread(target=frontend, args=(own,)) for own in by_frontend.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    assert not errors, errors
    stats = {k: rt.stats.get(k) - before[k] for k in (
        "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors")}
    assert stats == {"batch_flushes": 1, "batched_suggests": 4, "batch_fallbacks": 0,
                     "batch_slot_errors": 0}
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["gram"] > 0
    for name in names:
        assert len(results[name]) == 2
        for s in results[name]:
            values = [s.parameters.get_value(f"x{j}") for j in range(4)]
            assert all(np.isfinite(values)) and all(0.0 <= v <= 1.0 for v in values)
    rt.shutdown()


def test_chaos_strikes_through_the_executor_on_the_card(cuda_device):
    """A per-slot strike degrades only its slot, the other slots equal an
    unstruck flush; a device-program strike runs the whole-batch sequential
    fallback, each slot equal to its study's own suggest; the executor's
    counters equal the injected strikes (``vizier_tpu_torch/testing/chaos_flushes.py``)."""
    
    from vizier_tpu_torch.testing import chaos_flushes

    tk.reset_launch_counts()
    per_slot = chaos_flushes.per_slot_strike("cuda")
    assert per_slot["faults"] == 1 and per_slot["equal"] == [True, True]
    fallback = chaos_flushes.device_program_strike("cuda")
    assert fallback["faults"] == 1 and fallback["equal"] == [True, True]
    torch.cuda.synchronize()
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["gram"] > 0


def test_simplekd_convergence_on_the_card(cuda_device):
    """The JAX package's GP-bandit SimpleKD gate (40 trials, batch 5, within
    0.6 of the optimum, seed 1) with the port's designer on CUDA: SimpleKD's
    mixed layout (one categorical, one discrete, one int, two floats)."""
    from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit
    from vizier_tpu_torch.optimizers.lbfgs import AdamOptimizer
    from vizier_tpu_torch.testing import simplekd_runner

    ard = AdamOptimizer(maxiter=40, device="cuda")

    def factory(problem, seed=None, **kw):
        return VizierGPBandit(problem, rng_seed=seed or 0, max_acquisition_evaluations=1500,
                              ard_restarts=4, ard_optimizer=ard, num_seed_trials=5,
                              device="cuda")

    tk.reset_launch_counts()
    tester = simplekd_runner.SimpleKDConvergenceTester(
        num_trials=40, batch_size=5, max_abs_error=0.6, seed=1)
    assert tester.assert_converges(factory) > -0.6
    torch.cuda.synchronize()
    assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"]["gram"] > 0


def _soak_train(device, studies=None, seed=0):
    """A 2-D ARD train at a soak layout: the model, its bound loss and inits
    (a warm row and 2 restarts per study); ``studies`` S stacks S studies'
    data as a flush does."""
    from vizier_tpu_torch.models import gp as tgp
    from vizier_tpu_torch.optimizers import graphs

    model = tgp.VizierGaussianProcess(num_continuous=2, num_categorical=0, device=device)
    if studies is None:
        data = _gp_data(device, 16, 10, 2, 0, seed=seed)
    else:
        parts = [_gp_data(device, 16, 6 + s, 2, 0, seed=seed + s) for s in range(studies)]
        data = tgp.GPData(*(torch.stack([getattr(p, f) for p in parts])
                            for f in ("continuous", "categorical", "labels", "row_mask",
                                      "cont_dim_mask", "cat_dim_mask")))
    inits = model.param_collection().batch_random_init_unconstrained(
        torch.Generator(device=device).manual_seed(seed), 3 * (studies or 1))
    return graphs.BoundLoss(model.neg_log_likelihood, data), inits


@pytest.mark.parametrize("studies", [None, 8], ids=["one_study", "flush_of_8"])
def test_a_graphed_adam_train_equals_the_eager_one(cuda_device, studies):
    """The captured ARD loop gives the eager loop's result on the data it was
    captured with and on new data of the same layout (up to float32 rounding:
    under capture the NLL's solve is two triangular solves, not MAGMA's
    cholesky_solve), and counts the kernels' launches when it replays them,
    as the eager loop counts them."""
    from vizier_tpu_torch.optimizers import graphs, lbfgs

    graphs.clear()
    eager = lbfgs.AdamOptimizer(maxiter=10, device="cuda")
    graphed = lbfgs.AdamOptimizer(maxiter=10, device="cuda", cuda_graph=True)
    before = dict(graphs.STATS)
    for seed in (0, 1):
        loss, inits = _soak_train(cuda_device, studies, seed=seed)
        tk.reset_launch_counts()
        want = eager(loss, inits, best_n=1, groups=studies or 1)
        torch.cuda.synchronize()
        eager_launches = {k: dict(v) for k, v in tk.LAUNCHES_BY_MODE.items()}
        got = graphed(loss, inits, best_n=1, groups=studies or 1)
        if seed == 1:  # replayed, not captured: its launches alone
            tk.reset_launch_counts()
            got = graphed(loss, inits, best_n=1, groups=studies or 1)
            torch.cuda.synchronize()
            assert tk.LAUNCHES_BY_MODE == eager_launches
        for k in want.params:
            torch.testing.assert_close(got.params[k], want.params[k], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.losses, want.losses, rtol=1e-4, atol=1e-5)
    # One step and one final loss captured, for both datasets' layout.
    assert graphs.STATS["captures"] - before["captures"] == 2
    assert graphs.STATS["served"] - before["served"] == 3
    assert graphs.STATS["failures"] == before["failures"]


# The benchmark slice's layouts: all-categorical studies (NASBench-101's 21
# bools + 5 ops, pest control's 25 five-valued stages, a 60-variable MAXSAT)
# stage several chunks of categorical slots and no continuous one; the
# sparse-wrapped 20-D Sphere has 40 floats. Each as the designers launch it:
# the ARD train's masked Gram over a padded trial bucket, and the sweep's
# cross kernel against the data rows.
_BENCHMARK_LAYOUTS = {
    "nasbench101_dc0_ds26": dict(dc=0, ds=26, n=64, valid=50),
    "pest_control_dc0_ds25": dict(dc=0, ds=25, n=64, valid=45),
    "maxsat60_dc0_ds60": dict(dc=0, ds=60, n=64, valid=40),
    "sparse_sphere_dc40": dict(dc=40, ds=0, n=64, valid=40),
}


@pytest.mark.parametrize("tile", [-1, 0, 1], ids=["chosen", "big", "tiny"])
@pytest.mark.parametrize("kind", ["gram", "cross"])
@pytest.mark.parametrize("layout", sorted(_BENCHMARK_LAYOUTS))
def test_benchmark_layouts_match_plain_at_every_tile(cuda_device, layout, kind, tile):
    """K1 and K2 at each layout against their plain versions, each tile
    forced in turn: the Gram with its masks and diagonal (triangles equal),
    the cross kernel at 50 queries with the data side masked, K2 with the
    feature gradients."""
    from vizier_tpu_torch.ops import native

    case = _BENCHMARK_LAYOUTS[layout]
    n, dc, ds, valid = case["n"], case["dc"], case["ds"], case["valid"]
    lib = native.library()
    assert lib.matern52_force_tile(tile) == 0
    try:
        if kind == "gram":
            args = _args(cuda_device, 4, n, n, dc, ds, same=True, seed=5)
            mask1, mask2, diag = _masks(cuda_device, 4, n, n, valid, same=True, diag=True)
        else:
            args = _args(cuda_device, 1, 50, n, dc, ds, seed=6)
            mask1, mask2, diag = _masks(cuda_device, 1, 50, n, None, valid)
        want = tk.matern52_ard_fwd_plain(*args, mask1, mask2, diag)
        got = tk.matern52_ard_fwd_cuda(*args, mask1, mask2, diag)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if kind == "gram":
            assert torch.equal(got, got.transpose(-1, -2))
        grad = torch.randn(want.shape, device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(7))
        features = dict(need_x1=True, need_x2=True) if kind == "cross" else {}
        got_g = tk.matern52_ard_bwd_cuda(grad, *args, mask1, mask2, **features)
        want_g = tk.matern52_ard_bwd_plain(grad, *args, mask1, mask2)
        _assert_grads_close(got_g if features else got_g[:3], want_g if features else want_g[:3])
        _assert_params_within_rounding(got_g, grad, args, mask1, mask2)
    finally:
        lib.matern52_force_tile(-1)


@pytest.mark.parametrize("experimenter", ["nasbench101", "pest_control"])
def test_the_default_serves_an_all_categorical_study_through_the_kernels(cuda_device,
                                                                        experimenter):
    """The DEFAULT on CUDA through the benchmark runner on a study with no
    continuous parameter: every suggestion inside the space, every trial
    completed (feasible or not), K1's Gram and cross and K2's Gram launched."""
    from vizier_tpu_torch.benchmarks import BenchmarkRunner, BenchmarkState, GenerateAndEvaluate
    from vizier_tpu_torch.benchmarks.experimenters import combinatorial, nasbench101

    if experimenter == "nasbench101":
        exp = nasbench101.NASBench101Experimenter(
            nasbench101.synthetic_nasbench101(num_cells=64, seed=0)[0])
    else:
        exp = combinatorial.PestControlExperimenter(seed=0)
    state = BenchmarkState.from_designer_factory(
        exp, lambda p, **kw: gp_ucb_pe.VizierGPUCBPEBandit(
            p, ard_restarts=2, max_acquisition_evaluations=1000, num_seed_trials=5))
    tk.reset_launch_counts()
    BenchmarkRunner([GenerateAndEvaluate(5)], num_repeats=3).run(state)
    torch.cuda.synchronize()
    space = exp.problem_statement().search_space
    trials = state.algorithm.supporter.GetTrials()
    assert len(trials) == 15
    for t in trials:
        assert t.is_completed
        for name in space.parameter_names():
            assert space.get(name).contains(t.parameters[name].value)
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["gram"] > 0
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["cross"] > 0
    assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"]["gram"] > 0


def _prewarm_problem(dims=2):
    problem = vz.ProblemStatement()
    for d in range(dims):
        problem.search_space.root.add_float_param(f"x{d}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return problem


def _graphed_factory(p):
    from vizier_tpu_torch.optimizers import lbfgs

    return gp_ucb_pe.VizierGPUCBPEBandit(
        p, rng_seed=0, device="cuda", ard_restarts=4, max_acquisition_evaluations=500,
        ard_optimizer=lbfgs.AdamOptimizer(maxiter=10, device="cuda", cuda_graph=True),
        warm_start_min_trials=0)


def test_a_prewarmed_bucket_captures_no_graph_on_its_first_flush(cuda_device):
    """After ``BatchExecutor.prewarm`` over a bucket, a live flush of that
    bucket's layout replays the captured ARD steps: no new capture."""
    import threading

    from vizier_tpu_torch.algorithms import core as core_lib
    from vizier_tpu_torch.optimizers import graphs
    from vizier_tpu_torch.parallel import batch_executor

    graphs.clear()
    problem = _prewarm_problem()
    ex = batch_executor.BatchExecutor(max_batch_size=4, max_wait_ms=2000)
    try:
        report = ex.prewarm(problem, _graphed_factory, max_trials=16)
        assert [(r["pad_trials"], r["batch_size"]) for r in report] == [
            (8, 1), (8, 4), (16, 1), (16, 4)]
        assert all(r["status"] == "ok" and r["captures"] > 0 for r in report)
        rng = np.random.default_rng(0)
        designers = []
        for s in range(4):
            d = _graphed_factory(problem)
            trials = []
            for i in range(10 + s % 3):
                t = vz.Trial(id=i + 1, parameters={"x0": rng.random(), "x1": rng.random()})
                t.complete(vz.Measurement(metrics={"y": float(rng.random())}))
                trials.append(t)
            d.update(core_lib.CompletedTrials(trials))
            designers.append(d)
        before = dict(graphs.STATS)
        out = [None] * 4
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, ex.suggest(designers[i], 1))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(o is not None and len(o) == 1 for o in out)
        assert graphs.STATS["captures"] == before["captures"]
        assert graphs.STATS["served"] > before["served"]
        assert graphs.STATS["failures"] == before["failures"]
    finally:
        ex.close()


def test_a_device_phase_event_time_lies_within_its_wall(cuda_device):
    """CUDA events around the stage on the current stream: the device time
    is positive and no longer than the host wall around it; the first run of
    a name is compile, the next execute."""
    from vizier_tpu_torch.observability import config as obs_config
    from vizier_tpu_torch.observability import device_timing

    device_timing.set_config(obs_config.ObservabilityConfig())
    device_timing.reset_compile_tracking()
    try:
        modes = []
        for _ in range(2):
            with device_timing.device_phase("cuda_test.matmul", cuda_device) as phase:
                x = torch.rand((1024, 1024), device=cuda_device)
                for _ in range(20):
                    x = torch.tanh(x @ x / 1024.0)
            modes.append(phase.mode)
            assert phase.device_ms is not None and 0.0 < phase.device_ms <= phase.host_ms
        assert modes == ["compile", "execute"]
        # A designer's sequential suggest on the card times its stages too.
        from vizier_tpu_torch.algorithms import core as core_lib

        d = _graphed_factory(_prewarm_problem())
        rng = np.random.default_rng(1)
        trials = []
        for i in range(12):
            t = vz.Trial(id=i + 1, parameters={"x0": rng.random(), "x1": rng.random()})
            t.complete(vz.Measurement(metrics={"y": float(rng.random())}))
            trials.append(t)
        d.update(core_lib.CompletedTrials(trials))
        d.suggest(1)
        rows = [r for r in device_timing.recent() if r[0].startswith("gp_ucb_pe.")]
        assert [r[0] for r in rows] == ["gp_ucb_pe.train_gp", "gp_ucb_pe.acquisition"]
        assert all(0.0 < event <= host for _, _, host, event in rows)
    finally:
        device_timing.set_config(None)
        device_timing.reset_compile_tracking()


# -- the single-host mesh (chip_smoke.py's mesh phase, at small sizes) ----------


def _logical_mesh(monkeypatch, n=4):
    """The port's device list as ``n`` entries of cuda:0 (this test alone)."""
    from vizier_tpu_torch import parallel
    from vizier_tpu_torch.parallel import mesh as mesh_lib

    def devices(device="cuda"):
        del device
        return [torch.device("cuda", 0)] * n

    monkeypatch.setattr(mesh_lib, "local_devices", devices)
    monkeypatch.setattr(parallel, "local_devices", devices)
    monkeypatch.setenv("VIZIER_TORCH_DISABLE_MESH", "1")


def _mesh_designers(seeds, n=12, graphed=False, use_mesh=None):
    from vizier_tpu_torch.algorithms import core as core_lib
    from vizier_tpu_torch.optimizers import lbfgs

    designers = []
    for seed in seeds:
        optimizer = (lbfgs.AdamOptimizer(maxiter=10, device="cuda", cuda_graph=True) if graphed
                     else lbfgs.LbfgsOptimizer(maxiter=20, device="cuda"))
        d = gp_ucb_pe.VizierGPUCBPEBandit(
            _prewarm_problem(4), rng_seed=seed, device="cuda", ard_restarts=4,
            max_acquisition_evaluations=500, ard_optimizer=optimizer, warm_start_min_trials=0,
            use_mesh=use_mesh)
        rng = np.random.default_rng(seed)
        trials = []
        for i in range(n + seed % 3):
            x = rng.random(4)
            t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[j]) for j in range(4)})
            t.complete(vz.Measurement(metrics={"y": float(-np.sum((x - 0.4) ** 2))}))
            trials.append(t)
        d.update(core_lib.CompletedTrials(trials))
        designers.append(d)
    return designers


def _flush_through(executor, designers, count=2):
    import threading

    out = [None] * len(designers)
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, executor.suggest(designers[i], count))) for i in range(len(designers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None and len(o) == count for o in out)
    return [[s.parameters.as_dict() for s in o] for o in out]


def test_the_default_with_use_mesh_on_the_cards_device_list(cuda_device):
    """One card is a mesh of one: one pool, the restarts unrounded, K1 and
    K2 launched, the suggestions in bounds."""
    (d,) = _mesh_designers([0], use_mesh=True)
    assert d._mesh.size == 1 and d._mesh_restarts(d.ard_restarts) == d.ard_restarts
    tk.reset_launch_counts()
    suggestions = d.suggest(2)
    torch.cuda.synchronize()
    for s in suggestions:
        assert all(0.0 <= v <= 1.0 for v in s.parameters.as_dict().values())
    assert tk.LAUNCHES_BY_MODE["matern52_ard_fwd"]["cross"] > 0
    assert tk.LAUNCHES_BY_MODE["matern52_ard_bwd"]["gram"] > 0


def test_the_sharded_train_and_sweep_on_a_logical_mesh_of_the_card(cuda_device, monkeypatch):
    """Four entries of the one card: the sharded train equals one unsharded
    call at the same inits within 1e-3, and the unsharded optimizer run once
    per restart row (batch 1, as each chunk) within 1e-5; the pool sweep
    equals its pools run one after another."""
    from vizier_tpu_torch import parallel
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.optimizers import graphs
    from vizier_tpu_torch.optimizers import lbfgs

    _logical_mesh(monkeypatch)
    mesh = parallel.create_mesh()
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    (d,) = _mesh_designers([1], n=40)
    data = gp_lib.GPData.from_model_data(d._warped_model_data(), torch.device("cuda", 0))
    inits = d._model.param_collection().batch_random_init_unconstrained(
        torch.Generator(device="cuda").manual_seed(0), 4)
    sharded = parallel.train_gp_sharded(d._model, d._ard, data, None, 4, 1, mesh, inits=inits)
    whole = d._ard(graphs.BoundLoss(d._model.neg_log_likelihood, data), inits, best_n=1)
    alone = d._model.precompute(whole.params, data)
    scale = max(float(torch.max(torch.abs(v))) for v in alone.params.values())
    for k, v in alone.params.items():
        assert float(torch.max(torch.abs(sharded.params[k] - v))) <= 1e-3 * scale
    rows = [d._ard(graphs.BoundLoss(d._model.neg_log_likelihood, data),
                   {k: v[i:i + 1] for k, v in inits.items()}, best_n=1) for i in range(4)]
    per_row = d._model.precompute(lbfgs._select_best(
        {k: torch.cat([r.params[k] for r in rows]) for k in rows[0].params},
        torch.cat([r.losses for r in rows]), 1).params, data)
    for k, v in per_row.params.items():
        assert float(torch.max(torch.abs(sharded.params[k] - v))) <= 1e-5 * scale
    scoring = acquisitions.ScoringFunction(
        gp_lib.EnsemblePredictive(alone), acquisitions.UCB(1.8),
        acquisitions.get_best_labels(data.labels, data.row_mask),
        acquisitions.TrustRegion.from_data(data))
    gens = lambda: [torch.Generator(device="cuda").manual_seed(i) for i in range(4)]  # noqa: E731
    pooled = parallel.maximize_acquisition_sharded(d._vec_opt, scoring, gens(), 3, 4, mesh)
    one_by_one = [d._vec_opt(scoring.score, g, count=3) for g in gens()]
    scores = torch.cat([r.scores for r in one_by_one])
    top = torch.sort(scores, descending=True, stable=True).indices[:3]
    torch.testing.assert_close(pooled.scores, scores[top], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(
        pooled.features.continuous,
        torch.cat([r.features.continuous for r in one_by_one])[top], rtol=0, atol=1e-3)


def test_one_placement_on_the_card_is_the_executor_without_the_mesh(cuda_device):
    """MeshConfig(enabled=True) on one card: one placement, no worker
    thread, and a full flush (the same padded batch) equal slot for slot to
    the flush without the mesh."""
    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.parallel.mesh import MeshConfig

    off = batch_executor.BatchExecutor(max_batch_size=4, max_wait_ms=5000)
    one = batch_executor.BatchExecutor(max_batch_size=4, max_wait_ms=5000,
                                       mesh=MeshConfig(enabled=True))
    try:
        want = _flush_through(off, _mesh_designers(range(4)))
        got = _flush_through(one, _mesh_designers(range(4)))
        assert [p.label() for p in one.placements()] == ["mesh0"]
        assert one._workers == [] and one.placement_flush_counts() == {"mesh0": 1}
        assert got == want
    finally:
        off.close()
        one.close()


def test_a_flush_split_over_a_logical_four_entry_mesh(cuda_device, monkeypatch):
    """shard_devices=4 on 4 entries of the card: the flush of 4 padded by
    pad_to and run as 4 chunks of 1, each slot's trained NLL within 1e-3 of
    the flush without the mesh (a batch of 1 per device, not 4: C6), the
    graphed ARD steps captured without a failure."""
    from vizier_tpu_torch.optimizers import graphs
    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.parallel.mesh import MeshConfig

    _logical_mesh(monkeypatch)
    off = batch_executor.BatchExecutor(max_batch_size=4, max_wait_ms=5000)
    split = batch_executor.BatchExecutor(max_batch_size=4, max_wait_ms=5000,
                                         mesh=MeshConfig(enabled=True, shard_devices=4))
    failures = graphs.STATS["failures"]
    try:
        (placement,) = split.placements()
        assert placement.num_devices == 4 and placement.pad_to(4, 4) == 4
        designers = [_mesh_designers(range(4), graphed=True) for _ in range(2)]
        _flush_through(off, designers[0])
        got = _flush_through(split, designers[1])
        for a, b in zip(designers[0], designers[1]):
            (sa,), _ = a._cached_states
            (sb,), _ = b._cached_states
            coll = sa.model.param_collection()
            nll = [float(s.model.neg_log_likelihood(coll.unconstrain(s.params), s.data)[0])
                   for s in (sa, sb)]
            assert abs(nll[0] - nll[1]) <= 1e-3 * max(1.0, abs(nll[0]))
        for slot in got:
            for params in slot:
                assert all(0.0 <= v <= 1.0 for v in params.values())
        assert graphs.STATS["failures"] == failures
        assert split.placement_flush_counts() == {"mesh0": 1}
    finally:
        off.close()
        split.close()
