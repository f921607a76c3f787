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


@pytest.mark.parametrize(
    "shape",
    [
        dict(b=3, n=64, m=64, dc=20, ds=0, same=True),
        dict(b=1, n=50, m=200, dc=20, ds=0),
        dict(b=2, n=40, m=33, dc=8, ds=4, batched=True),
        dict(b=2, n=31, m=29, dc=80, ds=0),
        dict(b=1, n=7, m=5, dc=0, ds=3),
    ],
    ids=["gram", "cross", "mixed_batched", "wide", "categorical_only"],
)
def test_cuda_kernels_match_plain(cuda_device, shape):
    args = _args(cuda_device, **shape)
    want = tk.matern52_ard_fwd_plain(*args)
    got = tk.matern52_ard_fwd_cuda(*args)
    # The plain >64-D forward uses the matmul expansion (float32 cancellation).
    tol = 1e-3 if shape["dc"] > 64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    grad = torch.randn(want.shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    got_g = tk.matern52_ard_bwd_cuda(grad, *args, need_x1=True, need_x2=True)
    want_g = tk.matern52_ard_bwd_plain(grad, *args)
    for g, w in zip(got_g, want_g):
        # Sums over N·M pairs in another order: relative to the largest entry.
        scale = float(torch.max(torch.abs(w))) if w.numel() else 1.0
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)


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

    before = dict(tk.LAUNCHES)
    got, got_grads = loss(cuda_device)
    assert tk.LAUNCHES["matern52_ard_fwd"] == before["matern52_ard_fwd"] + 1
    assert tk.LAUNCHES["matern52_ard_bwd"] == before["matern52_ard_bwd"] + 1
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
    assert tk.LAUNCHES["matern52_ard_fwd"] > 0 and tk.LAUNCHES["matern52_ard_bwd"] > 0
    for s in suggestions:
        assert 0.0 <= s.parameters.get_value("x") <= 1.0
        assert s.parameters.get_value("c") in ("a", "b", "c")
