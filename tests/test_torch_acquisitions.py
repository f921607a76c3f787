"""The port's acquisition functions and trust region, elementwise against the JAX package's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.designers.gp import acquisitions as jacq
from vizier_tpu.models import kernels as jk
from vizier_tpu_torch.designers.gp import acquisitions as tacq
from vizier_tpu_torch.models import kernels as tk


def _posterior(seed, n=64):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=n).astype(np.float32)
    stddev = rng.uniform(0.01, 2.0, size=n).astype(np.float32)
    return mean, stddev, np.float32(rng.normal())


@pytest.mark.parametrize(
    "seed,make_j,make_t",
    [
        (0, lambda: jacq.UCB(1.8), lambda: tacq.UCB(1.8)),
        (1, lambda: jacq.UCB(0.5), lambda: tacq.UCB(0.5)),
        (2, jacq.PE, tacq.PE),
        (3, jacq.EI, tacq.EI),
    ],
    ids=["ucb", "ucb_custom", "pe", "ei"],
)
def test_acquisition_matches(seed, make_j, make_t):
    mean, stddev, best = _posterior(seed)
    want = make_j()(jnp.asarray(mean), jnp.asarray(stddev), jnp.asarray(best))
    got = make_t()(torch.tensor(mean), torch.tensor(stddev), torch.tensor(best))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _region(seed, n=20, n_valid=13, dc=3, ds=2):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(size=(n, dc)).astype(np.float32)
    cat = rng.integers(0, 3, size=(n, ds)).astype(np.int32)
    mask = np.arange(n) < n_valid
    q = rng.uniform(-0.2, 1.2, size=(30, dc)).astype(np.float32)
    zq = rng.integers(0, 3, size=(30, ds)).astype(np.int32)
    j = jacq.TrustRegion(jnp.asarray(obs), jnp.asarray(cat), jnp.asarray(mask))
    t = tacq.TrustRegion(torch.tensor(obs), torch.tensor(cat), torch.tensor(mask))
    return j, t, jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq)), tk.MixedFeatures(
        torch.tensor(q), torch.tensor(zq)
    )


@pytest.mark.parametrize("n_valid", [0, 5, 20])
def test_trust_region_matches(n_valid):
    j, t, jq, tq = _region(n_valid, n_valid=n_valid)
    np.testing.assert_allclose(float(t.trust_radius()), float(j.trust_radius()), rtol=1e-6)
    np.testing.assert_allclose(t.linf_distance(tq).numpy(), np.asarray(j.linf_distance(jq)), atol=1e-7)
    np.testing.assert_allclose(t.penalty(tq).numpy(), np.asarray(j.penalty(jq)), atol=1e-5)


def test_best_labels_and_reference_point_match():
    rng = np.random.default_rng(3)
    labels = rng.normal(size=(2, 9)).astype(np.float32)
    for mask in (np.arange(9) < 6, np.zeros(9, bool)):
        for fn in ("get_best_labels", "get_reference_point"):
            want = getattr(jacq, fn)(jnp.asarray(labels), jnp.asarray(mask))
            got = getattr(tacq, fn)(torch.tensor(labels), torch.tensor(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
