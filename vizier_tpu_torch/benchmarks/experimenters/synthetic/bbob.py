"""The 24-function BBOB synthetic benchmark suite.

Parity with
``vizier/_src/benchmarks/experimenters/synthetic/bbob.py``:
the standard BBOB functions (Hansen et al., "Real-Parameter Black-Box
Optimization Benchmarking 2009: Noiseless Functions Definitions") with their
standard transforms (T_osz, T_asy, Lambda conditioning, seeded rotations,
boundary penalty). Implemented batched: every function maps ``[N, D] -> [N]``
so whole candidate batches evaluate in one vectorized call.

All functions have optimum value 0 at the origin (use the Shifting wrapper
to relocate optima).

Copy of the JAX package's ``benchmarks/experimenters/synthetic/bbob.py``, on the port's data model; numpy only.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------


def lambda_alpha(alpha: float, dim: int) -> np.ndarray:
    """Diagonal conditioning matrix Λ^α as a [D] vector."""
    if dim == 1:
        return np.ones(1)
    i = np.arange(dim)
    return alpha ** (0.5 * i / (dim - 1))


def t_osz(x: np.ndarray) -> np.ndarray:
    """Oscillation transform, applied elementwise."""
    xhat = np.where(x != 0, np.log(np.abs(np.where(x != 0, x, 1.0))), 0.0)
    c1 = np.where(x > 0, 10.0, 5.5)
    c2 = np.where(x > 0, 7.9, 3.1)
    return np.sign(x) * np.exp(xhat + 0.049 * (np.sin(c1 * xhat) + np.sin(c2 * xhat)))


def t_asy(x: np.ndarray, beta: float) -> np.ndarray:
    """Asymmetry transform over the last axis."""
    dim = x.shape[-1]
    if dim == 1:
        exponents = np.zeros(1)
    else:
        exponents = beta * np.arange(dim) / (dim - 1)
    pos = x > 0
    safe = np.where(pos, x, 1.0)
    return np.where(pos, safe ** (1.0 + exponents * np.sqrt(safe)), x)


def f_pen(x: np.ndarray) -> np.ndarray:
    """Boundary penalty sum(max(0, |x_i| - 5)^2) over the last axis."""
    return np.sum(np.maximum(0.0, np.abs(x) - 5.0) ** 2, axis=-1)


@functools.lru_cache(maxsize=256)
def _rotation(dim: int, seed: int) -> np.ndarray:
    """Seeded random orthogonal matrix (QR of a Gaussian)."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
    return q * np.sign(np.diag(r))


def _r(dim: int, fn_id: int) -> np.ndarray:
    return _rotation(dim, 1000 + fn_id)


def _q(dim: int, fn_id: int) -> np.ndarray:
    return _rotation(dim, 2000 + fn_id)


def _dim(x: np.ndarray) -> int:
    return x.shape[-1]


def _batch(fn: Callable[[np.ndarray], np.ndarray]):
    """Ensures [N, D] input; output [N]."""

    @functools.wraps(fn)
    def wrapped(x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        return fn(x)

    return wrapped


# ---------------------------------------------------------------------------
# The 24 functions. x: [N, D] -> [N]. Optimum 0 at origin.
# ---------------------------------------------------------------------------


@_batch
def Sphere(x: np.ndarray) -> np.ndarray:
    return np.sum(x**2, axis=-1)


@_batch
def Ellipsoidal(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = t_osz(x)
    cond = 10.0 ** (6.0 * np.arange(d) / max(d - 1, 1))
    return np.sum(cond * z**2, axis=-1)


@_batch
def Rastrigin(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = t_asy(t_osz(x), 0.2) * lambda_alpha(10.0, d)
    return 10.0 * (d - np.sum(np.cos(2 * np.pi * z), axis=-1)) + np.sum(z**2, axis=-1)


@_batch
def BuecheRastrigin(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    t = t_osz(x)
    scales = 10.0 ** (0.5 * np.arange(d) / max(d - 1, 1))
    odd = (np.arange(d) % 2 == 0)  # "odd" indices i=1,3,... in 1-based BBOB
    s = np.where(odd & (t > 0), 10.0 * scales, scales)
    z = s * t
    return (
        10.0 * (d - np.sum(np.cos(2 * np.pi * z), axis=-1))
        + np.sum(z**2, axis=-1)
        + 100.0 * f_pen(x)
    )


@_batch
def LinearSlope(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    # x_opt at the +5 corner; optimum shifted to 0 by the constant term.
    s = 10.0 ** (np.arange(d) / max(d - 1, 1))
    z = np.where(x * 5.0 < 25.0, x, 5.0)
    return np.sum(5.0 * np.abs(s) - s * z, axis=-1)


@_batch
def AttractiveSector(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = (x @ _r(d, 6).T * lambda_alpha(10.0, d)) @ _q(d, 6).T
    s = np.where(z > 0, 100.0, 1.0)
    val = np.sum((s * z) ** 2, axis=-1)
    return t_osz(val.reshape(-1, 1)).reshape(-1) ** 0.9


@_batch
def StepEllipsoidal(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    zhat = (x @ _r(d, 7).T) * lambda_alpha(10.0, d)
    ztilde = np.where(
        np.abs(zhat) > 0.5, np.floor(0.5 + zhat), np.floor(0.5 + 10.0 * zhat) / 10.0
    )
    zr = ztilde @ _q(d, 7).T
    cond = 10.0 ** (2.0 * np.arange(d) / max(d - 1, 1))
    body = np.sum(cond * zr**2, axis=-1)
    first = np.abs(zhat[..., 0]) / 1e4
    return 0.1 * np.maximum(first, body) + f_pen(x)


@_batch
def Rosenbrock(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = np.maximum(1.0, np.sqrt(d) / 8.0) * x + 1.0
    return np.sum(
        100.0 * (z[..., :-1] ** 2 - z[..., 1:]) ** 2 + (z[..., :-1] - 1.0) ** 2, axis=-1
    )


@_batch
def RosenbrockRotated(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    # +1 (not the standard +0.5): keeps the optimum-at-origin convention.
    z = np.maximum(1.0, np.sqrt(d) / 8.0) * (x @ _r(d, 9).T) + 1.0
    return np.sum(
        100.0 * (z[..., :-1] ** 2 - z[..., 1:]) ** 2 + (z[..., :-1] - 1.0) ** 2, axis=-1
    )


@_batch
def EllipsoidalRotated(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = t_osz(x @ _r(d, 10).T)
    cond = 10.0 ** (6.0 * np.arange(d) / max(d - 1, 1))
    return np.sum(cond * z**2, axis=-1)


@_batch
def Discus(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = t_osz(x @ _r(d, 11).T)
    return 1e6 * z[..., 0] ** 2 + np.sum(z[..., 1:] ** 2, axis=-1)


@_batch
def BentCigar(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    r = _r(d, 12)
    z = (t_asy(x @ r.T, 0.5)) @ r.T
    return z[..., 0] ** 2 + 1e6 * np.sum(z[..., 1:] ** 2, axis=-1)


@_batch
def SharpRidge(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = ((x @ _r(d, 13).T) * lambda_alpha(10.0, d)) @ _q(d, 13).T
    return z[..., 0] ** 2 + 100.0 * np.sqrt(np.sum(z[..., 1:] ** 2, axis=-1))


@_batch
def DifferentPowers(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = x @ _r(d, 14).T
    exponents = 2.0 + 4.0 * np.arange(d) / max(d - 1, 1)
    return np.sqrt(np.sum(np.abs(z) ** exponents, axis=-1))


@_batch
def RastriginRotated(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    r, q = _r(d, 15), _q(d, 15)
    z = ((t_asy(t_osz(x @ r.T), 0.2) @ q.T) * lambda_alpha(10.0, d)) @ r.T
    return 10.0 * (d - np.sum(np.cos(2 * np.pi * z), axis=-1)) + np.sum(z**2, axis=-1)


@_batch
def Weierstrass(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    r, q = _r(d, 16), _q(d, 16)
    z = ((t_osz(x @ r.T)) @ q.T * lambda_alpha(0.01, d)) @ r.T
    k = np.arange(12)
    ak = 0.5**k
    bk = 3.0**k
    f0 = np.sum(ak * np.cos(np.pi * bk))
    inner = np.sum(
        ak[None, None, :] * np.cos(2 * np.pi * bk[None, None, :] * (z[..., None] + 0.5)),
        axis=-1,
    )
    return 10.0 * (np.mean(inner, axis=-1) - f0) ** 3 + (10.0 / d) * f_pen(x)


def _schaffers(x: np.ndarray, alpha: float, fn_id: int) -> np.ndarray:
    d = x.shape[-1]
    z = (t_asy(x @ _r(d, fn_id).T, 0.5) @ _q(d, fn_id).T) * lambda_alpha(alpha, d)
    if d == 1:
        s = np.abs(z[..., 0])
    else:
        s = np.sqrt(z[..., :-1] ** 2 + z[..., 1:] ** 2)
    body = np.mean(np.sqrt(s) + np.sqrt(s) * np.sin(50.0 * s**0.2) ** 2, axis=-1) ** 2
    return body + 10.0 * f_pen(x)


@_batch
def SchaffersF7(x: np.ndarray) -> np.ndarray:
    return _schaffers(x, 10.0, 17)


@_batch
def SchaffersF7IllConditioned(x: np.ndarray) -> np.ndarray:
    return _schaffers(x, 1000.0, 18)


@_batch
def GriewankRosenbrock(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    # +1 (not the standard +0.5): keeps the optimum-at-origin convention.
    z = np.maximum(1.0, np.sqrt(d) / 8.0) * (x @ _r(d, 19).T) + 1.0
    if d == 1:
        s = 100.0 * (z[..., :1] ** 2 - z[..., :1]) ** 2 + (z[..., :1] - 1.0) ** 2
    else:
        s = 100.0 * (z[..., :-1] ** 2 - z[..., 1:]) ** 2 + (z[..., :-1] - 1.0) ** 2
    return (10.0 / max(d - 1, 1)) * np.sum(s / 4000.0 - np.cos(s), axis=-1) + 10.0


@_batch
def Schwefel(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    # Optimum at origin in our convention: the canonical 420.96874633 basin
    # center is reached at x = 0 via the +mu shift below.
    mu = 4.2096874633
    z = 100.0 * (lambda_alpha(10.0, d) * x + mu)
    body = -np.sum(z * np.sin(np.sqrt(np.abs(z))), axis=-1) / (100.0 * d)
    return body + 4.189828872724339 + 100.0 * f_pen(z / 100.0)


def _gallagher(x: np.ndarray, num_peaks: int, fn_id: int) -> np.ndarray:
    d = x.shape[-1]
    rng = np.random.default_rng(3000 + fn_id)
    # Peak locations; the global one at the origin with height 10.
    ys = rng.uniform(-4.0, 4.0, size=(num_peaks, d))
    ys[0] = 0.0
    heights = np.concatenate([[10.0], np.linspace(1.1, 9.1, num_peaks - 1)])
    alphas = np.concatenate(
        [[1000.0], 1000.0 ** (2.0 * np.arange(num_peaks - 1) / max(num_peaks - 2, 1))]
    )
    r = _r(d, fn_id)
    xr = x @ r.T
    vals = []
    for i in range(num_peaks):
        c = lambda_alpha(alphas[i], d) / alphas[i] ** 0.25
        diff = xr - ys[i]
        e = np.sum(diff * c * diff, axis=-1)
        vals.append(heights[i] * np.exp(-e / (2.0 * d)))
    best = np.max(np.stack(vals, axis=-1), axis=-1)
    return t_osz((10.0 - best).reshape(-1, 1)).reshape(-1) ** 2 + f_pen(x)


@_batch
def Gallagher101Me(x: np.ndarray) -> np.ndarray:
    return _gallagher(x, 101, 21)


@_batch
def Gallagher21Me(x: np.ndarray) -> np.ndarray:
    return _gallagher(x, 21, 22)


@_batch
def Katsuura(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    z = ((x @ _r(d, 23).T) * lambda_alpha(100.0, d)) @ _q(d, 23).T
    j = 2.0 ** np.arange(1, 33)
    terms = np.abs(j[None, None, :] * z[..., None] - np.round(j[None, None, :] * z[..., None])) / j
    inner = 1.0 + (np.arange(d) + 1.0)[None, :] * np.sum(terms, axis=-1)
    prod = np.prod(inner ** (10.0 / d**1.2), axis=-1)
    return (10.0 / d**2) * prod - 10.0 / d**2 + f_pen(x)


@_batch
def LunacekBiRastrigin(x: np.ndarray) -> np.ndarray:
    d = _dim(x)
    mu0 = 2.5
    s = 1.0 - 1.0 / (2.0 * np.sqrt(d + 20.0) - 8.2)
    mu1 = -np.sqrt((mu0**2 - 1.0) / s)
    # Optimum-at-origin convention: shift the standard xhat = 2 sign(x*) x
    # construction so x = 0 lands on the mu0 basin floor.
    xhat = x + mu0
    z = ((xhat - mu0) @ _r(d, 24).T * lambda_alpha(100.0, d)) @ _q(d, 24).T
    term1 = np.sum((xhat - mu0) ** 2, axis=-1)
    term2 = d + s * np.sum((xhat - mu1) ** 2, axis=-1)
    rastrigin = 10.0 * (d - np.sum(np.cos(2 * np.pi * z), axis=-1))
    return np.minimum(term1, term2) + rastrigin + 1e4 * f_pen(x)


BBOB_FUNCTIONS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "Sphere": Sphere,
    "Ellipsoidal": Ellipsoidal,
    "Rastrigin": Rastrigin,
    "BuecheRastrigin": BuecheRastrigin,
    "LinearSlope": LinearSlope,
    "AttractiveSector": AttractiveSector,
    "StepEllipsoidal": StepEllipsoidal,
    "Rosenbrock": Rosenbrock,
    "RosenbrockRotated": RosenbrockRotated,
    "EllipsoidalRotated": EllipsoidalRotated,
    "Discus": Discus,
    "BentCigar": BentCigar,
    "SharpRidge": SharpRidge,
    "DifferentPowers": DifferentPowers,
    "RastriginRotated": RastriginRotated,
    "Weierstrass": Weierstrass,
    "SchaffersF7": SchaffersF7,
    "SchaffersF7IllConditioned": SchaffersF7IllConditioned,
    "GriewankRosenbrock": GriewankRosenbrock,
    "Schwefel": Schwefel,
    "Gallagher101Me": Gallagher101Me,
    "Gallagher21Me": Gallagher21Me,
    "Katsuura": Katsuura,
    "LunacekBiRastrigin": LunacekBiRastrigin,
}


@_batch
def Branin(x: np.ndarray) -> np.ndarray:
    """The classic 2-D Branin-Hoo function over the standard [-5,10]x[0,15].

    Not part of BBOB, but the canonical GP-BO benchmark (BASELINE.md eval
    configs). Inputs here are in BBOB's [-5, 5] frame and are affinely
    mapped onto Branin's native domain; global minimum value ≈ 0.397887.
    """
    x1 = (x[..., 0] + 5.0) * 1.5 - 5.0  # [-5,5] -> [-5,10]
    x2 = (x[..., 1] + 5.0) * 1.5  # [-5,5] -> [0,15]
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * np.cos(x1) + s


# Non-BBOB extras served through the same interface.
EXTRA_FUNCTIONS = {"Branin": Branin}
