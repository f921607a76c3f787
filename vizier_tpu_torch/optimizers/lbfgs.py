"""ARD hyperparameter optimizers: batched L-BFGS (the default) and Adam.

Counterpart of the JAX package's ``optimizers/lbfgs.py``. Bounds are handled by the
soft-clip reparameterization (``models.params``), so plain L-BFGS suffices:
a two-loop recursion over fixed-size history buffers plus a warm-started
Armijo backtracking line search, with gtol and patience-based ftol stops.

The JAX package ``vmap``s a ``while_loop`` over restarts; here the restarts
are a leading batch axis of every state tensor (in a cross-study flush,
studies × restarts). A restart that has stopped keeps its state (masked
updates), as a finished member of a vmapped ``while_loop`` does, so it ends
where it would end alone; the loop runs until every restart has stopped,
reading one flag back per step for the whole batch.
Gradients come from autograd through the kernel's ``autograd.Function`` and
``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Protocol, Tuple

import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import params as params_lib

Tensor = torch.Tensor
Params = params_lib.Params
# Batched params [R, ...] -> [R] losses.
LossFn = Callable[[Params], Tensor]

# Matches the reference's published ARD budget.
DEFAULT_RANDOM_RESTARTS = 4


class OptimizeResult(NamedTuple):
    params: Params  # best (or top-k stacked) unconstrained params
    losses: Tensor  # [num_restarts] final losses
    best_loss: Tensor


class Optimizer(Protocol):
    """(loss_fn, batched inits) -> best unconstrained params + diagnostics.

    ``groups`` S splits the restart rows into S studies' consecutive blocks,
    each keeping its own ``best_n`` (a cross-study flush).
    """

    def __call__(
        self, loss_fn: LossFn, init_batch: Params, *, best_n: Optional[int] = None,
        groups: int = 1,
    ) -> OptimizeResult:
        ...


def _two_loop_direction(
    g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor, k: Tensor, memory: int
) -> Tensor:
    """H·g per restart via the two-loop recursion over the circular history."""
    rows = torch.arange(g.shape[0], device=g.device)
    valid_count = torch.clamp(k, max=memory)
    q = g
    alphas: List[Tensor] = []
    for i in range(memory):  # i = 0 is the newest pair
        idx = torch.remainder(k - 1 - i, memory)
        valid = i < valid_count
        alpha = torch.where(
            valid, rho[rows, idx] * torch.sum(s_hist[rows, idx] * q, -1), torch.zeros_like(q[:, 0])
        )
        q = q - alpha[:, None] * y_hist[rows, idx]
        alphas.append(alpha)
    newest = torch.remainder(k - 1, memory)
    s_new, y_new = s_hist[rows, newest], y_hist[rows, newest]
    sy = torch.sum(s_new * y_new, -1)
    yy = torch.sum(y_new * y_new, -1)
    gamma = torch.where((k > 0) & (yy > 1e-20), sy / yy, torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(memory):  # oldest first
        j = memory - 1 - i
        idx = torch.remainder(k - 1 - j, memory)
        valid = j < valid_count
        beta = torch.where(
            valid, rho[rows, idx] * torch.sum(y_hist[rows, idx] * r, -1), torch.zeros_like(r[:, 0])
        )
        step = torch.where(valid, alphas[j] - beta, torch.zeros_like(beta))
        r = r + step[:, None] * s_hist[rows, idx]
    return r


def lbfgs_minimize(
    loss_fn: Callable[[Tensor], Tensor],
    x0: Tensor,
    *,
    maxiter: int = 50,
    memory: int = 10,
    max_linesearch_steps: int = 20,
    gtol: float = 1e-5,
    ftol: float = 1e-6,
    ftol_patience: int = 2,
    armijo_c1: float = 1e-4,
) -> Tuple[Tensor, Tensor]:
    """Minimizes a batched flat-vector loss [R, n] -> [R]; returns (x, f(x)).

    ``ftol`` is a scipy-style relative-decrease stop: once ``ftol_patience``
    consecutive accepted steps each improve the loss by less than
    ``ftol * max(|f|, 1)`` the restart is converged (``ftol <= 0``
    disables). The line search starts from the previous step's length
    (reset to 1 after an unhalved or rejected step).
    """

    def value(x: Tensor) -> Tensor:
        with torch.no_grad():
            return loss_fn(x)

    def value_and_grad(x: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = loss_fn(x)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g.detach()

    num, n = x0.shape
    device, dtype = x0.device, x0.dtype
    rows = torch.arange(num, device=device)
    x = x0.detach()
    f, g = value_and_grad(x)
    s_hist = torch.zeros((num, memory, n), dtype=dtype, device=device)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((num, memory), dtype=dtype, device=device)
    k = torch.zeros(num, dtype=torch.int64, device=device)
    done = torch.zeros(num, dtype=torch.bool, device=device)
    t_init = torch.ones(num, dtype=dtype, device=device)
    small_count = torch.zeros(num, dtype=torch.int64, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    while True:
        active = (k < maxiter) & ~done
        if not bool(active.any()):
            break
        d = -_two_loop_direction(g, s_hist, y_hist, rho, k, memory)
        # Fall back to steepest descent if d is not a descent direction.
        gd = torch.sum(g * d, -1)
        bad = (gd >= 0.0) | ~torch.isfinite(gd)
        d = torch.where(bad[:, None], -g, d)
        gd = torch.where(bad, -torch.sum(g * g, -1), gd)

        # Armijo backtracking from the warm-started step: t <- t/2 until
        # sufficient decrease, per restart.
        t = t_init
        f_new = value(x + t[:, None] * d)
        halvings = torch.zeros(num, dtype=torch.int64, device=device)
        while True:
            insufficient = (f_new > f + armijo_c1 * t * gd) | ~torch.isfinite(f_new)
            searching = active & insufficient & (halvings < max_linesearch_steps)
            if not bool(searching.any()):
                break
            t = torch.where(searching, t * 0.5, t)
            f_new = torch.where(searching, value(x + t[:, None] * d), f_new)
            halvings = halvings + searching.to(halvings.dtype)

        accepted = torch.isfinite(f_new) & (f_new <= f)
        x_new = torch.where(accepted[:, None], x + t[:, None] * d, x)
        f_new = torch.where(accepted, f_new, f)
        g_new = torch.where(accepted[:, None], value_and_grad(x_new)[1], g)

        s = x_new - x
        y = g_new - g
        sy = torch.sum(s * y, -1)
        slot = torch.remainder(k, memory)
        update_hist = active & accepted & (sy > 1e-10)
        s_hist[rows, slot] = torch.where(update_hist[:, None], s, s_hist[rows, slot])
        y_hist[rows, slot] = torch.where(update_hist[:, None], y, y_hist[rows, slot])
        rho[rows, slot] = torch.where(
            update_hist, 1.0 / torch.clamp(sy, min=1e-20), rho[rows, slot]
        )
        small_grad = torch.amax(torch.abs(g_new), -1) < gtol
        small_decrease = (
            accepted
            & (ftol > 0.0)
            & ((f - f_new) <= ftol * torch.clamp(torch.abs(f_new), min=1.0))
        )
        new_small_count = torch.where(small_decrease, small_count + 1, torch.zeros_like(k))
        converged = small_grad | (new_small_count >= ftol_patience)
        unhalved = accepted & (halvings == 0)
        new_t_init = torch.where(
            unhalved | ~accepted, one, torch.clamp(t * 4.0, max=1.0)
        )

        a1 = active[:, None]
        x = torch.where(a1, x_new, x)
        f = torch.where(active, f_new, f)
        g = torch.where(a1, g_new, g)
        k = torch.where(active, k + 1, k)
        done = torch.where(active, converged | ~accepted, done)
        t_init = torch.where(active, new_t_init, t_init)
        small_count = torch.where(active, new_small_count, small_count)
    return x, f


def _select_best(
    finals: Params, losses: Tensor, best_n: Optional[int], groups: int = 1
) -> OptimizeResult:
    """The best restart (``best_n`` None) or the ``best_n`` best, stacked.

    With ``groups`` S > 1 the restarts are S studies' consecutive blocks and
    each study keeps its own ``best_n`` (required then): params [S * best_n],
    ``best_loss`` [S].
    """
    losses = torch.where(torch.isfinite(losses), losses, torch.full_like(losses, float("inf")))
    if groups > 1:
        per_study = losses.reshape(groups, -1)
        # A stable sort breaks ties by restart index, as the reference's top_k does.
        order = torch.sort(per_study, dim=-1, stable=True).indices[:, :best_n]
        top = (order + per_study.shape[1] * torch.arange(groups, device=order.device)[:, None])
        top = top.reshape(-1)
        return OptimizeResult(
            {k: v[top] for k, v in finals.items()}, losses, losses[top[::best_n]]
        )
    # A stable sort breaks ties by restart index, as the reference's top_k does.
    order = torch.sort(losses, stable=True).indices
    if best_n is None:
        best = order[0]
        return OptimizeResult({k: v[best] for k, v in finals.items()}, losses, losses[best])
    top = order[:best_n]
    return OptimizeResult({k: v[top] for k, v in finals.items()}, losses, losses[top[0]])


def _flatten(params: Params) -> Tuple[Tensor, Callable[[Tensor], Params]]:
    """[R, ...] leaves in sorted-key order -> [R, n], and its inverse."""
    names = sorted(params)
    shapes = [tuple(params[k].shape[1:]) for k in names]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([params[k].reshape(params[k].shape[0], -1) for k in names], dim=-1)

    def unravel(x: Tensor) -> Params:
        out, start = {}, 0
        for name, shape, size in zip(names, shapes, sizes):
            out[name] = x[:, start : start + size].reshape((x.shape[0],) + shape)
            start += size
        return out

    return flat, unravel


@dataclasses.dataclass(frozen=True)
class LbfgsOptimizer:
    """Multi-restart L-BFGS; ``best_n`` keeps an ensemble of the best restarts."""

    maxiter: int = 50
    memory_size: int = 10
    max_linesearch_steps: int = 20
    gtol: float = 1e-5
    ftol: float = 1e-6  # <= 0 disables the relative-decrease stop
    ftol_patience: int = 2
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", device_lib.resolve(self.device))

    def __call__(
        self, loss_fn: LossFn, init_batch: Params, *, best_n: Optional[int] = None,
        groups: int = 1,
    ) -> OptimizeResult:
        """Minimizes from every row of ``init_batch``; ``groups`` S splits the
        rows into S studies' blocks, each keeping its ``best_n``."""
        x0, unravel = _flatten(init_batch)
        device_lib.check(x0, self.device, "L-BFGS inits")
        x, f = lbfgs_minimize(
            lambda x: loss_fn(unravel(x)),
            x0,
            maxiter=self.maxiter,
            memory=self.memory_size,
            max_linesearch_steps=self.max_linesearch_steps,
            gtol=self.gtol,
            ftol=self.ftol,
            ftol_patience=self.ftol_patience,
        )
        return _select_best(unravel(x), f, best_n, groups)


@dataclasses.dataclass(frozen=True)
class AdamOptimizer:
    """Adam over every restart at once, for a fixed ``maxiter`` steps.

    optax's ``adam`` update at its defaults, written out: bias-corrected
    first and second moments (b1 0.9, b2 0.999) and eps 1e-8 added outside
    the square root. The loop reads nothing back to the host; each step is
    one batched loss and gradient, and the final losses are taken at the
    last parameters.
    """

    learning_rate: float = 5e-2
    maxiter: int = 200
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", device_lib.resolve(self.device))

    def __call__(
        self, loss_fn: LossFn, init_batch: Params, *, best_n: Optional[int] = None,
        groups: int = 1,
    ) -> OptimizeResult:
        x, unravel = _flatten(init_batch)
        device_lib.check(x, self.device, "Adam inits")
        x = x.detach()
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = torch.zeros_like(x)
        nu = torch.zeros_like(x)
        for step in range(1, self.maxiter + 1):
            with torch.enable_grad():
                leaf = x.requires_grad_(True)
                (g,) = torch.autograd.grad(loss_fn(unravel(leaf)).sum(), leaf)
            mu = (1.0 - b1) * g + b1 * mu
            nu = (1.0 - b2) * (g * g) + b2 * nu
            mu_hat = mu / (1.0 - b1**step)
            nu_hat = nu / (1.0 - b2**step)
            x = x.detach() - self.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
        with torch.no_grad():
            losses = loss_fn(unravel(x))
        return _select_best(unravel(x), losses, best_n, groups)


def default_optimizer(device: device_lib.DeviceLike = "cuda") -> Optimizer:
    return LbfgsOptimizer(device=device)
