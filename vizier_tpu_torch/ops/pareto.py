"""Pareto-frontier and hypervolume ops on tensors.

Counterpart of the JAX package's ``ops/pareto.py``: domination tests,
frontier masks, Pareto rank, NSGA-II layers and crowding distance, and the
random-direction cumulative hypervolume, all batched tensor ops (MAXIMIZE
convention) that run on the points' device.

The hypervolume's random directions are drawn apart from their use
(``draw_directions`` and ``cum_hypervolume_origin``), so a caller can feed
the same directions to both packages.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def dominates(a: Tensor, b: Tensor) -> Tensor:
    """True where point a dominates b (a >= b everywhere, > somewhere)."""
    return torch.all(a >= b, dim=-1) & torch.any(a > b, dim=-1)


def domination_matrix(points: Tensor) -> Tensor:
    """[N, M] -> [N, N] bool: entry (i, j) = point i dominates point j."""
    return dominates(points[:, None, :], points[None, :, :])


def is_frontier(points: Tensor, *, valid_mask: Optional[Tensor] = None) -> Tensor:
    """[N, M] -> [N] bool: True where no valid point dominates this one."""
    dom = domination_matrix(points)
    if valid_mask is not None:
        dom = dom & valid_mask[:, None]
    frontier = ~torch.any(dom, dim=0)
    if valid_mask is not None:
        frontier = frontier & valid_mask
    return frontier


def pareto_rank(points: Tensor, *, valid_mask: Optional[Tensor] = None) -> Tensor:
    """[N, M] -> [N] int: the number of valid points dominating each point
    (0 = frontier); invalid points get N."""
    dom = domination_matrix(points)
    if valid_mask is not None:
        dom = dom & valid_mask[:, None]
    rank = torch.sum(dom, dim=0)
    if valid_mask is not None:
        rank = torch.where(valid_mask, rank, torch.full_like(rank, points.shape[0]))
    return rank


def nondomination_layers(points: Tensor, *, valid_mask: Optional[Tensor] = None) -> Tensor:
    """[N, M] -> [N] int: NSGA-II front index (0 = first front); invalid
    points get N.

    Peels one front per step. A point in front L is dominated by a chain of
    L points, one in each earlier front, so the largest Pareto rank + 1
    bounds the number of fronts: that one read of the device is the loop's
    only one.
    """
    n = points.shape[0]
    dom = domination_matrix(points)
    remaining = torch.ones(n, dtype=torch.bool, device=points.device)
    if valid_mask is not None:
        dom = dom & valid_mask[:, None] & valid_mask[None, :]
        remaining = valid_mask.clone()
    layers = torch.full((n,), n, dtype=torch.int64, device=points.device)
    if n == 0:
        return layers
    num_fronts = int(torch.max(torch.where(remaining, torch.sum(dom, dim=0), 0))) + 1
    for i in range(num_fronts):
        # Points not dominated by any remaining point form the next front.
        front = remaining & ~torch.any(dom & remaining[:, None], dim=0)
        layers = torch.where(front, i, layers)
        remaining = remaining & ~front
    return layers


def crowding_distance(
    points: Tensor, layers: Tensor, *, valid_mask: Optional[Tensor] = None
) -> Tensor:
    """[N, M] NSGA-II crowding distance within each nondomination layer:
    per objective, the gaps to the adjacent same-layer points in sorted
    order over the objective's span; −inf on invalid points."""
    n, m = points.shape
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=points.device)
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    edge = inf.reshape(1)
    no = torch.zeros(1, dtype=torch.bool, device=points.device)
    total = torch.zeros(n, dtype=points.dtype, device=points.device)
    for j in range(m):
        vals = points[:, j]
        order = torch.argsort(torch.where(valid_mask, vals, inf), stable=True)
        sorted_vals, sorted_layers = vals[order], layers[order]
        span = torch.clamp(
            torch.max(torch.where(valid_mask, vals, -inf))
            - torch.min(torch.where(valid_mask, vals, inf)), min=1e-12)
        gap = sorted_vals[1:] - sorted_vals[:-1]
        same = sorted_layers[1:] == sorted_layers[:-1]
        prev_gap, next_gap = torch.cat([edge, gap]), torch.cat([gap, edge])
        same_prev, same_next = torch.cat([no, same]), torch.cat([same, no])
        contrib = (torch.where(same_prev, prev_gap, inf) + torch.where(same_next, next_gap, inf)) / span
        total = total + torch.zeros_like(total).scatter(0, order, contrib)
    return torch.where(valid_mask, total, -inf)


def draw_directions(
    generator: torch.Generator, num_vectors: int, num_metrics: int
) -> Tensor:
    """[K, M] random positive unit directions (|normal|, normalized)."""
    v = torch.abs(torch.randn((num_vectors, num_metrics), generator=generator,
                              device=generator.device, dtype=torch.float32))
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def cum_hypervolume_origin(
    points: Tensor, directions: Tensor, *, valid_mask: Optional[Tensor] = None
) -> Tensor:
    """Cumulative random-scalarization hypervolume w.r.t. the origin.

    Approximates HV(points[:i+1]) for every prefix i along the [K, M]
    ``directions``: ``hv ≈ c_m · mean_k max_{i' ≤ i} min_j (points[i', j] /
    v[k, j])_+^m``. Points must be >= 0 (translate by the reference point
    first).
    """
    m = points.shape[-1]
    ratios = torch.amin(points[None, :, :] / directions[:, None, :], dim=-1)  # [K, N]
    ratios = torch.clamp(ratios, min=0.0)
    if valid_mask is not None:
        ratios = torch.where(valid_mask[None, :], ratios, torch.zeros_like(ratios))
    prefix = torch.cummax(ratios, dim=1).values
    # The volume of the positive orthant's part of the unit m-ball.
    c_m = math.pi ** (m / 2) / (2**m * math.gamma(m / 2 + 1))
    return c_m * torch.mean(prefix**m, dim=0)


def hypervolume(
    points: Tensor,
    origin: Optional[Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    num_vectors: int = 1000,
    valid_mask: Optional[Tensor] = None,
) -> Tensor:
    """Scalar HV estimate of the full set w.r.t. ``origin`` (default 0);
    the directions come from ``generator`` (default: seed 0 on the points'
    device)."""
    if origin is not None:
        points = points - origin[None, :]
    points = torch.clamp(points, min=0.0)
    if generator is None:
        generator = torch.Generator(device=points.device).manual_seed(0)
    directions = draw_directions(generator, num_vectors, points.shape[-1])
    return cum_hypervolume_origin(points, directions, valid_mask=valid_mask)[-1]
