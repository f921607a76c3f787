"""Device-mesh sharding: restarts and acquisition pools split over devices.

Counterpart of the JAX package's ``parallel/__init__.py`` on one host. Two
embarrassingly parallel axes of the GP-bandit suggest split across a
:class:`Mesh` of the host's devices (``mesh.local_devices``):

- **restarts** — the ARD optimizer's random restarts (:func:`train_gp_sharded`);
- **pools** — independent eagle pools of the acquisition sweep, each with
  its own generator (:func:`maximize_score_fn_sharded`), merged by one
  top-k over every pool's results.

The axis is split into one contiguous chunk per device and each chunk runs
on its device; launches from one thread are asynchronous across devices.
Results are gathered on ``mesh.devices[0]`` and selected as the JAX package
selects them. Models, optimizers and data are copied to a chunk's device
(:func:`replicate`; no copy when they are already there).

The JAX package splits one PRNG key into per-pool keys; the port takes one
generator per pool (:func:`pool_generators`), so a test can feed each pool
the JAX package's draws, and takes the restart inits as an argument
(``inits=``) for the same reason.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.optimizers import graphs as graphs_lib
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib

# Cross-study continuous batching: N same-bucket studies per device batch.
from vizier_tpu_torch.parallel.batch_executor import BatchExecutor
from vizier_tpu_torch.parallel.batch_executor import BatchSlotError
from vizier_tpu_torch.parallel.batch_executor import BucketKey

# The mesh execution plane of the batch executor (VIZIER_TORCH_MESH*).
from vizier_tpu_torch.parallel.mesh import DevicePlacement
from vizier_tpu_torch.parallel.mesh import MeshConfig
from vizier_tpu_torch.parallel.mesh import build_placements
from vizier_tpu_torch.parallel.mesh import local_devices
from vizier_tpu_torch.parallel.mesh import multihost_mesh

Tensor = torch.Tensor

DEVICE_AXIS = "devices"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: an ordered tuple of devices and the name of its axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DEVICE_AXIS

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def size(self) -> int:
        return len(self.devices)


def create_mesh(
    n_devices: Optional[int] = None, axis_name: str = DEVICE_AXIS, device: Any = "cuda"
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` (default: all) of the host's
    devices of ``device``'s type."""
    devices = local_devices(device)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"Requested {n_devices} devices but only {len(devices)} exist.")
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis_name)


def replicate(tree: Any, device: Optional[torch.device]) -> Any:
    """``tree`` with every tensor on ``device`` and every dataclass that holds
    a ``device`` field (models, optimizers) rebuilt for it; the same objects
    where nothing moves, and ``tree`` itself when ``device`` is None."""
    if device is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.device):
        return device if tree != device else tree
    if isinstance(tree, dict):
        out = {k: replicate(v, device) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = [replicate(x, device) for x in tree]
        return tree if all(a is b for a, b in zip(out, tree)) else type(tree)(*out)
    if isinstance(tree, (list, tuple)):
        out = [replicate(x, device) for x in tree]
        return tree if all(a is b for a, b in zip(out, tree)) else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {}
        for f in dataclasses.fields(tree):
            if not f.init:
                continue
            old = getattr(tree, f.name)
            new = replicate(old, device)
            if new is not old:
                changes[f.name] = new
        return dataclasses.replace(tree, **changes) if changes else tree
    return tree


def replicated(mesh: Mesh) -> Callable[[Any], List[Any]]:
    """A placer that copies a tree onto every device of ``mesh``."""
    return lambda tree: [replicate(tree, d) for d in mesh.devices]


def batch_sharded(mesh: Mesh) -> Callable[[Any], List[Any]]:
    """A placer that splits a tree's leading axis into ``mesh.size`` equal
    chunks, chunk k on device k."""
    return DevicePlacement(0, mesh.devices).shard


def _spans(rows: int, mesh: Mesh) -> List[Tuple[torch.device, int, int]]:
    """Contiguous (device, start, stop) chunks of ``rows`` rows, one per
    device, as even as the count allows (equal when ``rows`` divides)."""
    bounds = np.linspace(0, rows, mesh.size + 1).round().astype(int)
    return [(d, int(lo), int(hi)) for d, lo, hi in zip(mesh.devices, bounds[:-1], bounds[1:])
            if hi > lo]


def pool_generators(
    source: Union[int, np.integer, torch.Generator], num_pools: int, mesh: Mesh
) -> List[torch.Generator]:
    """One generator per pool, each on the device its pool runs on, seeded
    from ``source``: a seed, or a generator that draws the pools' seeds."""
    if isinstance(source, torch.Generator):
        seeds = torch.randint(0, 2**62, (num_pools,), generator=source,
                              device=source.device).tolist()
    else:
        seeds = np.random.default_rng(int(source)).integers(0, 2**62, num_pools).tolist()
    out: List[torch.Generator] = []
    for device, lo, hi in _spans(num_pools, mesh):
        out += [torch.Generator(device=device).manual_seed(int(s)) for s in seeds[lo:hi]]
    return out


# ---------------------------------------------------------------------------
# Sharded ARD training: restarts across devices.
# ---------------------------------------------------------------------------


def train_gp_sharded(
    model: Any,
    optimizer: lbfgs_lib.Optimizer,
    data: Any,
    generator: Optional[torch.Generator],
    num_restarts: int,
    ensemble_size: int,
    mesh: Mesh,
    warm_start: Optional[gp_lib.Params] = None,
    *,
    inits: Optional[gp_lib.Params] = None,
):
    """Multi-restart ARD with the restart axis split over the mesh.

    ``num_restarts`` should be a multiple of the mesh size. The restarts are
    ``inits`` when given, else drawn from ``generator``; ``warm_start``
    *replaces* restart 0, as in the JAX package (the sequential train
    prepends it as one more row). Each device optimizes its chunk; the final
    params and losses are gathered on ``mesh.devices[0]``, where the best
    ``ensemble_size`` are selected exactly as one unsharded optimizer call
    selects them, and their posteriors precomputed. ``model`` is any model
    with ``param_collection`` / ``neg_log_likelihood`` / ``precompute``
    (the exact GP or the multi-task GP).
    """
    home = mesh.devices[0]
    if inits is None:
        inits = model.param_collection().batch_random_init_unconstrained(generator, num_restarts)
    inits = replicate(inits, home)
    if warm_start is not None:
        inits = {k: torch.cat([warm_start[k].to(v)[None], v[1:]]) for k, v in inits.items()}
    finals: List[gp_lib.Params] = []
    losses: List[Tensor] = []
    for device, lo, hi in _spans(next(iter(inits.values())).shape[0], mesh):
        chunk = {k: v[lo:hi].to(device) for k, v in inits.items()}
        m, opt, d = replicate((model, optimizer, data), device)
        result = opt(graphs_lib.BoundLoss(m.neg_log_likelihood, d), chunk, best_n=hi - lo)
        # The chunk's rows back in restart order (the result holds them best
        # first, by the stable sort the selection below repeats).
        sane = torch.where(torch.isfinite(result.losses), result.losses,
                           torch.full_like(result.losses, float("inf")))
        unsort = torch.argsort(torch.sort(sane, stable=True).indices)
        finals.append({k: v[unsort].to(home) for k, v in result.params.items()})
        losses.append(result.losses.to(home))
    gathered = {k: torch.cat([f[k] for f in finals]) for k in finals[0]}
    best = lbfgs_lib._select_best(gathered, torch.cat(losses), ensemble_size)
    model, data = replicate((model, data), home)
    return model.precompute(best.params, data)


# ---------------------------------------------------------------------------
# Sharded acquisition sweep: independent eagle pools per device.
# ---------------------------------------------------------------------------


def maximize_score_fn_sharded(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    score_fn: Optional[Callable[[kernels.MixedFeatures], Tensor]],
    generators: Sequence[torch.Generator],
    count: int,
    num_pools: int,
    mesh: Mesh,
    prior_features: Optional[kernels.MixedFeatures] = None,
    *,
    score_on: Optional[Callable[[torch.device], Callable]] = None,
) -> vectorized_lib.VectorizedOptimizerResult:
    """``num_pools`` independent sweeps, the pools split over the mesh.

    Pool i runs ``vec_opt``'s whole ``max_evaluations`` with
    ``generators[i]`` (on the device of its chunk, :func:`pool_generators`);
    a device's pools ride one ``run_studies`` loop as its study axis.
    ``score_fn`` maps [Q, ...] candidates to [Q] scores; ``score_on(device)``,
    when given, builds the score function for a device's pools instead (its
    state replicated there). The merge is one top-k over the
    ``num_pools × count`` results (ties to the earlier pool, as the JAX
    package's ``top_k``), on ``mesh.devices[0]``. Returns [count] results.
    """
    if len(generators) != num_pools:
        raise ValueError(f"{num_pools} pools need {num_pools} generators, got {len(generators)}.")
    home = mesh.devices[0]
    parts = []
    for device, lo, hi in _spans(num_pools, mesh):
        score = score_on(device) if score_on is not None else score_fn
        pools = hi - lo

        def pooled(q: kernels.MixedFeatures, score=score) -> Tensor:
            s, p = q.continuous.shape[:2]
            flat = kernels.MixedFeatures(q.continuous.flatten(0, 1), q.categorical.flatten(0, 1))
            return score(flat).reshape(s, p)

        prior = None
        if prior_features is not None:
            prior = kernels.MixedFeatures(*(
                t.to(device)[None].expand((pools,) + tuple(t.shape)) for t in prior_features))
        parts.append(replicate(vec_opt, device).run_studies(
            pooled, generators[lo:hi], count=count, prior_features=prior))
    cont = torch.cat([r.features.continuous.to(home) for r in parts])  # [pools, count, Dc]
    cat = torch.cat([r.features.categorical.to(home) for r in parts])
    scores = torch.cat([r.scores.to(home) for r in parts])
    flat = num_pools * count  # explicit: -1 breaks on zero-width categoricals
    top = torch.sort(scores.reshape(flat), descending=True, stable=True).indices[:count]
    return vectorized_lib.VectorizedOptimizerResult(
        kernels.MixedFeatures(
            cont.reshape((flat,) + cont.shape[2:])[top], cat.reshape((flat,) + cat.shape[2:])[top]),
        scores.reshape(flat)[top],
    )


def maximize_acquisition_sharded(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    scoring: acquisitions.ScoringFunction,
    generators: Sequence[torch.Generator],
    count: int,
    num_pools: int,
    mesh: Mesh,
    prior_features: Optional[kernels.MixedFeatures] = None,
) -> vectorized_lib.VectorizedOptimizerResult:
    """Pool-sharded sweep of a ``ScoringFunction``, replicated on each device."""
    return maximize_score_fn_sharded(
        vec_opt, None, generators, count, num_pools, mesh, prior_features,
        score_on=lambda device: replicate(scoring, device).score,
    )


# ---------------------------------------------------------------------------
# One multi-device suggest step (ARD train + acquisition sweep).
# ---------------------------------------------------------------------------


def suggest_step_sharded(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.Optimizer,
    vec_opt: vectorized_lib.VectorizedOptimizer,
    data: gp_lib.GPData,
    seed: int,
    *,
    count: int,
    num_restarts: int,
    ensemble_size: int,
    mesh: Mesh,
    ucb_coefficient: float = 1.8,
    inits: Optional[gp_lib.Params] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
) -> vectorized_lib.VectorizedOptimizerResult:
    """The GP-bandit compute step over the mesh: train → UCB → sweep, one
    pool per device. ``seed`` seeds the train's restarts and the pools'
    generators (``inits`` and ``generators`` stand in for them)."""
    train_seed, acq_seed = np.random.default_rng(seed).integers(0, 2**62, 2)
    generator = torch.Generator(device=mesh.devices[0]).manual_seed(int(train_seed))
    states = train_gp_sharded(
        model, optimizer, data, generator, num_restarts, ensemble_size, mesh, inits=inits)
    data = replicate(data, mesh.devices[0])
    scoring = acquisitions.ScoringFunction(
        predictive=gp_lib.EnsemblePredictive(states),
        acquisition=acquisitions.UCB(ucb_coefficient),
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
        trust_region=acquisitions.TrustRegion.from_data(data),
    )
    if generators is None:
        generators = pool_generators(acq_seed, mesh.size, mesh)
    return maximize_acquisition_sharded(vec_opt, scoring, generators, count, mesh.size, mesh)
