"""VizierGPUCBPEBandit: the DEFAULT algorithm (GP-UCB with Pure Exploration).

Counterpart of the JAX package's ``designers/gp_ucb_pe.py:858``: exact GP,
sparse surrogate (single objective) and multi-objective studies (algorithm
from Contal et al., "Parallel Gaussian Process Optimization with UCB and
Pure Exploration"):

- Two conditioned posteriors: ``completed`` (observed labels) and ``all``
  (completed + pending/active + already-picked batch points; only the
  stddev matters, and GP posterior stddev is label-free).
- **UCB score** = mean(completed) + c·stddev(all): pending points deflate
  the stddev so concurrent workers do not duplicate suggestions.
- **PE score** = stddev(all) + penalty·min(explore_ucb − threshold, 0) where
  the threshold is the completed-posterior mean at the argmax-UCB point
  over observed+pending features.
- **UCB/PE choice** per pick: fresh completed trials → UCB except w.p.
  ``pe_overwrite_probability`` (raised in the high-noise regime);
  otherwise PE except w.p. ``ucb_overwrite_probability``.
- **Multimetric**: one GP per objective, each over its own warped labels
  and row mask (or, with a SEPARABLE ``multitask_type``, one multi-task GP
  with a learned task covariance); UCB hypervolume-scalarized along random
  directions (floored at the observed labels' scalarization), the PE
  penalty scalarized by union / intersection / average across metrics.
- **Set acquisition** (``optimize_set_acquisition_for_exploration``, one
  objective): after the UCB pick of fresh data, the exploration picks are
  searched jointly as one set, scored by the log-determinant of their joint
  all-points covariance (``_suggest_set_pe``).
- **prior_acquisition**: a user callable over the candidates, added to every
  pick's score (summed over the set in set-PE).

Picks are written into spare padded rows, and each pick re-conditions the
all-points posterior (one batched Cholesky over the ensemble) before its
eagle sweep. The single-objective suggest (exact or sparse) is a compute-IR
program (``UCBPEProgram``, ``UCBPESparseProgram``): the batch executor runs a
bucket's studies as one batch over a leading study axis, and the sequential
``suggest`` runs the same program on its study alone, with the phase seeds
(train, acquisition, and the two-phase budget's second sweep) drawn from
the study's seed stream in the same order. Above the ``surrogate`` config's trial threshold the posteriors
are the sparse inducing-point ones (``surrogates.sparse_gp``): each pick
re-conditions in O(n·m²) through the trained inducing set, and a pick far
from it joins it (``_append_row_sparse``).

On a mesh (``use_mesh``, as the GP bandit's) each metric's ARD train and the
multi-task train split their restarts over the devices
(``parallel.train_gp_sharded``: restarts rounded up to the mesh, the warm
seed replacing restart 0), and every pick's sweep runs one independent pool
per device, merged by one top-k (``parallel.maximize_score_fn_sharded``). A
mesh designer stays exact and takes no batched program, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vizier_tpu_torch import parallel
from vizier_tpu_torch import types
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.compute import ir as compute_ir
from vizier_tpu_torch.compute import registry as compute_registry
from vizier_tpu_torch.designers import gp_bandit
from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.models import multitask_gp
from vizier_tpu_torch.models import output_warpers
from vizier_tpu_torch.observability import device_timing
from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.optimizers import eagle as eagle_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.surrogates import config as surrogate_config_lib
from vizier_tpu_torch.surrogates import sparse_bandit
from vizier_tpu_torch.surrogates import sparse_gp
from vizier_tpu_torch.utils import profiler

Tensor = torch.Tensor

MultiTaskType = multitask_gp.MultiTaskType

_PE_NOISE_STDDEV = 1e-5  # noise floor for the all-predictive in high noise
_MIN_PICK_EVALUATIONS = 500  # ≥10 eagle generations at the default pool of 50


@dataclasses.dataclass(frozen=True)
class UCBPEConfig:
    """UCB-PE config (reference ``UCBPEConfig``)."""

    ucb_coefficient: float = 1.8
    # A separate (smaller) coefficient defining the region worth exploring.
    explore_region_ucb_coefficient: float = 0.5
    # Slope of the linear penalty for violating UCB(x) >= threshold.
    cb_violation_penalty_coefficient: float = 10.0
    # P(UCB) when there are NO new completed trials.
    ucb_overwrite_probability: float = 0.25
    # P(PE) when there ARE new completed trials.
    pe_overwrite_probability: float = 0.1
    # Same, in the detected-high-noise regime.
    pe_overwrite_probability_in_high_noise: float = 0.7
    # signal/noise variance ratio below which noise is considered high
    # (0 disables the high-noise behaviors).
    signal_to_noise_threshold: float = 0.7
    # Search the exploration picks jointly, by the log-determinant of their
    # joint covariance (single objective only).
    optimize_set_acquisition_for_exploration: bool = False
    # Multimetric promising-region penalty: union | intersection | average.
    multimetric_promising_region_penalty_type: str = "average"
    # Random HV-scalarization directions for multimetric UCB, drawn per pick.
    num_scalarizations: int = 1000
    # Multimetric GP structure: INDEPENDENT trains one GP per metric; the
    # SEPARABLE* variants train one GP with a learned task covariance B over
    # a B ⊗ Kx Gram (``models.multitask_gp``).
    multitask_type: MultiTaskType = MultiTaskType.INDEPENDENT

    def __post_init__(self):
        if self.multimetric_promising_region_penalty_type not in (
            "union", "intersection", "average",
        ):
            raise ValueError(
                "multimetric_promising_region_penalty_type must be one of "
                "'union' | 'intersection' | 'average', got "
                f"{self.multimetric_promising_region_penalty_type!r}."
            )
        if not isinstance(self.multitask_type, MultiTaskType):
            raise ValueError(f"multitask_type must be a MultiTaskType, got {self.multitask_type!r}.")


def _mixture_predict(states, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
    """Per metric, the moment-matched mixture over its ensemble axis.

    ``states``: one state per metric (``GPState`` or ``SparseGPState``, each
    over its own data), or a ``MultiTaskGPState``. Returns ([M, Q] mean,
    [M, Q] stddev).
    """
    if isinstance(states, multitask_gp.MultiTaskGPState):
        return _mt_mixture_predict(states, query)
    pairs = [gp_lib.EnsemblePredictive(s).predict(query) for s in states]
    if len(pairs) == 1:  # views: one metric adds no launch
        return pairs[0][0][None], pairs[0][1][None]
    return torch.stack([m for m, _ in pairs]), torch.stack([s for _, s in pairs])


def _mt_mixture_predict(
    states: multitask_gp.MultiTaskGPState, query: kernels.MixedFeatures
) -> Tuple[Tensor, Tensor]:
    """The moment-matched mixture over a multi-task state's ensemble axis:
    ([M, Q] mean, [M, Q] stddev), as :func:`_mixture_predict`."""
    return gp_lib.EnsemblePredictive(states).predict(query)


class _MetricZeroMTPredictive:
    """``.predict`` over the first metric of a multi-task state: the
    single-metric predictive contract of ``EnsemblePredictive``."""

    def __init__(self, states: multitask_gp.MultiTaskGPState):
        self._states = states

    def predict(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        mean, std = _mt_mixture_predict(self._states, query)
        return mean[0], std[0]


def _pe_conditioning(states_completed, all_data: gp_lib.GPData, config: UCBPEConfig):
    """(pe_params, noise_is_high, threshold [M]): shared UCB-PE conditioning.

    ``states_completed`` is a list of per-metric states or a
    ``MultiTaskGPState``; ``all_data`` the all-points rows (features only).

    - High-noise detection: every metric's and ensemble member's
      signal/noise variance ratio below the config threshold → the
      all-points predictive gets a near-zero noise floor so pending points
      fully deflate the local stddev. The multi-task signal variance of task
      m is amp²·B[m, m].
    - Promising-region threshold, per metric: the completed-posterior mean
      at the argmax-UCB point among observed + pending features.

    ``pe_params`` is a list of per-metric parameter dicts, or one dict for a
    multi-task state.
    """
    is_mt = isinstance(states_completed, multitask_gp.MultiTaskGPState)
    if is_mt:
        p = states_completed.params
        b_diag = torch.diagonal(states_completed.model._task_cov(p), dim1=-2, dim2=-1)
        snr = [(p["amplitude"][:, None] ** 2) * b_diag / (p["noise_stddev"][:, None] ** 2)]
        param_sets = [p]
    else:
        param_sets = [s.params for s in states_completed]
        snr = [(p["amplitude"] / p["noise_stddev"]) ** 2 for p in param_sets]
    thr = config.signal_to_noise_threshold
    noise_is_high = functools.reduce(operator.and_, [torch.all(r < thr) for r in snr]) & (thr > 0.0)
    pe_params = [
        dict(p, noise_stddev=torch.where(
            noise_is_high, torch.full_like(p["noise_stddev"], _PE_NOISE_STDDEV), p["noise_stddev"]))
        for p in param_sets
    ]
    mean_at, std_at = _mixture_predict(states_completed, all_data.features())  # [M, N]
    ucb_at = torch.where(
        all_data.row_mask,
        mean_at + config.ucb_coefficient * std_at,
        torch.full_like(mean_at, float("-inf")),
    )
    threshold = torch.gather(mean_at, 1, torch.argmax(ucb_at, dim=-1, keepdim=True))[:, 0]
    return (pe_params[0] if is_mt else pe_params), noise_is_high, threshold


def _append_row(data: gp_lib.GPData, x: kernels.MixedFeatures) -> gp_lib.GPData:
    """Writes x into the first free padded row (labels stay 0: stddev-only).

    A flush's stacked data takes each study's pick (``x`` [S, 1, ...]) into
    that study's first free row.
    """
    idx = torch.sum(data.row_mask.to(torch.int64), dim=-1, keepdim=True)  # first free slot
    at = torch.arange(data.num_rows, device=idx.device) == idx
    return dataclasses.replace(
        data,
        continuous=torch.where(at[..., None], x.continuous[..., :1, :], data.continuous),
        categorical=torch.where(at[..., None], x.categorical[..., :1, :], data.categorical),
        row_mask=data.row_mask | at,
    )


def _append_row_mt(
    data: multitask_gp.MultiTaskData, x: kernels.MixedFeatures
) -> multitask_gp.MultiTaskData:
    """Multi-task pending-point append: every task observes the new row."""
    fd = data.features_data
    at = torch.arange(fd.num_rows, device=fd.device) == torch.sum(fd.row_mask.to(torch.int64))
    return multitask_gp.MultiTaskData(
        features_data=_append_row(fd, x),
        task_labels=data.task_labels,
        task_mask=data.task_mask | at[None, :],
    )


# A pick whose Nyström residual k** − ‖L⁻¹k(Z,x)‖² exceeds this fraction of
# the prior variance is "not near an inducing row": conditioning through the
# base inducing set would barely deflate the stddev there, and PE would pick
# the same point again. Such picks join the inducing set.
_NYSTROM_RESIDUAL_FRACTION = 0.1


def _append_row_sparse(
    sdata: sparse_gp.SparseGPData, x: kernels.MixedFeatures, ref_state: sparse_gp.SparseGPState
) -> sparse_gp.SparseGPData:
    """Sparse pending-pick conditioning: append + conditional Nyström augment.

    The pick always joins the all-points data rows. When its Nyström residual
    under ``ref_state`` (the trained completed posterior's member 0, a batch
    of one) exceeds ``_NYSTROM_RESIDUAL_FRACTION`` of amp², it is also written
    into the next spare inducing slot (``sparse_gp.with_pending_capacity``).
    A flush's stacked data takes each study's pick [S, 1, ...] against its
    own member 0 (``ref_state`` one member per study). No value is read
    back to the host.
    """
    data = _append_row(sdata.data, x)
    ref = ref_state.sdata
    kz = ref_state.model.base._kernel(
        ref_state.params, x, ref.z_features(), ref.data, row_mask2=ref.inducing_mask
    )  # [S, 1, m]
    t1 = gp_lib.matvec(ref_state.linv, kz[:, 0])  # [S, m]
    amp2 = ref_state.params["amplitude"] * ref_state.params["amplitude"]
    augment = amp2 - torch.sum(t1 * t1, dim=-1) > _NYSTROM_RESIDUAL_FRACTION * amp2
    # The mask is a true prefix (k-center fills one, augments extend it), so
    # the next free slot is the current true count.
    mask = sdata.inducing_mask
    augment = augment[:, None] if mask.dim() == 2 else augment[0]
    m = mask.shape[-1]
    idx = torch.clamp(torch.sum(mask.to(torch.int64), dim=-1, keepdim=True), max=m - 1)
    at = torch.arange(m, device=mask.device) == idx
    write = at & augment & ~mask
    return sparse_gp.SparseGPData(
        data=data,
        z_continuous=torch.where(
            write[..., None], x.continuous[..., :1, :], sdata.z_continuous),
        z_categorical=torch.where(
            write[..., None], x.categorical[..., :1, :], sdata.z_categorical),
        inducing_mask=mask | write,
        inducing_indices=sdata.inducing_indices,
    )


def _pick_appender(all_data):
    """How a multi-objective pick joins the pending rows: ``_append_row_mt``
    for a multi-task ``all_data``, else ``_append_row``."""
    return _append_row_mt if isinstance(all_data, multitask_gp.MultiTaskData) else _append_row


def _hv_floor(inv_w: Tensor, ref_point: Tensor, labels: Tensor, labels_mask: Tensor) -> Tensor:
    """[K] floor of each direction's scalarization: the best scalarized
    observed label, min_m(inv_w·(label − ref)_+)^M over the valid rows.

    ``inv_w`` [K, M] are the inverse directions, ``labels`` [M, N] the
    completed warped labels. It depends on the pick's directions and the
    labels only, so it is computed once per pick, not per score call.
    """
    lab_shifted = torch.clamp(labels - ref_point[:, None], min=0.0)  # [M, N]
    per_dir = torch.amin(inv_w[:, :, None] * lab_shifted[None, :, :], dim=1) ** labels.shape[0]
    return torch.amax(
        torch.where(labels_mask[None, :], per_dir, torch.full_like(per_dir, float("-inf"))), dim=-1
    )


def _hv_scalarized(values: Tensor, inv_w: Tensor, ref_point: Tensor, floor: Tensor) -> Tensor:
    """Random-direction hypervolume scalarization, floored at the labels.

    Reference ``create_hv_scalarization`` (https://arxiv.org/abs/2006.04655):
    per direction min_m((v_m − ref_m)_+ / w_m)^M of the [M, Q] per-metric
    ``values``, floored at :func:`_hv_floor`'s [K] values, then averaged
    over the directions. Returns [Q].
    """
    shifted = torch.clamp(values - ref_point[:, None], min=0.0)  # [M, Q]
    per_dir = torch.amin(inv_w[:, :, None] * shifted[None, :, :], dim=1) ** values.shape[0]
    return torch.mean(torch.maximum(per_dir, floor[:, None]), dim=0)


def _scalarize_penalty(penalty: Tensor, mode: str) -> Tensor:
    """[M, Q] per-metric promising-region penalties → [Q]."""
    if mode == "union":
        return torch.amax(penalty, dim=0)
    if mode == "intersection":
        return torch.amin(penalty, dim=0)
    return torch.mean(penalty, dim=0)


# A user's additive score over [Q] candidates: [Q, ...] features -> [Q].
PriorAcquisition = Callable[[kernels.MixedFeatures], Tensor]


def _prior_scores(prior_acquisition: PriorAcquisition, query: kernels.MixedFeatures) -> Tensor:
    """The prior over queries [..., Q, ...], called once on the flattened
    rows and given back the queries' leading shape."""
    flat = kernels.MixedFeatures(*(t.flatten(0, -2) for t in query))
    return prior_acquisition(flat).reshape(query.continuous.shape[:-1])


def _score_fn(
    states_completed,
    states_all,
    config: UCBPEConfig,
    use_ucb: Tensor,
    threshold: Tensor,
    hv: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
    trust: Optional[acquisitions.TrustRegion] = None,
    prior_acquisition: Optional[PriorAcquisition] = None,
):
    """One pick's acquisition over [Q] queries: UCB, or PE penalized outside
    the promising region, plus the user's prior, less the trust-region
    penalty.

    With one metric, UCB = mean(completed) + c·stddev(all) and PE =
    stddev(all) + penalty. With M > 1 (``hv`` = (inverse directions [K, M],
    reference point [M], floor [K])), UCB is HV-scalarized over the metrics
    and PE is the mean stddev plus the scalarized penalty.
    """

    def score(query: kernels.MixedFeatures) -> Tensor:
        mean_c, std_c = _mixture_predict(states_completed, query)  # [M, Q]
        _, std_all = _mixture_predict(states_all, query)  # [M, Q]
        ucb_vals = mean_c + config.ucb_coefficient * std_all
        explore_ucb = mean_c + config.explore_region_ucb_coefficient * std_c
        penalty = config.cb_violation_penalty_coefficient * torch.clamp(
            explore_ucb - threshold[:, None], max=0.0
        )
        if hv is None:
            ucb_score, pe_score = ucb_vals[0], std_all[0] + penalty[0]
        else:
            ucb_score = _hv_scalarized(ucb_vals, *hv)
            pe_score = torch.mean(std_all, dim=0) + _scalarize_penalty(
                penalty, config.multimetric_promising_region_penalty_type
            )
        value = torch.where(use_ucb, ucb_score, pe_score)
        if prior_acquisition is not None:
            value = value + prior_acquisition(query)
        if trust is not None:
            value = value - trust.penalty(query)
        return value

    return score


def _suggest_batch(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    states_completed,
    all_data,
    prior_features: kernels.MixedFeatures,
    generator: torch.Generator,
    first_has_new: bool,
    has_completed: bool,
    count: int,
    config: UCBPEConfig,
    use_trust_region: bool = True,
    *,
    labels_mn: Optional[Tensor] = None,
    labels_mask: Optional[Tensor] = None,
    ref_point: Optional[Tensor] = None,
    prior_acquisition: Optional[PriorAcquisition] = None,
    mesh: Optional[parallel.Mesh] = None,
) -> Tuple[vectorized_lib.VectorizedOptimizerResult, dict]:
    """The greedy multi-objective batch: per pick, UCB-or-PE with
    pending-point conditioning. (A single-objective suggest runs
    :func:`_suggest_batch_studies`, over a study axis of one when alone.)

    ``states_completed`` is a list of per-metric ``GPState``s over a
    ``GPData``, or a ``MultiTaskGPState`` over a ``MultiTaskData``. With
    M > 1 metrics the pick draws ``config.num_scalarizations`` directions
    for the HV scalarization over ``labels_mn`` [M, N1] (valid where
    ``labels_mask`` [N1]) from ``ref_point`` [M]. With a ``mesh`` each
    pick's sweep runs one pool per device (:func:`_sweep_one_study`).
    """
    is_mt = isinstance(states_completed, multitask_gp.MultiTaskGPState)
    if is_mt:
        model = states_completed.model
        num_metrics = model.num_tasks
        base_data = lambda d: d.features_data  # noqa: E731
        recondition = model.precompute_constrained
    else:
        model = states_completed[0].model
        num_metrics = len(states_completed)
        base_data = lambda d: d  # noqa: E731
        recondition = lambda ps, d: [model.precompute_constrained(p, d) for p in ps]  # noqa: E731
    append = _pick_appender(all_data)
    trust = acquisitions.TrustRegion.from_data(base_data(all_data)) if use_trust_region else None
    picks, scores = [], []
    aux: Dict[str, list] = {"mean": [], "stddev": [], "stddev_from_all": [], "use_ucb": []}
    for b in range(count):
        # Shared conditioning, recomputed on the grown pending set.
        pe_params, noise_is_high, threshold = _pe_conditioning(
            states_completed, base_data(all_data), config
        )
        states_all = recondition(pe_params, all_data)

        # Pick-level UCB/PE decision (reference `_suggest_one` logic).
        u = torch.rand((), generator=generator, device=generator.device)
        if b == 0 and first_has_new:
            pe_p = torch.where(
                noise_is_high,
                torch.tensor(config.pe_overwrite_probability_in_high_noise, device=u.device),
                torch.tensor(config.pe_overwrite_probability, device=u.device),
            )
            use_ucb = ~(u < pe_p)
        else:
            use_ucb = (u < config.ucb_overwrite_probability) & has_completed

        hv = None
        if num_metrics > 1:
            weights = pareto_ops.draw_directions(generator, config.num_scalarizations, num_metrics)
            inv_w = 1.0 / torch.clamp(weights, min=1e-6)
            hv = (inv_w, ref_point, _hv_floor(inv_w, ref_point, labels_mn, labels_mask))
        def score_on(device, args=(states_completed, states_all, use_ucb, threshold, hv, trust)):
            sc, sa, u, thr, h, tr = parallel.replicate(args, device)
            return _score_fn(sc, sa, config, u, thr, h, tr, prior_acquisition)

        result = _sweep_one_study(vec_opt, score_on, generator, prior_features, mesh)
        x = kernels.MixedFeatures(
            result.features.continuous[:1], result.features.categorical[:1]
        )
        mean_x, std_x = _mixture_predict(states_completed, x)  # [M, 1]
        _, std_all_x = _mixture_predict(states_all, x)
        all_data = append(all_data, x)
        picks.append(x)
        scores.append(result.scores[:1])
        aux["mean"].append(mean_x[:, 0])
        aux["stddev"].append(std_x[:, 0])
        aux["stddev_from_all"].append(std_all_x[:, 0])
        aux["use_ucb"].append(use_ucb.reshape(1))
    out = {k: torch.stack(v) for k, v in aux.items() if k != "use_ucb"}  # [count, M]
    out["use_ucb"] = torch.cat(aux["use_ucb"])
    out["trust_radius"] = (
        trust.trust_radius() if trust is not None else torch.tensor(float("inf"))
    )
    features = kernels.MixedFeatures(
        torch.cat([p.continuous for p in picks]), torch.cat([p.categorical for p in picks])
    )
    return vectorized_lib.VectorizedOptimizerResult(features, torch.cat(scores)), out


def _sweep_one_study(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    score_on: Callable[[torch.device], Callable[[kernels.MixedFeatures], Tensor]],
    generator: torch.Generator,
    prior_features: Optional[kernels.MixedFeatures],
    mesh: Optional[parallel.Mesh],
) -> vectorized_lib.VectorizedOptimizerResult:
    """One pick's sweep of one study ([1] results): one pool with
    ``generator``, or on a ``mesh`` one pool per device, their generators
    drawn from ``generator``. ``score_on(device)`` is the [Q] score function
    with its state on ``device`` (as it is, for None)."""
    if mesh is None:
        return vec_opt(score_on(None), generator, count=1, prior_features=prior_features)
    return parallel.maximize_score_fn_sharded(
        vec_opt, None, parallel.pool_generators(generator, mesh.size, mesh), 1, mesh.size,
        mesh, prior_features, score_on=score_on,
    )


def _pe_conditioning_studies(states, all_data: gp_lib.GPData, config: UCBPEConfig, studies: int):
    """:func:`_pe_conditioning` of one metric for each study of a flush:
    ([S × E] pe_params, [S] noise_is_high, [S] threshold). ``states`` holds
    S studies' E members each (exact or sparse); ``all_data`` is stacked."""
    p = states.params
    snr = (p["amplitude"] / p["noise_stddev"]) ** 2
    thr = config.signal_to_noise_threshold
    noise_is_high = torch.all((snr < thr).reshape(studies, -1), dim=1) & (thr > 0.0)
    member_high = torch.repeat_interleave(noise_is_high, snr.shape[0] // studies)
    pe_params = dict(p, noise_stddev=torch.where(
        member_high, torch.full_like(p["noise_stddev"], _PE_NOISE_STDDEV), p["noise_stddev"]))
    mean_at, std_at = gp_lib.EnsemblePredictive(states, studies=studies).predict(
        all_data.features())  # [S, N]
    ucb_at = torch.where(
        all_data.row_mask,
        mean_at + config.ucb_coefficient * std_at,
        torch.full_like(mean_at, float("-inf")),
    )
    threshold = torch.gather(mean_at, 1, torch.argmax(ucb_at, dim=-1, keepdim=True))[:, 0]
    return pe_params, noise_is_high, threshold


def _score_fn_studies(
    states_completed, states_all, config: UCBPEConfig, use_ucb: Tensor, threshold: Tensor,
    trust: Optional[acquisitions.TrustRegion], studies: int,
    prior_acquisition: Optional[PriorAcquisition] = None,
):
    """One pick's single-metric acquisition for each study of a flush:
    [S, Q] scores of [S, Q, ...] queries, as :func:`_score_fn` per study."""

    def score(query: kernels.MixedFeatures) -> Tensor:
        mean_c, std_c = gp_lib.EnsemblePredictive(states_completed, studies=studies).predict(query)
        _, std_all = gp_lib.EnsemblePredictive(states_all, studies=studies).predict(query)
        ucb_score = mean_c + config.ucb_coefficient * std_all
        explore_ucb = mean_c + config.explore_region_ucb_coefficient * std_c
        penalty = config.cb_violation_penalty_coefficient * torch.clamp(
            explore_ucb - threshold[:, None], max=0.0
        )
        value = torch.where(use_ucb[:, None], ucb_score, std_all + penalty)
        if prior_acquisition is not None:
            value = value + _prior_scores(prior_acquisition, query)
        if trust is not None:
            value = value - trust.penalty(query)
        return value

    return score


def _suggest_batch_studies(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    states_completed,
    all_data,
    prior_features: kernels.MixedFeatures,
    generators,
    first_has_new: Tensor,
    has_completed: Tensor,
    count: int,
    config: UCBPEConfig,
    use_trust_region: bool = True,
    model=None,
    prior_acquisition: Optional[PriorAcquisition] = None,
    mesh: Optional[parallel.Mesh] = None,
) -> Tuple[vectorized_lib.VectorizedOptimizerResult, dict]:
    """The greedy single-objective batch of S studies at once: the study axis
    of :func:`_suggest_batch` (the JAX package's ``_sweep_batched``).

    ``states_completed`` holds S studies' E members (``GPState`` over the
    stacked completed data, or ``SparseGPState`` with ``all_data`` the
    stacked ``SparseGPData`` and ``model`` the re-conditioning model);
    ``generators`` one per study; ``first_has_new`` and ``has_completed``
    are [S] bool. Each pick draws each study's UCB/PE coin from its own
    generator, re-conditions every study's all-points posterior in one
    batch, sweeps all studies in one loop and appends each study's pick.
    Returns [S, count, ...] picks and per-pick aux ([S, count, 1]). With a
    ``mesh`` (one study, a mesh designer's) each pick's sweep runs one pool
    per device (:func:`_sweep_one_study`).
    """
    studies = len(generators)
    model = states_completed.model if model is None else model
    sparse = isinstance(all_data, sparse_gp.SparseGPData)
    base = all_data.data if sparse else all_data
    ref = states_completed.first_members() if sparse else None
    trust = acquisitions.TrustRegion.from_data(base) if use_trust_region else None
    device = first_has_new.device
    pe_prob = torch.tensor(config.pe_overwrite_probability, device=device)
    pe_prob_high = torch.tensor(config.pe_overwrite_probability_in_high_noise, device=device)
    mixture = lambda st, q: gp_lib.EnsemblePredictive(st, studies=studies).predict(q)  # noqa: E731
    picks, scores = [], []
    aux: Dict[str, list] = {"mean": [], "stddev": [], "stddev_from_all": [], "use_ucb": []}
    for b in range(count):
        base = all_data.data if sparse else all_data
        pe_params, noise_is_high, threshold = _pe_conditioning_studies(
            states_completed, base, config, studies
        )
        states_all = model.precompute_constrained(pe_params, all_data)
        u = torch.stack([torch.rand((), generator=g, device=g.device) for g in generators])
        use_ucb = (u < config.ucb_overwrite_probability) & has_completed
        if b == 0:
            first = ~(u < torch.where(noise_is_high, pe_prob_high, pe_prob))
            use_ucb = torch.where(first_has_new, first, use_ucb)
        if mesh is None:
            score_fn = _score_fn_studies(
                states_completed, states_all, config, use_ucb, threshold, trust, studies,
                prior_acquisition,
            )
            result = vec_opt.run_studies(
                score_fn, generators, count=1, prior_features=prior_features)
        else:
            def score_on(device, args=(states_completed, states_all, use_ucb, threshold, trust)):
                sc, sa, u, thr, tr = parallel.replicate(args, device)
                score = _score_fn_studies(sc, sa, config, u, thr, tr, 1, prior_acquisition)
                return lambda q: score(kernels.MixedFeatures(*(t[None] for t in q)))[0]

            one = _sweep_one_study(
                vec_opt, score_on, generators[0],
                None if prior_features is None else kernels.MixedFeatures(
                    *(t[0] for t in prior_features)), mesh)
            result = vectorized_lib.VectorizedOptimizerResult(
                kernels.MixedFeatures(*(t[None] for t in one.features)), one.scores[None])
        x = kernels.MixedFeatures(result.features.continuous, result.features.categorical)
        mean_x, std_x = mixture(states_completed, x)  # [S, 1]
        _, std_all_x = mixture(states_all, x)
        all_data = _append_row_sparse(all_data, x, ref) if sparse else _append_row(all_data, x)
        picks.append(x)
        scores.append(result.scores)
        aux["mean"].append(mean_x)
        aux["stddev"].append(std_x)
        aux["stddev_from_all"].append(std_all_x)
        aux["use_ucb"].append(use_ucb[:, None])
    out = {k: torch.cat(v, dim=1)[..., None] for k, v in aux.items() if k != "use_ucb"}
    out["use_ucb"] = torch.cat(aux["use_ucb"], dim=1)
    out["trust_radius"] = (
        trust.trust_radius() if trust is not None
        else torch.full((studies,), float("inf"), device=device)
    )
    features = kernels.MixedFeatures(
        torch.cat([x.continuous for x in picks], dim=1),
        torch.cat([x.categorical for x in picks], dim=1),
    )
    return vectorized_lib.VectorizedOptimizerResult(features, torch.cat(scores, dim=1)), out


def set_pe_scores(
    state: gp_lib.GPState,
    state_all: gp_lib.GPState,
    query: kernels.MixedFeatures,
    threshold: Tensor,
    config: UCBPEConfig,
    trust: Optional[acquisitions.TrustRegion] = None,
    prior_acquisition: Optional[PriorAcquisition] = None,
) -> Tensor:
    """[P] set-PE scores of P candidate sets ``query`` [P, q, ...].

    The log-determinant of each set's covariance under the all-points
    posterior ``state_all`` (its members' joint posteriors moment-matched
    into one, plus 1e-6·I), plus the promising-region penalty of the
    completed posterior ``state`` and the user's prior, less the trust-region
    penalty, each summed over the set. A covariance that does not factor
    scores −inf, as the JAX package's NaN log-determinant does.
    """
    means, covs = state_all.predict_joint(query)  # [P, E, q], [P, E, q, q]
    mu = torch.mean(means, dim=1)
    cov = (torch.mean(covs + means[..., :, None] * means[..., None, :], dim=1)
           - mu[..., :, None] * mu[..., None, :])
    q = cov.shape[-1]
    chol, info = torch.linalg.cholesky_ex(
        cov + 1e-6 * torch.eye(q, dtype=cov.dtype, device=cov.device))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    logdet = torch.where(info != 0, torch.full_like(logdet, float("-inf")), logdet)
    flat = kernels.MixedFeatures(*(t.flatten(0, -2) for t in query))
    mean_c, std_c = gp_lib.EnsemblePredictive(state).predict(flat)
    explore_ucb = (mean_c + config.explore_region_ucb_coefficient * std_c).reshape(mu.shape)
    value = logdet + config.cb_violation_penalty_coefficient * torch.sum(
        torch.clamp(explore_ucb - threshold, max=0.0), dim=-1)
    if prior_acquisition is not None:
        value = value + torch.sum(_prior_scores(prior_acquisition, query), dim=-1)
    if trust is not None:
        value = value - torch.sum(trust.penalty(query), dim=-1)
    return value


def _suggest_set_pe(
    model: gp_lib.VizierGaussianProcess,
    vec_opt: vectorized_lib.VectorizedOptimizer,
    state: gp_lib.GPState,
    all_data: gp_lib.GPData,
    generator: torch.Generator,
    q: int,
    config: UCBPEConfig,
    use_trust_region: bool = True,
    prior_acquisition: Optional[PriorAcquisition] = None,
) -> Tuple[vectorized_lib.VectorizedOptimizerResult, dict]:
    """The exploration set: q picks searched jointly as one point of the
    (q·D)-space (``vec_opt``'s strategy), by :func:`set_pe_scores`.

    ``state`` is the completed posterior (one objective), ``all_data`` the
    all-points rows with any earlier pick appended. Returns the set's q
    suggestions, each scored with the set's value, and their aux.
    """
    dc, ds = all_data.continuous.shape[-1], all_data.categorical.shape[-1]
    pe_params, _, thresholds = _pe_conditioning([state], all_data, config)
    state_all = model.precompute_constrained(pe_params[0], all_data)
    trust = acquisitions.TrustRegion.from_data(all_data) if use_trust_region else None

    def score_fn(flat: kernels.MixedFeatures) -> Tensor:
        pool = flat.continuous.shape[0]
        query = kernels.MixedFeatures(
            flat.continuous.reshape(pool, q, dc), flat.categorical.reshape(pool, q, ds))
        return set_pe_scores(
            state, state_all, query, thresholds[0], config, trust, prior_acquisition)

    result = vec_opt(score_fn, generator, count=1)
    picks = kernels.MixedFeatures(
        result.features.continuous[0].reshape(q, dc), result.features.categorical[0].reshape(q, ds))
    mean_x, std_x = _mixture_predict([state], picks)  # [1, q]
    _, std_all_x = _mixture_predict([state_all], picks)
    aux = dict(
        mean=mean_x.T, stddev=std_x.T, stddev_from_all=std_all_x.T,
        use_ucb=torch.zeros((q,), dtype=torch.bool, device=mean_x.device),
        trust_radius=(trust.trust_radius() if trust is not None
                      else torch.tensor(float("inf"), device=mean_x.device)),
    )
    return vectorized_lib.VectorizedOptimizerResult(picks, result.scores[0].expand(q)), aux


def _train_mt_gp(
    model: multitask_gp.MultiTaskGaussianProcess,
    optimizer,
    data: multitask_gp.MultiTaskData,
    generator: torch.Generator,
    num_restarts: int,
    ensemble_size: int,
) -> multitask_gp.MultiTaskGPState:
    """Joint multi-task ARD: random restarts → batched L-BFGS → the top
    ``ensemble_size`` posteriors."""
    coll = model.param_collection()
    inits = coll.batch_random_init_unconstrained(generator, num_restarts)
    result = optimizer(
        lambda p: model.neg_log_likelihood(p, data), inits, best_n=ensemble_size
    )
    return model.precompute(result.params, data)


@dataclasses.dataclass
class VizierGPUCBPEBandit(gp_bandit.VizierGPBandit):
    """GP-UCB-PE batch designer (service DEFAULT)."""

    config: UCBPEConfig = UCBPEConfig()
    num_seed_trials: int = 1  # reference default: center point first
    # Acquisition evaluation budget for batch suggests:
    # - "first_pick_full" (default): the first (exploitation) pick runs the
    #   full ``max_acquisition_evaluations``; the remaining picks split one
    #   further full budget between them.
    # - "per_batch": one full budget split across all picks (floored at
    #   _MIN_PICK_EVALUATIONS).
    # - "per_pick": every pick runs the full budget.
    acquisition_budget_policy: str = "first_pick_full"
    # A user's additive score over the candidates ([Q, ...] features -> [Q],
    # on the designer's device), added to every pick's UCB and PE scores.
    prior_acquisition: Optional[PriorAcquisition] = None

    def __post_init__(self):
        super().__post_init__()
        if self.acquisition_budget_policy not in ("first_pick_full", "per_batch", "per_pick"):
            raise ValueError(
                "acquisition_budget_policy must be 'first_pick_full' | "
                f"'per_batch' | 'per_pick', got {self.acquisition_budget_policy!r}."
            )
        self._active_trials: List[trial_.Trial] = []
        # Each objective's warper of the last train (``sample`` unwarps with them).
        self._metric_warpers: List[output_warpers.WarperPipeline] = []
        self._warpers_fitted = False
        # The trained (states, datas), reused until new data arrives.
        self._cached_states = None
        self._pick_opt_cache: Dict[int, vectorized_lib.VectorizedOptimizer] = {}
        self._set_opt_cache: Dict[int, vectorized_lib.VectorizedOptimizer] = {}
        # Per-objective warm-start seeds of the independent-GP path, random
        # until a train has run. The multi-task trainer has no warm start.
        self._warm_params_me = self._random_warm_seeds(self.rng_seed + 2)

    def _random_warm_seeds(self, seed: int) -> List[gp_lib.Params]:
        """One random placeholder seed per objective, from one generator."""
        coll = self._model.param_collection()
        gen = gp_bandit._generator(self.device, seed)
        return [coll.random_init_unconstrained(gen) for _ in self._objective_indices()]

    def _split_vec_opt(self, num_picks: int) -> vectorized_lib.VectorizedOptimizer:
        """One full budget split evenly across ``num_picks`` picks."""
        if num_picks <= 1:
            return self._vec_opt
        per_pick = max(self.max_acquisition_evaluations // num_picks, _MIN_PICK_EVALUATIONS)
        opt = self._pick_opt_cache.get(per_pick)
        if opt is None:
            opt = vectorized_lib.VectorizedOptimizer(
                self._vec_opt.strategy, max_evaluations=per_pick, device=self.device
            )
            self._pick_opt_cache[per_pick] = opt
        return opt

    def _pick_vec_opt(self, count: int) -> vectorized_lib.VectorizedOptimizer:
        """The acquisition optimizer the batch loop's picks run with."""
        if self.acquisition_budget_policy == "per_pick" or count <= 1:
            return self._vec_opt
        if self.acquisition_budget_policy == "first_pick_full":
            return self._split_vec_opt(count - 1)
        return self._split_vec_opt(count)

    # -- Designer ----------------------------------------------------------

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        if completed.trials:
            self._cached_states = None  # new labels invalidate the GP fit
        self._trials.extend(completed.trials)
        self._active_trials = list(all_active.trials)

    def _has_new_completed_trials(self) -> bool:
        """True iff a completed trial postdates every active trial's creation."""
        if not self._trials:
            return False
        if not self._active_trials:
            return True
        completion = [t.completion_time for t in self._trials if t.completion_time]
        creation = [t.creation_time for t in self._active_trials if t.creation_time]
        if not completion or not creation:
            return True
        return max(completion) > max(creation)

    def _objective_indices(self) -> List[int]:
        return [j for j, m in enumerate(self.problem.metric_information) if not m.is_safety_metric]

    def _use_multitask(self, num_metrics: int) -> bool:
        return self.config.multitask_type is not MultiTaskType.INDEPENDENT and num_metrics > 1

    def _mt_model(self, num_metrics: int) -> multitask_gp.MultiTaskGaussianProcess:
        return multitask_gp.MultiTaskGaussianProcess(
            num_continuous=self._model.num_continuous,
            num_categorical=self._model.num_categorical,
            num_tasks=num_metrics,
            multitask_type=self.config.multitask_type,
            device=self.device,
        )

    # -- sparse surrogate for the DEFAULT ----------------------------------

    def _sparse_ucb_pe_eligible(self) -> bool:
        """Whether the sparse surrogate may serve this designer's suggests:
        the single-objective greedy path only, off the mesh, without set
        acquisition, prior_acquisition or transfer priors."""
        cfg = self.surrogate
        return bool(
            cfg is not None and cfg.sparse and cfg.sparse_ucb_pe and self._num_objectives() == 1
            and self._mesh is None
            and not self.config.optimize_set_acquisition_for_exploration
            and self.prior_acquisition is None
            and not self._priors
        )

    def _refresh_ucb_pe_surrogate_mode(self) -> str:
        """The auto-switch, applied only where the sparse UCB-PE path covers;
        ineligible designers never leave exact."""
        if not self._sparse_ucb_pe_eligible():
            return self._surrogate_mode
        return self._refresh_surrogate_mode()

    def _refresh_surrogate_mode(self) -> str:
        before = self._surrogate_counts["crossovers"]
        mode = super()._refresh_surrogate_mode()
        if self._surrogate_counts["crossovers"] != before:
            # The per-objective warm seeds and the cached fit are as stale as
            # the base class's state: fresh random placeholders, one per metric.
            crossovers = self._surrogate_counts["crossovers"]
            self._warm_params_me = self._random_warm_seeds(self.rng_seed + 2 + crossovers)
            self._cached_states = None
        return mode

    def _sparse_all_model(self, count: int) -> sparse_gp.SparseGaussianProcess:
        """The re-conditioning model: the trained posterior's m slots plus one
        spare Nyström slot per batch pick."""
        return sparse_gp.SparseGaussianProcess(
            base=self._model, num_inducing=self._sparse_model().num_inducing + count
        )

    def _train_states_me(self) -> tuple:
        """Per-objective ARD trains, cached until update() adds labels.

        Returns (states, datas): ``datas`` holds one warped ``GPData`` per
        objective (safety metrics left out), each with its own warper and row
        mask; ``states`` one trained state per objective, or one
        ``MultiTaskGPState`` for a SEPARABLE ``multitask_type`` with several
        objectives. In sparse mode (a single objective only) the state is a
        ``SparseGPState`` over the k-center inducing set of the data. A
        single-objective suggest trains in its compute-IR program instead,
        and caches its fit (exact or sparse) here.
        """
        if self._cached_states is not None:
            return self._cached_states
        raw = self._converter.metrics.encode(self._trials)  # [N, M_all], all-MAXIMIZE
        features, n_pad = self._padded_features(self._trials)
        datas = []
        self._metric_warpers = []
        self._warpers_fitted = raw.shape[0] > 0
        for j in self._objective_indices():
            warper = output_warpers.create_default_warper()
            warped = warper(raw[:, j]) if raw.shape[0] else raw[:, j]
            self._metric_warpers.append(warper)
            datas.append(gp_lib.GPData.from_model_data(
                types.ModelData(features, self._padded_labels(warped, n_pad)), self.device
            ))
        ensemble = max(self.ensemble_size, 1)
        if len(datas) == 1 and self._refresh_ucb_pe_surrogate_mode() == surrogate_config_lib.MODE_SPARSE:
            states = [self._train_sparse(datas[0], ensemble, self._warm_params_me[0])]
        elif self._use_multitask(len(datas)):
            mt_model = self._mt_model(len(datas))
            mt_data = multitask_gp.MultiTaskData.from_gp_datas(datas)
            if self._mesh is None:
                states = _train_mt_gp(
                    mt_model, self._ard, mt_data, self._phase_generator(), self.ard_restarts,
                    ensemble,
                )
            else:
                # The same restart split as the independent path: the sharded
                # trainer takes any model with the GP's three methods.
                states = parallel.train_gp_sharded(
                    mt_model, self._ard, mt_data, self._phase_generator(),
                    self._mesh_restarts(self.ard_restarts), ensemble, self._mesh,
                )
            self._ard_train_counts["cold"] += 1
            self._cached_states = (states, datas)
            return self._cached_states
        else:
            # Each metric's train is seeded with its own previous optimum (on
            # the mesh, the sharded train when there is one).
            restarts = self._restarts(ensemble)
            generator = self._phase_generator()
            states = [
                self._train_one(self._model, data, generator, restarts, ensemble, warm)
                for data, warm in zip(datas, self._warm_params_me)
            ]
            self._record_train()
        if self._warm_update_allowed():
            self._warm_params_me = [self._unconstrained_best(s) for s in states]
            self._warm_is_trained = True
        self._cached_states = (states, datas)
        return self._cached_states

    # -- warm-start surface ------------------------------------------------

    def warm_start_state(self) -> Optional[List[gp_lib.Params]]:
        """Per-objective trained unconstrained params (independent path)."""
        return list(self._warm_params_me) if self._warm_is_trained else None

    def set_warm_start_state(self, params: List[gp_lib.Params]) -> None:
        if len(params) != len(self._warm_params_me):
            raise ValueError(
                f"Expected {len(self._warm_params_me)} per-metric param dicts, "
                f"got {len(params)}."
            )
        self._warm_params_me = [
            {k: v.to(self.device) for k, v in p.items()} for p in params
        ]
        self._warm_is_trained = True

    def _all_points_data(self, count: int) -> gp_lib.GPData:
        """GPData over completed+active rows with capacity for the picks."""
        return gp_lib.GPData.from_model_data(self._all_points_model_data(count), self.device)

    def _all_points_model_data(self, count: int) -> types.ModelData:
        """Host model data over completed+active rows with capacity for the picks."""
        all_trials = list(self._trials) + list(self._active_trials)
        features, n_pad = self._padded_features(all_trials, extra_rows=count)
        spare = n_pad - len(all_trials)
        if spare < count:  # capacity guard: _append_row must never no-op
            raise RuntimeError(
                f"Padded capacity {n_pad} leaves {spare} spare rows for a batch of {count}."
            )
        zero_labels = types.PaddedArray.from_array(
            np.zeros((len(all_trials), 1), np.float32), (n_pad, 1), fill_value=np.nan
        )
        return types.ModelData(features, zero_labels)

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        if len(self._trials) + len(self._active_trials) < self.num_seed_trials:
            return self._seed_suggestions(count)
        if self._priors:
            return self._suggest_with_priors(count)
        resolved = compute_registry.resolve(self, count)
        if resolved is not None:
            # The single-objective suggest (exact or sparse) with no cached
            # fit: this study alone through its compute-IR program.
            return resolved[0].run_alone(self, count)
        if len(self._objective_indices()) == 1:
            return self._suggest_over_cached_fit(count)
        return self._suggest_multiobjective(count)

    def _two_phase(self, count: int) -> bool:
        """Whether a batch runs as a full-budget first pick and the rest."""
        return self.acquisition_budget_policy == "first_pick_full" and count > 1

    def _suggest_over_cached_fit(self, count: int) -> List[trial_.TrialSuggestion]:
        """A single-objective suggest outside the programs: over the cached
        fit when no labels came since the last train, else over a fresh one
        (set acquisition, ``prior_acquisition``). The program's sweeps run
        as a study axis of one, seeded as the program seeds them; with set
        acquisition and ``count`` > 1 the exploration picks are one set."""
        # Named by the mode the last refresh left (the train refreshes it).
        train_phase, acquisition_phase = _ALONE_PHASES[
            self._surrogate_mode == surrogate_config_lib.MODE_SPARSE]
        with profiler.timeit("train_gp"), device_timing.device_phase(train_phase, self.device):
            (state,), (data,) = self._train_states_me()
            gp_bandit._synchronize(self.device)
        if self.config.optimize_set_acquisition_for_exploration and count > 1:
            return self._suggest_with_set_acquisition(count, state, data)
        one = lambda tree: batch_executor.stack_pytrees([tree])  # noqa: E731
        sparse = isinstance(state, sparse_gp.SparseGPState)
        if sparse:
            states = dataclasses.replace(state, sdata=one(state.sdata))
        else:
            states = dataclasses.replace(state, data=one(state.data))
        seeds = [self._next_seed() for _ in range(2 if self._two_phase(count) else 1)]
        flags = dict(
            first_has_new=torch.tensor([self._has_new_completed_trials()], device=self.device),
            has_completed=torch.tensor([bool(self._trials)], device=self.device),
        )
        all_data = gp_lib.GPData.from_model_data(
            one(self._all_points_model_data(count)), self.device)
        with profiler.timeit("acquisition_optimizer"), device_timing.device_phase(
            acquisition_phase, self.device
        ):
            segments, rows = _ucb_pe_sweeps(
                self, states, one(data), all_data,
                [gp_bandit._generators(self.device, seed) for seed in seeds], count, sparse,
                **flags,
            )
            segments = batch_executor.to_host(segments)
        if sparse:
            self._surrogate_counts["sparse_suggests"] += 1
        out: List[trial_.TrialSuggestion] = []
        with profiler.timeit("best_candidates_to_trials"):
            for (result, aux), n in zip(segments, rows):
                out.extend(self._decode_ucb_pe(
                    batch_executor.slice_pytree(result, 0), batch_executor.slice_pytree(aux, 0),
                    n))
        return out

    def _suggest_with_set_acquisition(
        self, count: int, state: gp_lib.GPState, data: gp_lib.GPData
    ) -> List[trial_.TrialSuggestion]:
        """One UCB-or-PE pick when fresh labels came in, then the rest as one
        jointly searched exploration set (``_suggest_set_pe``)."""
        suggestions: List[trial_.TrialSuggestion] = []
        all_data = self._all_points_data(count)
        if self._has_new_completed_trials():
            one = lambda tree: batch_executor.stack_pytrees([tree])  # noqa: E731
            with profiler.timeit("acquisition_optimizer"):
                first, aux = _suggest_batch_studies(
                    self._vec_opt, dataclasses.replace(state, data=one(data)), one(all_data),
                    gp_bandit._prior_features_from_data(one(data)), [self._phase_generator()],
                    torch.tensor([True], device=self.device),
                    torch.tensor([bool(self._trials)], device=self.device), 1, self.config,
                    self.use_trust_region, prior_acquisition=self.prior_acquisition,
                    mesh=self._mesh,
                )
                gp_bandit._synchronize(self.device)
            first, aux = batch_executor.slice_pytree((first, aux), 0)
            suggestions.extend(self._decode_ucb_pe(first, aux, 1))
            all_data = _append_row(all_data, first.features)
        q = count - len(suggestions)
        with profiler.timeit("set_acquisition_optimizer"):
            result, aux = _suggest_set_pe(
                self._model, self._set_vec_opt(q), state, all_data, self._phase_generator(), q,
                self.config, self.use_trust_region, self.prior_acquisition,
            )
            gp_bandit._synchronize(self.device)
        with profiler.timeit("best_candidates_to_trials"):
            suggestions.extend(self._decode_ucb_pe(result, aux, q))
        return suggestions

    def _set_vec_opt(self, q: int) -> vectorized_lib.VectorizedOptimizer:
        """The set search's optimizer: eagle over q copies of the space."""
        opt = self._set_opt_cache.get(q)
        if opt is None:
            enc = self._converter.encoder
            cat_sizes = tuple(enc.category_sizes) + (1,) * (self._cat_width - enc.num_categorical)
            opt = vectorized_lib.VectorizedOptimizer(
                eagle_lib.VectorizedEagleStrategy(
                    num_continuous=self._cont_width * q, category_sizes=cat_sizes * q),
                max_evaluations=self.max_acquisition_evaluations, device=self.device,
            )
            self._set_opt_cache[q] = opt
        return opt

    def _suggest_multiobjective(self, count: int) -> List[trial_.TrialSuggestion]:
        """HV-scalarized UCB-PE over the per-metric (or multi-task) fit."""
        with profiler.timeit("train_gp"):
            states, datas = self._train_states_me()
        if self.config.optimize_set_acquisition_for_exploration:
            raise ValueError(
                "optimize_set_acquisition_for_exploration supports exactly one objective metric.")
        all_data = self._all_points_data(count)
        num_metrics = len(datas)
        labels_mn = torch.stack([d.labels for d in datas])  # [M, N1]
        labels_mask = datas[0].row_mask
        hv = dict(
            labels_mn=labels_mn, labels_mask=labels_mask,
            # Reference point: nadir − 0.1·range of the warped labels.
            ref_point=acquisitions.get_reference_point(labels_mn, labels_mask),
        )
        if isinstance(states, multitask_gp.MultiTaskGPState):
            all_data = multitask_gp.MultiTaskData(
                features_data=all_data,
                task_labels=torch.zeros((num_metrics, all_data.num_rows), device=self.device),
                task_mask=all_data.row_mask[None, :].repeat(num_metrics, 1),
            )
        append = _pick_appender(all_data)
        first_has_new = self._has_new_completed_trials()
        has_completed = bool(self._trials)
        prior = gp_bandit._prior_features_from_data(datas[0])
        args = (self.config, self.use_trust_region)
        kw = dict(hv, prior_acquisition=self.prior_acquisition, mesh=self._mesh)
        with profiler.timeit("acquisition_optimizer"):
            if self._two_phase(count):
                # Full budget on the exploitation-critical first pick; one
                # further full budget split across the remaining picks.
                first, aux1 = _suggest_batch(
                    self._vec_opt, states, all_data, prior, self._phase_generator(),
                    first_has_new, has_completed, 1, *args, **kw,
                )
                all_data = append(all_data, first.features)
                rest, aux2 = _suggest_batch(
                    self._pick_vec_opt(count), states, all_data, prior, self._phase_generator(),
                    False, has_completed, count - 1, *args, **kw,
                )
                results = [(first, aux1, 1), (rest, aux2, count - 1)]
            else:
                batch, aux = _suggest_batch(
                    self._pick_vec_opt(count), states, all_data, prior, self._phase_generator(),
                    first_has_new, has_completed, count, *args, **kw,
                )
                results = [(batch, aux, count)]
            gp_bandit._synchronize(self.device)
        out: List[trial_.TrialSuggestion] = []
        with profiler.timeit("best_candidates_to_trials"):
            for result, aux, rows in results:
                out.extend(self._decode_ucb_pe(result, aux, rows))
        return out

    def _decode_ucb_pe(
        self, result: vectorized_lib.VectorizedOptimizerResult, aux: dict, count: int
    ) -> List[trial_.TrialSuggestion]:
        enc = self._converter.encoder
        cont = result.features.continuous[:count].cpu().numpy()
        cat = result.features.categorical[:count].cpu().numpy()
        scores = result.scores[:count].cpu().numpy()
        host = {k: v.cpu().numpy() for k, v in aux.items()}
        suggestions = []
        for i in range(count):
            params = self._converter.to_parameters(
                cont[i : i + 1, : enc.num_continuous], cat[i : i + 1, : enc.num_categorical]
            )[0]
            s = trial_.TrialSuggestion(parameters=params)
            ns = s.metadata.ns("gp_ucb_pe")
            ns["acquisition"] = float(scores[i])
            ns["use_ucb"] = str(bool(host["use_ucb"][i]))
            ns["trust_radius"] = float(host["trust_radius"])
            # One entry per objective.
            pred = ns.ns("prediction_in_warped_y_space")
            for key in ("mean", "stddev", "stddev_from_all"):
                pred[key] = np.array2string(host[key][i], separator=",")
            suggestions.append(s)
        return suggestions


    # -- Predictor -----------------------------------------------------------

    def sample(
        self, suggestions: Sequence[trial_.TrialSuggestion], rng=None, num_samples: int = 1000,
    ) -> np.ndarray:
        """Posterior samples in each objective's own scale: [num_samples, T]
        for one objective, [num_samples, T, M] for several. Drawn over the
        cached fit (a train only when none is cached), then unwarped by each
        objective's warper and sign-restored; warped when no label has been
        seen. ``rng`` is None, a numpy Generator or a torch Generator on the
        designer's device."""
        if not suggestions:
            return np.zeros((num_samples, 0))
        shape = (num_samples, len(self._objective_indices()), len(suggestions))
        eps = torch.randn(shape, generator=gp_bandit._sample_generator(rng, self.device),
                          device=self.device)
        return self._samples_from_draws(suggestions, eps)

    def _samples_from_draws(
        self, suggestions: Sequence[trial_.TrialSuggestion], eps: Tensor
    ) -> np.ndarray:
        """:meth:`sample` from given standard normals ``eps`` [num_samples, M, T]."""
        states, _ = self._train_states_me()
        mean, stddev = _mixture_predict(states, self._encode_suggestions(suggestions))  # [M, T]
        warped = (mean[None] + stddev[None] * eps.to(mean.device)).cpu().numpy()
        if self._warpers_fitted:
            out = np.empty_like(warped)
            for m, (warper, j) in enumerate(zip(self._metric_warpers, self._objective_indices())):
                unwarped = warper.unwarp(warped[:, m, :].reshape(-1, 1)).reshape(
                    warped.shape[0], -1)
                out[:, m, :] = self._converter.metrics.decode_column(unwarped, j)
            warped = out
        out = np.moveaxis(warped, 1, 2)  # [S, T, M]
        return out[:, :, 0] if out.shape[-1] == 1 else out


def default_factory(
    problem: base_study_config.ProblemStatement, seed: Optional[int] = None, **kwargs
) -> VizierGPUCBPEBandit:
    return VizierGPUCBPEBandit(problem, rng_seed=seed or 0, **kwargs)


# A study's sequential suggest times its train and its picks as these device
# phases (exact, sparse), as the JAX package's does; a batched flush is one
# phase, its program's ``device_phase``.
_ALONE_PHASES = {
    False: ("gp_ucb_pe.train_gp", "gp_ucb_pe.acquisition"),
    True: ("sparse_gp.ucb_pe_train_gp", "sparse_gp.ucb_pe_acquisition"),
}


# -- compute-IR programs (vizier_tpu_torch.compute) ---------------------------
#
# The batched compute of the service DEFAULT: one program per surrogate
# (exact | sparse UCB-PE). A flush trains its studies as one batch, then runs
# their greedy batches as one loop (two sweeps under ``first_pick_full`` with
# count > 1, with each study's first pick appended between them).


def _ucb_pe_unbatchable(designer: "VizierGPUCBPEBandit", count: int) -> bool:
    """Paths the programs do not cover: a mesh designer, the seeding stage,
    transfer priors, more than one objective (independent or multi-task), set
    acquisition, ``prior_acquisition``, and a cached fit (the sequential
    suggest would skip training; re-training it in a flush would not)."""
    del count
    return bool(
        designer._mesh is not None
        or len(designer._trials) + len(designer._active_trials) < designer.num_seed_trials
        or designer._priors
        or len(designer._objective_indices()) != 1
        or designer.config.optimize_set_acquisition_for_exploration
        or designer.prior_acquisition is not None
        or designer._cached_states is not None
    )


def _ucb_pe_prepare(designer: "VizierGPUCBPEBandit", count: int, sparse: bool) -> dict:
    """Host-side half of a single-objective UCB-PE suggest: encode + warp,
    and the phase seeds in the sequential order (train, acquisition, and
    the second sweep of a two-phase budget). Issues no device work."""
    raw = designer._converter.metrics.encode(designer._trials)
    features, n_pad = designer._padded_features(designer._trials)
    j = designer._objective_indices()[0]
    warper = output_warpers.create_default_warper()
    warped = warper(raw[:, j]) if raw.shape[0] else raw[:, j]
    designer._metric_warpers = [warper]
    designer._warpers_fitted = raw.shape[0] > 0
    return dict(
        designer=designer,
        count=count,
        md=types.ModelData(features, designer._padded_labels(warped, n_pad)),
        all_md=designer._all_points_model_data(count),
        first_has_new=np.asarray(designer._has_new_completed_trials()),
        has_completed=np.asarray(bool(designer._trials)),
        warm=designer._warm_params_me[0],
        restarts=designer._restarts(max(designer.ensemble_size, 1)),
        seed_train=designer._next_seed(),
        seed_acq=designer._next_seed(),
        seed_rest=designer._next_seed() if designer._two_phase(count) else None,
        sparse=sparse,
    )


def _ucb_pe_sweeps(
    d0: VizierGPUCBPEBandit, states, data: gp_lib.GPData, all_data: gp_lib.GPData,
    generators: Sequence[Sequence[torch.Generator]], count: int, sparse: bool, *,
    first_has_new: Tensor, has_completed: Tensor, device: Optional[torch.device] = None,
):
    """The greedy UCB-PE batches of S studies over their trained ``states``
    (S × E members; ``data`` and ``all_data`` stacked [S, ...]): one loop
    of ``count`` picks, or with a two-phase budget a full-budget first pick,
    its append, then the other picks on a split budget. ``generators`` holds
    each phase's S generators; ``device`` is where they run (the designer's
    by default). Returns the [(result, aux)] segments on the device and
    their pick counts. A mesh designer's one study sweeps on its mesh."""
    device = d0.device if device is None else device
    if sparse:
        # Each study's trained inducing set over its all-points rows, with
        # one spare Nyström slot per pick, re-conditioned over m + count.
        all_data = sparse_gp.with_pending_capacity(states.sdata, all_data, count)
        pick_model = parallel.replicate(d0._sparse_all_model(count), device)
    else:
        pick_model = None
    full_opt, pick_opt = parallel.replicate((d0._vec_opt, d0._pick_vec_opt(count)), device)
    prior = gp_bandit._prior_features_from_data(data)
    args = (d0.config, d0.use_trust_region, pick_model, d0.prior_acquisition, d0._mesh)
    if not d0._two_phase(count):
        batch, aux = _suggest_batch_studies(
            pick_opt, states, all_data, prior, generators[0],
            first_has_new, has_completed, count, *args,
        )
        return [(batch, aux)], [count]
    # Full budget on the exploitation-critical first pick; one further full
    # budget split across the remaining picks.
    first, aux1 = _suggest_batch_studies(
        full_opt, states, all_data, prior, generators[0],
        first_has_new, has_completed, 1, *args,
    )
    if sparse:
        all_data = _append_row_sparse(all_data, first.features, states.first_members())
    else:
        all_data = _append_row(all_data, first.features)
    rest, aux2 = _suggest_batch_studies(
        pick_opt, states, all_data, prior, generators[1],
        torch.zeros_like(first_has_new), has_completed, count - 1, *args,
    )
    return [(first, aux1), (rest, aux2)], [1, count - 1]


_UCB_PE_INPUTS = ("md", "all_md", "first_has_new", "has_completed", "warm", "seed_train",
                  "seed_acq", "seed_rest")


def _ucb_pe_flush(items, pad_to: Optional[int], sparse: bool, alone: bool = False,
                  placement=None) -> List[dict]:
    """Encode → ARD → the greedy UCB-PE batch → warm seeds for every study
    of the flush as one batch, then ONE device-to-host copy of the picks.
    Each slot's state and data stay on the device as views. ``alone``: one
    study's sequential suggest, timed per stage. On a mesh ``placement`` the
    padded study axis is split over its devices, one batch per device."""
    outputs: List[dict] = []
    for inputs, device in gp_bandit._stacked_chunks(items, _UCB_PE_INPUTS, pad_to, placement):
        outputs += _ucb_pe_chunk(items[0], inputs, device, sparse, alone)
    return outputs[: len(items)]


def _ucb_pe_chunk(item0: dict, inputs: dict, device: torch.device, sparse: bool,
                  alone: bool) -> List[dict]:
    """:func:`_ucb_pe_flush` of one device's stacked ``inputs``."""
    d0: VizierGPUCBPEBandit = item0["designer"]
    count = item0["count"]
    data = gp_lib.GPData.from_model_data(inputs["md"], device)
    all_data = gp_lib.GPData.from_model_data(inputs["all_md"], device)
    studies = data.num_studies
    generators = lambda name: gp_bandit._generators(device, inputs[name])  # noqa: E731
    train_args = (
        parallel.replicate(d0._ard, device), data, generators("seed_train"), item0["restarts"],
        max(d0.ensemble_size, 1), inputs["warm"],
    )
    train_phase, acquisition_phase = _ALONE_PHASES[sparse] if alone else (None, None)
    with profiler.timeit("train_gp"), device_timing.device_phase(train_phase, device):
        if sparse:
            model = parallel.replicate(d0._sparse_model(), device)
            states = sparse_bandit._train_sparse_gp_studies(model, *train_args)
        else:
            model = parallel.replicate(d0._model, device)
            states = gp_bandit._train_gp_studies(model, *train_args)
        warm_next = gp_bandit._warm_next_batched(model, states, studies)
        gp_bandit._synchronize(device)
    phases = ["seed_acq", "seed_rest"] if d0._two_phase(count) else ["seed_acq"]
    with profiler.timeit("acquisition_optimizer"), device_timing.device_phase(
        acquisition_phase, device
    ):
        segments, rows = _ucb_pe_sweeps(
            d0, states, data, all_data, [generators(name) for name in phases], count, sparse,
            first_has_new=torch.as_tensor(inputs["first_has_new"], device=device),
            has_completed=torch.as_tensor(inputs["has_completed"], device=device),
            device=device,
        )
        segments = batch_executor.to_host(segments)
    return [
        dict(
            states=gp_bandit._slot_state(states, i, studies),
            warm_next=batch_executor.slice_pytree(warm_next, i),
            data=batch_executor.slice_pytree(data, i),
            segments=[
                (batch_executor.slice_pytree(result, i), batch_executor.slice_pytree(aux, i), n)
                for (result, aux), n in zip(segments, rows)
            ],
            sparse=sparse,
        )
        for i in range(studies)
    ]


def _ucb_pe_finalize(designer: "VizierGPUCBPEBandit", item: dict, output: dict) -> list:
    """The sequential suggest's state transitions (train count, warm seed,
    cached fit, sparse posterior and counter), then the decode."""
    states = output["states"]
    designer._record_train()
    if designer._warm_update_allowed():
        designer._warm_params_me = [output["warm_next"]]
        designer._warm_is_trained = True
    designer._cached_states = ([states], [output["data"]])
    if output["sparse"]:
        designer._last_sparse_state = states
        designer._surrogate_counts["sparse_suggests"] += 1
    out: List[trial_.TrialSuggestion] = []
    with profiler.timeit("best_candidates_to_trials"):
        for result, aux, rows in output["segments"]:
            out.extend(designer._decode_ucb_pe(result, aux, rows))
    return out


class UCBPEProgram(compute_ir.DesignerProgram):
    """Exact UCB-PE flush: the studies' ARD trains as one batch, then their
    greedy batch loops as one."""

    kind = "gp_ucb_pe"
    device_phase = "gp_ucb_pe.suggest_batched"
    shardable_batch_axis = "study"
    algorithms = ("DEFAULT", "GP_UCB_PE", "ALGORITHM_UNSPECIFIED")
    sparse = False

    def bucket_key(self, designer, count):
        if _ucb_pe_unbatchable(designer, count):
            return None
        mode = designer._refresh_ucb_pe_surrogate_mode()
        if (mode == surrogate_config_lib.MODE_SPARSE) != self.sparse:
            return None  # the other surrogate's program owns this study
        pad = designer._converter.padding
        n_all = len(designer._trials) + len(designer._active_trials)
        models = (
            (designer._sparse_model(), designer._sparse_all_model(count))
            if self.sparse else (designer._model,)
        )
        return compute_ir.BucketKey(
            kind=self.kind,
            pad_trials=pad.pad_trials(len(designer._trials)),
            cont_width=designer._cont_width,
            cat_width=designer._cat_width,
            metric_count=1,
            count=count,
            statics=(
                # The all-points rows get their own padded size (spare rows
                # for the picks), so it is part of the shape identity.
                pad.pad_trials(n_all + count),
                *models,
                designer._ard,
                designer._vec_opt,
                designer._pick_vec_opt(count),
                designer._restarts(max(designer.ensemble_size, 1)),
                max(designer.ensemble_size, 1),
                designer.config,
                designer.use_trust_region,
                designer.acquisition_budget_policy,
            ),
        )

    def prepare(self, designer, count):
        return _ucb_pe_prepare(designer, count, sparse=self.sparse)

    def device_program(self, items, pad_to=None, placement=None):
        """The bucket's studies as one batch; on a mesh ``placement`` the
        padded study axis is split over its devices."""
        with device_timing.device_phase(self.device_phase, items[0]["designer"].device):
            return _ucb_pe_flush(items, pad_to, sparse=self.sparse, placement=placement)

    def finalize(self, designer, item, output):
        return _ucb_pe_finalize(designer, item, output)

    def run_alone(self, designer, count):
        item = self.prepare(designer, count)
        (output,) = _ucb_pe_flush([item], None, sparse=self.sparse, alone=True)
        return self.finalize(designer, item, output)

    def prewarm_factory(self, problem, **kwargs):
        return VizierGPUCBPEBandit(problem, **kwargs)


class UCBPESparseProgram(UCBPEProgram):
    """Sparse UCB-PE flush: SGPR trains, then the greedy batch with each
    pick conditioned through the inducing-point posterior (Nyström
    augment); both sparse models ride in the statics."""

    kind = "gp_ucb_pe_sparse"
    device_phase = "sparse_gp.ucb_pe_suggest_batched"
    shardable_batch_axis = "study"
    sparse = True


compute_registry.register(VizierGPUCBPEBandit, UCBPEProgram())
compute_registry.register(VizierGPUCBPEBandit, UCBPESparseProgram())
