"""VizierGPBandit: the GP Bayesian-optimization designer.

Counterpart of the JAX package's ``designers/gp_bandit.py:284``:

- quasi-random (+default-point) seeding for the first trials;
- output warping (half-rank → z-score → infeasible imputation);
- ARD via multi-restart L-BFGS, restarts batched on the device, with the
  previous suggest's optimum prepended as one more restart;
- hyperparameter ensembles (top-k restarts) combined as a uniform mixture;
- UCB/EI/PI/PE acquisition with an L∞ trust region, maximized by the
  vectorized Eagle strategy; ``acquisition="qei"`` with ``count`` > 1 searches
  whole batches jointly (``_maximize_q_batch``: Monte-Carlo qEI over the
  joint posterior of each candidate's q points);
- transfer learning (``set_priors``): a stacked-residual GP over the prior
  studies and the current one (``models.stacked_residual``);
- the sparse-surrogate auto-switch (``surrogate``): from the config's trial
  threshold up, with hysteresis, the single-objective suggest trains the SGPR
  inducing-point posterior (``surrogates.sparse_bandit``) instead of the
  exact GP; ``warm_ard_restarts`` cuts a warm-started train's restart budget;
- multi-objective studies: one cold-trained GP per objective and UCB
  hypervolume-scalarized along 64 random directions
  (``acquisitions.HVScalarizedScoring``).

The single-objective suggest (exact or sparse) is a compute-IR program
(``GPBanditProgram``, ``GPBanditSparseProgram``): the batch executor runs
up to a bucket's worth of studies as one batch over a leading study axis,
and the sequential ``suggest`` runs the same program on its study alone.
Each suggest draws two seeds from the study's seed stream (train, then
acquisition), so slot i of a flush draws what study i draws alone. Priors
and joint q-batches run outside the programs, as in the JAX package; the
designer is also a ``Predictor`` (``predict``/``sample``, unwarped to the
metric's scale).

With more than one device (``use_mesh``; automatic unless
``VIZIER_TORCH_DISABLE_MESH`` is set) the exact suggest runs on a mesh of the
host's devices, as the JAX package's does: the ARD restarts, rounded up to a
multiple of the mesh size, are split over the devices with the warm seed
replacing restart 0 (``parallel.train_gp_sharded``), and the sweep runs one
independent eagle pool per device, each spending the whole evaluation
budget, merged by one top-k (``parallel.maximize_acquisition_sharded``;
joint qEI too). A mesh designer takes no batched program; its sparse
suggest runs on its own device, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import parallel
from vizier_tpu_torch import types
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.algorithms import designer_policy
from vizier_tpu_torch.compute import ir as compute_ir
from vizier_tpu_torch.compute import registry as compute_registry
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.converters import padding as padding_lib
from vizier_tpu_torch.designers import quasi_random
from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.models import output_warpers
from vizier_tpu_torch.models import stacked_residual
from vizier_tpu_torch.observability import device_timing
from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.optimizers import eagle as eagle_lib
from vizier_tpu_torch.optimizers import graphs as graphs_lib
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib
from vizier_tpu_torch.parallel import batch_executor
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.surrogates import config as surrogate_config_lib
from vizier_tpu_torch.surrogates import sparse_bandit
from vizier_tpu_torch.surrogates import sparse_gp
from vizier_tpu_torch.utils import env as env_lib
from vizier_tpu_torch.utils import profiler

Tensor = torch.Tensor


def _synchronize(device: torch.device) -> None:
    """Waits for the kernels queued on a CUDA ``device``, so that a phase
    timer around their launch covers their device time, as the JAX package
    blocks on its results inside its timers."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _train_gp(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.Optimizer,
    data: gp_lib.GPData,
    generator: torch.Generator,
    num_restarts: int,
    ensemble_size: int,
    warm_start: Optional[gp_lib.Params] = None,
) -> gp_lib.GPState:
    """ARD: restarts → batched L-BFGS → top-k precomputed posteriors.

    ``warm_start`` (the previous suggest's best unconstrained params) is
    prepended as an EXTRA restart row, so the random restarts keep their
    full exploration budget (the JAX package's ``designers/gp_bandit.py:89-94``).
    """
    coll = model.param_collection()
    inits = coll.batch_random_init_unconstrained(generator, num_restarts)
    if warm_start is not None:
        inits = {k: torch.cat([warm_start[k][None], v]) for k, v in inits.items()}
    result = optimizer(
        graphs_lib.BoundLoss(model.neg_log_likelihood, data), inits, best_n=ensemble_size
    )
    return model.precompute(result.params, data)


def _generators(device: torch.device, seeds: np.ndarray) -> List[torch.Generator]:
    """One generator per study slot, from the slot's seed."""
    return [_generator(device, int(seed)) for seed in np.asarray(seeds).reshape(-1)]


def _stack_restarts(blocks: Sequence[gp_lib.Params]) -> gp_lib.Params:
    """Per-study restart blocks [R, ...] as one batch [S * R, ...]."""
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def _train_gp_studies(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.Optimizer,
    data: gp_lib.GPData,
    generators: Sequence[torch.Generator],
    num_restarts: int,
    ensemble_size: int,
    warm_start: gp_lib.Params,
) -> gp_lib.GPState:
    """S studies' ARD as one batch: the study axis of the JAX package's
    ``train_batched``.

    ``data`` is the studies' stacked ``GPData`` and ``warm_start`` their
    stacked warm seeds [S, ...]; study s's restarts are its warm row, then
    ``num_restarts`` random rows from ``generators[s]`` (:func:`_train_gp`'s
    rows). All S × (R + 1) restarts run as one L-BFGS batch; each study keeps
    its best ``ensemble_size``, so the state holds S × E members.
    """
    coll = model.param_collection()
    blocks = []
    for s, generator in enumerate(generators):
        inits = coll.batch_random_init_unconstrained(generator, num_restarts)
        blocks.append({k: torch.cat([warm_start[k][s : s + 1], v]) for k, v in inits.items()})
    result = optimizer(
        graphs_lib.BoundLoss(model.neg_log_likelihood, data), _stack_restarts(blocks),
        best_n=ensemble_size, groups=len(generators),
    )
    return model.precompute(result.params, data)


def _warm_next_batched(model, states, studies: int) -> gp_lib.Params:
    """Each study's warm seed for its next train: its best member's params
    mapped back through the bijectors ([S, ...]), the sequential writeback."""
    stride = states.params["amplitude"].shape[0] // studies
    coll = model.param_collection()
    return coll.unconstrain({k: v[::stride] for k, v in states.params.items()})


def _sweep_studies(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    acquisition: acquisitions.Acquisition,
    states,
    data: gp_lib.GPData,
    generators: Sequence[torch.Generator],
    count: int,
    use_trust_region: bool,
) -> vectorized_lib.VectorizedOptimizerResult:
    """S studies' scoring + eagle sweeps as one loop ([S, count] results):
    each study's ensemble mixture, best label and trust region, over the
    exact or the sparse posterior."""
    studies = len(generators)
    scoring = acquisitions.ScoringFunction(
        predictive=gp_lib.EnsemblePredictive(states, studies=studies),
        acquisition=acquisition,
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask)[:, None],
        trust_region=acquisitions.TrustRegion.from_data(data) if use_trust_region else None,
    )
    return vec_opt.run_studies(
        scoring.score, generators, count=count, prior_features=_prior_features_from_data(data)
    )


def _slot_state(states, index: int, studies: int):
    """Study ``index``'s members of a flush's state: its params and factors
    (views) over its own data, as the sequential path holds them."""
    stride = states.params["amplitude"].shape[0] // studies
    members = slice(index * stride, (index + 1) * stride)
    params = {k: v[members] for k, v in states.params.items()}
    if isinstance(states, sparse_gp.SparseGPState):
        return dataclasses.replace(
            states, params=params, sdata=batch_executor.slice_pytree(states.sdata, index),
            w=states.w[members], linv=states.linv[members], lb_linv=states.lb_linv[members],
        )
    return dataclasses.replace(
        states, params=params, data=batch_executor.slice_pytree(states.data, index),
        chol=states.chol[members], alpha=states.alpha[members], linv=states.linv[members],
    )


def _train_gp_per_metric(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.Optimizer,
    datas: Sequence[gp_lib.GPData],
    generator: torch.Generator,
    num_restarts: int,
) -> List[gp_lib.GPState]:
    """One cold-trained GP per objective: ``num_restarts`` random restarts
    over each metric's data (its own labels and row mask), the best kept as a
    batch of one."""
    coll = model.param_collection()
    states = []
    for data in datas:
        inits = coll.batch_random_init_unconstrained(generator, num_restarts)
        result = optimizer(
            lambda p, d=data: model.neg_log_likelihood(p, d), inits, best_n=1
        )
        states.append(model.precompute(result.params, data))
    return states


# One implementation for the exact and the sparse sweep.
_prior_features_from_data = sparse_bandit._prior_features_from_data

# Monte-Carlo draws per ensemble member of joint qEI.
_QEI_SAMPLES = 16


def qei_joint_scores(
    states: gp_lib.GPState,
    query: kernels.MixedFeatures,
    eps: Tensor,
    best_label: Tensor,
    trust: Optional[acquisitions.TrustRegion] = None,
) -> Tensor:
    """[P] Monte-Carlo qEI of P candidate batches ``query`` [P, q, ...] under
    the joint posterior of each member of ``states``.

    ``eps`` [S, E, q] are the standard normals, the same for every candidate:
    draw b of member e is mean + chol(cov)·eps[b, e]; the score is the mean
    over draws and members of the batch maximum's improvement on
    ``best_label``, less the trust-region penalty summed over the q points.
    A candidate whose covariance does not factor scores −inf, as the JAX
    package's NaN factor does in its sweep.
    """
    means, covs = states.predict_joint(query)  # [P, E, q], [P, E, q, q]
    chols, info = torch.linalg.cholesky_ex(covs)
    draws = means[:, None] + torch.einsum("peqr,ser->pseq", chols, eps)
    batch_max = torch.amax(draws, dim=-1)  # [P, S, E]
    qei = torch.mean(torch.clamp(batch_max - best_label, min=0.0), dim=(1, 2))
    qei = torch.where(torch.any(info != 0, dim=-1), torch.full_like(qei, float("-inf")), qei)
    if trust is not None:
        qei = qei - torch.sum(trust.penalty(query), dim=-1)
    return qei


def _maximize_q_batch(
    vec_opt: vectorized_lib.VectorizedOptimizer,
    states: gp_lib.GPState,
    best_label: Tensor,
    trust: Optional[acquisitions.TrustRegion],
    generator: torch.Generator,
    q: int,
    num_samples: int,
    prior_features: Optional[kernels.MixedFeatures] = None,
    mesh: Optional[parallel.Mesh] = None,
) -> vectorized_lib.VectorizedOptimizerResult:
    """Joint q-batch qEI: each candidate is a whole batch, a point of the
    (q·Dc)-space the strategy searches.

    The [num_samples, E, q] normals are drawn once, before the sweep's own
    draws, so every candidate of every iteration is scored on the same
    draws. Each iteration scores its pool with one k* and one K(q, q)
    launch (``GPState.predict_joint``'s candidate axis). The prior features
    are tiled over the q slots, so the search starts at the incumbents. With
    a ``mesh`` the search runs one independent pool per device, its
    generators drawn from ``generator`` after the normals
    (``parallel.maximize_score_fn_sharded``).
    """
    dc = states.data.continuous.shape[-1]
    ds = states.data.categorical.shape[-1]
    eps = torch.randn((num_samples, states.alpha.shape[0], q), generator=generator,
                      device=generator.device)

    def scorer(states, eps, best_label, trust):
        def score_fn(flat: kernels.MixedFeatures) -> Tensor:
            pool = flat.continuous.shape[0]
            query = kernels.MixedFeatures(
                flat.continuous.reshape(pool, q, dc),
                torch.zeros((pool, q, ds), dtype=torch.int32, device=flat.continuous.device),
            )
            return qei_joint_scores(states, query, eps, best_label, trust)

        return score_fn

    prior = None
    if prior_features is not None:
        k = prior_features.continuous.shape[0]
        prior = kernels.MixedFeatures(
            prior_features.continuous.repeat(1, q),
            torch.zeros((k, 0), dtype=torch.int32, device=prior_features.continuous.device),
        )
    if mesh is not None:
        return parallel.maximize_score_fn_sharded(
            vec_opt, None, parallel.pool_generators(generator, mesh.size, mesh), 1, mesh.size,
            mesh, prior, score_on=lambda device: scorer(
                *parallel.replicate((states, eps, best_label, trust), device)),
        )
    return vec_opt(scorer(states, eps, best_label, trust), generator, count=1,
                   prior_features=prior)


def _sample_generator(rng, device: torch.device) -> torch.Generator:
    """The Predictor's ``rng`` (None, a numpy Generator or a torch Generator
    on ``device``) as a torch Generator on ``device``."""
    if isinstance(rng, torch.Generator):
        return rng
    seed = 0 if rng is None else int(rng.integers(0, 2**31 - 1))
    return _generator(device, seed)


@dataclasses.dataclass
class VizierGPBandit(core_lib.Designer, core_lib.Predictor):
    """GP-UCB/EI designer over flat (non-conditional) search spaces."""

    problem: base_study_config.ProblemStatement
    acquisition: str = "ucb"  # 'ucb' | 'ei' | 'pi' | 'pe' | 'qei'
    ucb_coefficient: float = 1.8
    num_seed_trials: int = 2
    ard_restarts: int = lbfgs_lib.DEFAULT_RANDOM_RESTARTS
    ensemble_size: int = 1
    max_acquisition_evaluations: int = 75_000
    use_trust_region: bool = True
    use_input_warping: bool = False
    padding: Optional[padding_lib.PaddingSchedule] = None
    metric_index: int = 0
    rng_seed: int = 0
    # The ARD optimizer of every train (None: L-BFGS on the designer's
    # device). It rides in the programs' bucket keys.
    ard_optimizer: Optional[lbfgs_lib.Optimizer] = None
    # Carry the previous suggest's trained params into the next train as an
    # extra restart seed, once ``warm_start_min_trials`` trials are in.
    use_warm_start_ard: bool = True
    warm_start_min_trials: int = 20
    # Restart budget of a WARM train (one with trained seed params); None
    # keeps ``ard_restarts``. The service sets 1.
    warm_ard_restarts: Optional[int] = None
    # The sparse-surrogate auto-switch; None keeps the exact GP everywhere.
    surrogate: Optional[surrogate_config_lib.SurrogateConfig] = None
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"
    # The multi-device path: None = a mesh over the host's devices of the
    # designer's type when there is more than one (unless
    # VIZIER_TORCH_DISABLE_MESH is set); True / False force it on / off.
    use_mesh: Optional[bool] = None

    def __post_init__(self):
        self.device = device_lib.resolve(self.device)
        if self.problem.search_space.is_conditional:
            raise ValueError("VizierGPBandit requires a flat search space.")
        if self.problem.search_space.is_empty():
            raise ValueError("Empty search space.")
        self._converter = converters.TrialToModelInputConverter.from_problem(
            self.problem, padding=self.padding
        )
        enc = self._converter.encoder
        self._model = gp_lib.VizierGaussianProcess(
            num_continuous=enc.num_continuous,
            num_categorical=enc.num_categorical,
            use_input_warping=self.use_input_warping,
            device=self.device,
        )
        self._ard = self.ard_optimizer or lbfgs_lib.LbfgsOptimizer(device=self.device)
        # The acquisition optimizer works in the (possibly feature-padded)
        # model space; padded dims are masked out of the kernel and sliced
        # off at decode time.
        pad = self._converter.padding
        self._cont_width = pad.pad_features(enc.num_continuous)
        self._cat_width = pad.pad_features(enc.num_categorical)
        cat_sizes = tuple(enc.category_sizes) + (1,) * (self._cat_width - enc.num_categorical)
        strategy = eagle_lib.VectorizedEagleStrategy(
            num_continuous=self._cont_width, category_sizes=cat_sizes
        )
        self._vec_opt = vectorized_lib.VectorizedOptimizer(
            strategy, max_evaluations=self.max_acquisition_evaluations, device=self.device
        )
        self._warper = output_warpers.create_default_warper()
        self._seeder = quasi_random.QuasiRandomDesigner(
            self.problem.search_space, seed=self.rng_seed
        )
        self._trials: List[trial_.Trial] = []
        # Prior studies' trials for transfer learning, oldest first.
        self._priors: List[List[trial_.Trial]] = []
        self._warper_fitted = False
        # The last single-objective posterior (``predict``/``sample`` read it).
        self._last_predictive = None
        # The study's one source of randomness, on the host: each suggest
        # phase (train, acquisition sweep) seeds its own generator from it.
        self._seed_stream = np.random.default_rng(self.rng_seed)
        # A random placeholder until a train has run; _warm_is_trained
        # says when it holds trained params.
        self._warm_params = self._model.param_collection().random_init_unconstrained(
            _generator(self.device, self.rng_seed + 1)
        )
        self._warm_is_trained = False
        self._ard_train_counts = {"warm": 0, "cold": 0}
        # The auto-switch's sticky mode; a crossover drops the warm seed and
        # the cached posterior (``_refresh_surrogate_mode``).
        self._surrogate_mode = surrogate_config_lib.MODE_EXACT
        self._sparse_model_cache: Optional[sparse_gp.SparseGaussianProcess] = None
        self._last_sparse_state: Optional[sparse_gp.SparseGPState] = None
        self._surrogate_counts = {"sparse_suggests": 0, "crossovers": 0}
        if self.use_mesh is not None:
            want_mesh = self.use_mesh
        else:
            want_mesh = (len(parallel.local_devices(self.device)) > 1
                         and not env_lib.env_on("VIZIER_TORCH_DISABLE_MESH"))
        self._mesh = parallel.create_mesh(device=self.device) if want_mesh else None

    # -- Designer ----------------------------------------------------------

    def update(
        self,
        completed: core_lib.CompletedTrials,
        all_active: core_lib.ActiveTrials = core_lib.ActiveTrials(),
    ) -> None:
        del all_active
        self._trials.extend(completed.trials)

    def _restarts(self, ensemble_size: int) -> int:
        """The next train's random restarts: the warm budget when one applies,
        else ``ard_restarts``, floored at ``ensemble_size``."""
        return max(self._warm_restart_budget() or self.ard_restarts, ensemble_size)

    # -- the mesh ----------------------------------------------------------

    def _mesh_size(self) -> int:
        return self._mesh.size if self._mesh is not None else 1

    def _mesh_restarts(self, restarts: int) -> int:
        """``restarts`` rounded up to a multiple of the mesh size."""
        ndev = self._mesh_size()
        return -(-restarts // ndev) * ndev

    def _train_one(self, model, data, generator: torch.Generator, restarts: int,
                   ensemble_size: int, warm_start: Optional[gp_lib.Params]):
        """One ARD train: the sequential one (``warm_start`` one more row),
        or on the mesh ``parallel.train_gp_sharded`` (restarts rounded up to
        the mesh, ``warm_start`` replacing restart 0)."""
        if self._mesh is None:
            return _train_gp(model, self._ard, data, generator, restarts, ensemble_size,
                             warm_start)
        return parallel.train_gp_sharded(
            model, self._ard, data, generator, self._mesh_restarts(restarts), ensemble_size,
            self._mesh, warm_start,
        )

    def _train_sparse(
        self, data: gp_lib.GPData, ensemble_size: int, warm_start: gp_lib.Params
    ) -> sparse_gp.SparseGPState:
        """Sparse ARD train of one study outside a program, counted as warm
        or cold."""
        states = sparse_bandit._train_sparse_gp(
            self._sparse_model(), self._ard, data, self._phase_generator(),
            self._restarts(ensemble_size), ensemble_size, warm_start,
        )
        self._record_train()
        self._last_sparse_state = states
        return states

    def _next_seed(self) -> np.ndarray:
        """The next phase seed from the study's host seed stream."""
        return self._seed_stream.integers(0, 2**62, dtype=np.int64)

    def _phase_generator(self) -> torch.Generator:
        """A generator on the device for one suggest phase, seeded by
        :meth:`_next_seed`."""
        return _generator(self.device, int(self._next_seed()))

    def _warm_update_allowed(self) -> bool:
        """Whether this train's optimum may seed the next one (floor met)."""
        return self.use_warm_start_ard and len(self._trials) >= self.warm_start_min_trials

    def _warm_restart_budget(self) -> Optional[int]:
        """Restart override for the next train: set only when a trained warm
        seed exists and a reduced warm budget is configured."""
        if self.use_warm_start_ard and self._warm_is_trained and self.warm_ard_restarts is not None:
            return self.warm_ard_restarts
        return None

    def _record_train(self) -> None:
        warm = self.use_warm_start_ard and self._warm_is_trained
        self._ard_train_counts["warm" if warm else "cold"] += 1

    @property
    def ard_train_counts(self) -> dict:
        """Copies of the warm/cold ARD train counters."""
        return dict(self._ard_train_counts)

    def _unconstrained_best(self, states) -> gp_lib.Params:
        """The best ensemble member's params, mapped back through the bijectors."""
        coll = self._model.param_collection()
        return coll.unconstrain({k: v[0] for k, v in states.params.items()})

    # -- warm-start surface ------------------------------------------------

    def warm_start_state(self) -> Optional[gp_lib.Params]:
        """Last trained unconstrained ARD params (None before first train)."""
        return self._warm_params if self._warm_is_trained else None

    def set_warm_start_state(self, params: gp_lib.Params) -> None:
        """Injects trained unconstrained params as the next extra restart."""
        self._warm_params = {k: v.to(self.device) for k, v in params.items()}
        self._warm_is_trained = True

    # -- sparse-surrogate auto-switch --------------------------------------

    @property
    def surrogate_mode(self) -> str:
        """The active surrogate mode ("exact" | "sparse")."""
        return self._surrogate_mode

    @property
    def surrogate_counts(self) -> dict:
        """Copies of the sparse-suggest / crossover counters."""
        return dict(self._surrogate_counts)

    def sparse_inducing_state(self) -> Optional[sparse_gp.SparseGPState]:
        """The last trained sparse posterior; None on the exact path or
        before the first sparse train."""
        return self._last_sparse_state

    def _sparse_model(self) -> sparse_gp.SparseGaussianProcess:
        if self._sparse_model_cache is None:
            # m is padded like a trial count.
            m_pad = self._converter.padding.pad_trials(self.surrogate.num_inducing)
            self._sparse_model_cache = sparse_gp.SparseGaussianProcess(
                base=self._model, num_inducing=m_pad
            )
        return self._sparse_model_cache

    def _refresh_surrogate_mode(self) -> str:
        """Applies the auto-switch for the current trial count.

        A crossover (either direction) re-randomizes the warm seed and drops
        the sparse posterior, so neither surrogate trains from the other's
        optimum: the next train is a full-budget cold train.
        """
        cfg = self.surrogate
        if cfg is None:
            return self._surrogate_mode
        mode = cfg.mode_for(len(self._trials), current=self._surrogate_mode)
        if mode != self._surrogate_mode:
            old_mode = self._surrogate_mode
            self._surrogate_mode = mode
            self._surrogate_counts["crossovers"] += 1
            # Serving-tier observers (speculative pre-compute) invalidate
            # their derived state the moment the flip happens.
            surrogate_config_lib.fire_crossover_hook(self, old_mode, mode)
            self._warm_params = self._model.param_collection().random_init_unconstrained(
                _generator(self.device, self.rng_seed + 1 + self._surrogate_counts["crossovers"])
            )
            self._warm_is_trained = False
            self._last_predictive = None
            self._last_sparse_state = None
        return mode


    # -- encoding ------------------------------------------------------------

    def _padded_features(self, trials: Sequence[trial_.Trial], extra_rows: int = 0) -> tuple:
        """(ModelInput, n_pad); ``extra_rows`` reserves padded capacity."""
        conv = self._converter
        n_pad = conv.padding.pad_trials(len(trials) + extra_rows)
        cont, cat = conv.encoder.encode(trials)
        features = types.ContinuousAndCategorical(
            continuous=types.PaddedArray.from_array(
                cont.astype(np.float32),
                (n_pad, conv.padding.pad_features(conv.encoder.num_continuous)),
            ),
            categorical=types.PaddedArray.from_array(
                cat.astype(np.int32),
                (n_pad, conv.padding.pad_features(conv.encoder.num_categorical)),
                fill_value=0,
            ),
        )
        return features, n_pad

    @staticmethod
    def _padded_labels(warped: np.ndarray, n_pad: int) -> types.PaddedArray:
        return types.PaddedArray.from_array(
            warped[:, None].astype(np.float32), (n_pad, 1), fill_value=np.nan
        )

    def _warped_model_data(self, extra_rows: int = 0) -> types.ModelData:
        """Encode + warp labels + pad. Labels leave here all-MAXIMIZE ~N(0,1)."""
        raw_labels = self._converter.metrics.encode(self._trials)  # [N, M]
        warped = self._warper(raw_labels[:, self.metric_index])
        self._warper_fitted = raw_labels.shape[0] > 0
        features, n_pad = self._padded_features(self._trials, extra_rows)
        return types.ModelData(features=features, labels=self._padded_labels(warped, n_pad))

    def _data_for_trials(self, trials: Sequence[trial_.Trial]) -> gp_lib.GPData:
        """Encodes any trial set (a prior study's) with this designer's
        converter and warper."""
        raw = self._converter.metrics.encode(trials)
        warped = self._warper(raw[:, self.metric_index])
        self._warper_fitted = raw.shape[0] > 0
        features, n_pad = self._padded_features(trials)
        return gp_lib.GPData.from_model_data(
            types.ModelData(features, self._padded_labels(warped, n_pad)), self.device
        )

    def set_priors(self, prior_trials: Sequence[Sequence[trial_.Trial]]) -> None:
        """Registers prior studies' trials for stacked-residual transfer
        learning: one sequence per study, oldest first, over this search
        space."""
        self._priors = [list(p) for p in prior_trials]

    def _num_objectives(self) -> int:
        return sum(1 for m in self.problem.metric_information if not m.is_safety_metric)

    # -- suggest -----------------------------------------------------------

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        if len(self._trials) < self.num_seed_trials:
            return self._seed_suggestions(count)
        if self._num_objectives() > 1:
            return self._suggest_multiobjective(count)
        if self._priors:
            return self._suggest_with_priors(count)
        if self.acquisition == "qei" and count > 1:
            # The sparse posterior has no joint covariance: joint qEI stays
            # exact whatever the auto-switch says.
            self._refresh_surrogate_mode()
            return self._suggest_q_batch(count)
        if self._mesh is not None:
            if self._refresh_surrogate_mode() == surrogate_config_lib.MODE_SPARSE:
                # The JAX package's sparse suggest takes no mesh.
                return compute_registry.get(GPBanditSparseProgram.kind).run_alone(self, count)
            return self._suggest_on_mesh(count)
        # The single-objective suggest (exact or sparse, as the auto-switch
        # says): this study alone through its compute-IR program.
        program, _ = compute_registry.resolve(self, count)
        return program.run_alone(self, count)

    def _train_exact(self, data: gp_lib.GPData) -> gp_lib.GPState:
        """The single-objective exact train outside a program (on the mesh
        when there is one), with its warm seed, counted as warm or cold,
        writing back the next warm seed."""
        states = self._train_one(
            self._model, data, self._phase_generator(), self._restarts(self.ensemble_size),
            self.ensemble_size, self._warm_params,
        )
        self._record_train()
        if self._warm_update_allowed():
            self._warm_params = self._unconstrained_best(states)
            self._warm_is_trained = True
        self._last_predictive = gp_lib.EnsemblePredictive(states)
        return states

    def _suggest_on_mesh(self, count: int) -> List[trial_.TrialSuggestion]:
        """The exact single-objective suggest on the mesh: the sharded train,
        then one pool per device."""
        with profiler.timeit("convert_trials"):
            data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
        with profiler.timeit("train_gp"), device_timing.device_phase(
            _ALONE_PHASES[False][0], self.device
        ):
            states = self._train_exact(data)
            _synchronize(self.device)
        scoring = acquisitions.ScoringFunction(
            predictive=gp_lib.EnsemblePredictive(states),
            acquisition=self._make_acquisition(),
            best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
            trust_region=acquisitions.TrustRegion.from_data(data) if self.use_trust_region else None,
        )
        size = self._mesh.size
        with profiler.timeit("acquisition_optimizer"), device_timing.device_phase(
            _ALONE_PHASES[False][1], self.device
        ):
            # One pool per device, their generators from the next phase seed.
            result = parallel.maximize_acquisition_sharded(
                self._vec_opt, scoring,
                parallel.pool_generators(self._next_seed(), size, self._mesh), count, size,
                self._mesh, _prior_features_from_data(data),
            )
            _synchronize(self.device)
        with profiler.timeit("best_candidates_to_trials"):
            return self._decode_result(result, count, kind=self.acquisition)

    def _suggest_q_batch(self, count: int) -> List[trial_.TrialSuggestion]:
        """Joint qEI: the ``count`` suggestions are one point of the
        (count·Dc)-space, searched under the exact ensemble's joint posterior."""
        if self._converter.encoder.num_categorical:
            raise ValueError(
                "acquisition='qei' joint batches support continuous spaces only; use "
                "VizierGPUCBPEBandit for batch suggestions on mixed spaces."
            )
        with profiler.timeit("convert_trials"):
            data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
        with profiler.timeit("train_gp"):
            states = self._train_exact(data)
        vec_opt = vectorized_lib.VectorizedOptimizer(
            eagle_lib.VectorizedEagleStrategy(
                num_continuous=self._cont_width * count, category_sizes=()),
            max_evaluations=self.max_acquisition_evaluations, device=self.device,
        )
        result = _maximize_q_batch(
            vec_opt, states, acquisitions.get_best_labels(data.labels, data.row_mask),
            acquisitions.TrustRegion.from_data(data) if self.use_trust_region else None,
            self._phase_generator(), count, _QEI_SAMPLES, _prior_features_from_data(data),
            mesh=self._mesh,
        )
        rows = result.features.continuous[0].reshape(count, self._cont_width)
        unrolled = vectorized_lib.VectorizedOptimizerResult(
            kernels.MixedFeatures(rows, torch.zeros((count, 0), dtype=torch.int32,
                                                    device=rows.device)),
            result.scores[0].expand(count),
        )
        return self._decode_result(unrolled, count, kind="qei_joint")

    def _suggest_with_priors(self, count: int) -> List[trial_.TrialSuggestion]:
        """Transfer learning: a stacked-residual GP over the prior studies and
        this one (always a cold train), then the acquisition sweep over it."""
        with profiler.timeit("convert_trials"):
            datasets = [self._data_for_trials(p) for p in self._priors]
            data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
            datasets.append(data)
        with profiler.timeit("train_gp"):
            stack = stacked_residual.train_stacked_residual_gp(
                self._model, self._ard, datasets, self._phase_generator(),
                num_restarts=self.ard_restarts,
            )
        self._ard_train_counts["cold"] += 1
        self._last_predictive = stack
        scoring = acquisitions.ScoringFunction(
            predictive=stack,
            acquisition=self._make_acquisition(),
            best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
            trust_region=acquisitions.TrustRegion.from_data(data) if self.use_trust_region else None,
        )
        with profiler.timeit("acquisition_optimizer"):
            result = self._vec_opt(
                scoring.score, self._phase_generator(), count=count,
                prior_features=_prior_features_from_data(data),
            )
            _synchronize(self.device)
        with profiler.timeit("best_candidates_to_trials"):
            return self._decode_result(result, count, kind=f"{self.acquisition}+priors")

    def _suggest_multiobjective(self, count: int) -> List[trial_.TrialSuggestion]:
        """Random-hypervolume scalarized UCB over per-metric GPs, with each
        metric's reference point at nadir − 0.1·range of its warped labels."""
        raw = self._converter.metrics.encode(self._trials)  # [N, M] all-MAXIMIZE
        features, n_pad = self._padded_features(self._trials)
        datas, refs = [], []
        for j, info in enumerate(self.problem.metric_information):
            if info.is_safety_metric:
                continue
            warped = self._warper(raw[:, j])
            datas.append(gp_lib.GPData.from_model_data(
                types.ModelData(features, self._padded_labels(warped, n_pad)), self.device
            ))
            labels = torch.as_tensor(warped.astype(np.float32), device=self.device)
            refs.append(acquisitions.get_reference_point(
                labels, torch.ones(labels.shape, dtype=torch.bool, device=self.device)
            ))
        with profiler.timeit("train_gp"):
            states = _train_gp_per_metric(
                self._model, self._ard, datas, self._phase_generator(), self.ard_restarts
            )
        acquisition_generator = self._phase_generator()
        # Cold by definition: GP-UCB-PE owns the warm multi-objective path.
        self._ard_train_counts["cold"] += 1
        scoring = acquisitions.HVScalarizedScoring(
            metric_states=states,
            directions=pareto_ops.draw_directions(acquisition_generator, 64, len(datas)),
            reference_point=torch.stack(refs),
            ucb_coefficient=self.ucb_coefficient,
            trust_region=(
                acquisitions.TrustRegion.from_data(datas[0]) if self.use_trust_region else None
            ),
        )
        with profiler.timeit("acquisition_optimizer"):
            result = self._vec_opt(
                scoring.score, acquisition_generator, count=count,
                prior_features=_prior_features_from_data(datas[0]),
            )
            _synchronize(self.device)
        with profiler.timeit("best_candidates_to_trials"):
            return self._decode_result(result, count, kind="hv_scalarized_ucb")

    def _decode_result(
        self, result: vectorized_lib.VectorizedOptimizerResult, count: int, *, kind: str
    ) -> List[trial_.TrialSuggestion]:
        enc = self._converter.encoder
        cont = result.features.continuous[:count].cpu().numpy()
        cat = result.features.categorical[:count].cpu().numpy()
        scores = result.scores[:count].cpu().numpy()
        suggestions = []
        for row_cont, row_cat, score in zip(cont, cat, scores):
            params = self._converter.to_parameters(
                row_cont[None, : enc.num_continuous], row_cat[None, : enc.num_categorical]
            )[0]
            s = trial_.TrialSuggestion(parameters=params)
            s.metadata.ns("gp_bandit")["acquisition"] = float(score)
            s.metadata.ns("gp_bandit")["acquisition_kind"] = kind
            suggestions.append(s)
        return suggestions

    # -- pieces ------------------------------------------------------------

    def _make_acquisition(self) -> acquisitions.Acquisition:
        if self.acquisition == "ucb":
            return acquisitions.UCB(self.ucb_coefficient)
        if self.acquisition in ("ei", "qei"):  # qei is EI at count 1
            return acquisitions.EI()
        if self.acquisition == "pi":
            return acquisitions.PI()
        if self.acquisition == "pe":
            return acquisitions.PE()
        raise ValueError(f"Unknown acquisition {self.acquisition!r}.")

    def _seed_suggestions(self, count: int) -> List[trial_.TrialSuggestion]:
        out: List[trial_.TrialSuggestion] = []
        if not self._trials:
            out.append(designer_policy.default_suggestion(self.problem))
        while len(out) < count:
            out.extend(self._seeder.suggest(count - len(out)))
        return out[:count]

    # -- Predictor -----------------------------------------------------------

    def sample(
        self, suggestions: Sequence[trial_.TrialSuggestion], rng=None, num_samples: int = 1000,
    ) -> np.ndarray:
        """Posterior samples [num_samples, T] in the metric's own scale.

        Drawn in the warped space the GP was trained in, then unwarped and
        sign-restored (``metrics.decode_column``); before the warper has seen
        a label they come back warped. ``rng`` is None, a numpy Generator or
        a torch Generator on the designer's device.
        """
        if not suggestions:
            return np.zeros((num_samples, 0))
        eps = torch.randn((num_samples, len(suggestions)),
                          generator=_sample_generator(rng, self.device), device=self.device)
        return self._samples_from_draws(suggestions, eps)

    def _samples_from_draws(
        self, suggestions: Sequence[trial_.TrialSuggestion], eps: Tensor
    ) -> np.ndarray:
        """:meth:`sample` from given standard normals ``eps`` [num_samples, T]."""
        mean, stddev = self._require_predictive().predict(self._encode_suggestions(suggestions))
        warped = (mean[None] + stddev[None] * eps.to(mean.device)).cpu().numpy()
        if not self._warper_fitted:
            return warped
        out = self._warper.unwarp(warped.reshape(-1, 1)).reshape(warped.shape)
        return self._converter.metrics.decode_column(out, self.metric_index)

    def predict(
        self, suggestions: Sequence[trial_.TrialSuggestion], rng=None,
        num_samples: Optional[int] = None,
    ) -> core_lib.Prediction:
        """Mean and stddev of :meth:`sample`'s unwarped samples."""
        samples = self.sample(suggestions, rng=rng, num_samples=num_samples or 1000)
        return core_lib.Prediction(mean=np.mean(samples, axis=0), stddev=np.std(samples, axis=0))

    def _require_predictive(self):
        """The last suggest's posterior, or a cold exact train when there is none."""
        if self._last_predictive is None:
            if len(self._trials) < max(self.num_seed_trials, 1):
                raise ValueError("Not enough completed trials to predict.")
            data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
            states = _train_gp(
                self._model, self._ard, data, self._phase_generator(),
                max(self.ard_restarts, self.ensemble_size), self.ensemble_size,
            )
            self._last_predictive = gp_lib.EnsemblePredictive(states)
        return self._last_predictive

    def _encode_suggestions(
        self, suggestions: Sequence[trial_.TrialSuggestion]
    ) -> kernels.MixedFeatures:
        """Suggestions as model features, padded to the model's widths."""
        trials = [s.to_trial(i + 1) for i, s in enumerate(suggestions)]
        cont, cat = self._converter.encoder.encode(trials)
        n = len(trials)
        cont_p = np.zeros((n, self._cont_width), dtype=np.float32)
        cont_p[:, : cont.shape[1]] = cont
        cat_p = np.zeros((n, self._cat_width), dtype=np.int32)
        cat_p[:, : cat.shape[1]] = cat
        return kernels.MixedFeatures(
            torch.as_tensor(cont_p, device=self.device), torch.as_tensor(cat_p, device=self.device))


# -- compute-IR programs (vizier_tpu_torch.compute) ---------------------------
#
# The batched compute of the GP-bandit family: one program per surrogate
# (exact | sparse). A flush stacks its studies' host data along a leading
# study axis and runs their trains and sweeps as one batch; the sequential
# single-objective suggest is the same program over one study.


def default_factory(
    problem: base_study_config.ProblemStatement, seed: Optional[int] = None, **kwargs
) -> VizierGPBandit:
    return VizierGPBandit(problem, rng_seed=seed or 0, **kwargs)


def _gp_bandit_unbatchable(designer: "VizierGPBandit", count: int) -> bool:
    """Paths the programs do not cover (seeding, multi-objective, transfer
    priors, joint qEI, a mesh designer): those run the sequential suggest's
    own code."""
    return bool(
        designer._mesh is not None
        or len(designer._trials) < designer.num_seed_trials
        or designer._num_objectives() > 1
        or designer._priors
        or (designer.acquisition == "qei" and count > 1)
    )


def _gp_bandit_prepare(designer: "VizierGPBandit", count: int, sparse: bool) -> dict:
    """Host-side half of a suggest: encode + warp + the phase seeds (train,
    then acquisition), in the sequential order. Issues no device work."""
    with profiler.timeit("convert_trials"):
        md = designer._warped_model_data()
    return dict(
        designer=designer,
        count=count,
        md=md,
        seed_train=designer._next_seed(),
        seed_acq=designer._next_seed(),
        warm=designer._warm_params,
        restarts=designer._restarts(designer.ensemble_size),
        sparse=sparse,
    )


# A study's sequential suggest times its train and its sweep as these device
# phases (exact, sparse), as the JAX package's does; a batched flush is one
# phase, its program's ``device_phase``.
_ALONE_PHASES = {
    False: ("gp_bandit.train_gp", "gp_bandit.acquisition"),
    True: ("sparse_gp.train", "sparse_gp.acquisition"),
}


def _stacked_chunks(items: Sequence[dict], names: Sequence[str], pad_to: Optional[int],
                    placement) -> List[tuple]:
    """The items' ``names`` stacked along a study axis (padded to ``pad_to``)
    as (inputs, device) chunks: one on the designer's device, or one per
    device of a mesh ``placement`` (``batch_executor.place_batch``)."""
    inputs = {n: batch_executor.stack_pytrees([it[n] for it in items], pad_to) for n in names}
    devices = placement.devices if placement is not None else (items[0]["designer"].device,)
    return list(zip(batch_executor.place_batch(inputs, placement), devices))


def _gp_bandit_flush(
    items: Sequence[dict], pad_to: Optional[int], sparse: bool, alone: bool = False,
    placement=None,
) -> List[dict]:
    """Encode → multi-restart ARD → acquisition sweep → warm seeds for every
    study of the flush as one batch, then ONE device-to-host copy of the
    sweep results. Each slot's state stays on the device as views. ``alone``:
    one study's sequential suggest, timed per stage. On a mesh ``placement``
    the padded study axis is split over its devices, one batch per device."""
    outputs: List[dict] = []
    for inputs, device in _stacked_chunks(
        items, ("md", "seed_train", "seed_acq", "warm"), pad_to, placement
    ):
        outputs += _gp_bandit_chunk(items[0], inputs, device, sparse, alone)
    return outputs[: len(items)]


def _gp_bandit_chunk(item0: dict, inputs: dict, device: torch.device, sparse: bool,
                     alone: bool) -> List[dict]:
    """:func:`_gp_bandit_flush` of one device's stacked ``inputs``."""
    d0: VizierGPBandit = item0["designer"]
    ard, vec_opt = parallel.replicate((d0._ard, d0._vec_opt), device)
    train_phase, acquisition_phase = _ALONE_PHASES[sparse] if alone else (None, None)
    with profiler.timeit("train_gp"), device_timing.device_phase(train_phase, device):
        data = gp_lib.GPData.from_model_data(inputs["md"], device)
        studies = data.num_studies
        train_args = (
            ard, data, _generators(device, inputs["seed_train"]), item0["restarts"],
            d0.ensemble_size, inputs["warm"],
        )
        if sparse:
            model = parallel.replicate(d0._sparse_model(), device)
            states = sparse_bandit._train_sparse_gp_studies(model, *train_args)
        else:
            model = parallel.replicate(d0._model, device)
            states = _train_gp_studies(model, *train_args)
        warm_next = _warm_next_batched(model, states, studies)
        _synchronize(device)
    with profiler.timeit("acquisition_optimizer"), device_timing.device_phase(
        acquisition_phase, device
    ):
        result = _sweep_studies(
            vec_opt, d0._make_acquisition(), states, data,
            _generators(device, inputs["seed_acq"]), item0["count"], d0.use_trust_region,
        )
        result = batch_executor.to_host(result)
    return [
        dict(
            states=_slot_state(states, i, studies),
            warm_next=batch_executor.slice_pytree(warm_next, i),
            result=batch_executor.slice_pytree(result, i),
            sparse=sparse,
        )
        for i in range(studies)
    ]


def _gp_bandit_finalize(designer: "VizierGPBandit", item: dict, output: dict) -> list:
    """The sequential suggest's state transitions (train count, warm seed,
    sparse posterior and counter), then the decode."""
    designer._record_train()
    if designer._warm_update_allowed():
        designer._warm_params = output["warm_next"]
        designer._warm_is_trained = True
    designer._last_predictive = gp_lib.EnsemblePredictive(output["states"])
    kind = designer.acquisition
    if output["sparse"]:
        designer._last_sparse_state = output["states"]
        designer._surrogate_counts["sparse_suggests"] += 1
        kind = f"{kind}+sparse"
    with profiler.timeit("best_candidates_to_trials"):
        return designer._decode_result(output["result"], item["count"], kind=kind)


class GPBanditProgram(compute_ir.DesignerProgram):
    """Exact-GP single-objective flush: encode → multi-restart ARD → UCB/EI/PI/PE
    sweep, the studies of a bucket as one batch."""

    kind = "gp_bandit"
    device_phase = "gp_bandit.suggest_batched"
    shardable_batch_axis = "study"
    algorithms = ("GAUSSIAN_PROCESS_BANDIT",)
    sparse = False

    def bucket_key(self, designer, count):
        if _gp_bandit_unbatchable(designer, count):
            return None
        is_sparse = designer._refresh_surrogate_mode() == surrogate_config_lib.MODE_SPARSE
        if is_sparse != self.sparse:
            return None  # the other surrogate's program owns this study
        return compute_ir.BucketKey(
            kind=self.kind,
            pad_trials=designer._converter.padding.pad_trials(len(designer._trials)),
            cont_width=designer._cont_width,
            cat_width=designer._cat_width,
            metric_count=1,
            count=count,
            statics=(
                designer._sparse_model() if self.sparse else designer._model,
                designer._ard,
                designer._vec_opt,
                designer._restarts(designer.ensemble_size),
                designer.ensemble_size,
                designer._make_acquisition(),
                designer.use_trust_region,
            ),
        )

    def prepare(self, designer, count):
        return _gp_bandit_prepare(designer, count, sparse=self.sparse)

    def device_program(self, items, pad_to=None, placement=None):
        """The bucket's studies as one batch; on a mesh ``placement`` the
        padded study axis is split over its devices."""
        with device_timing.device_phase(self.device_phase, items[0]["designer"].device):
            return _gp_bandit_flush(items, pad_to, sparse=self.sparse, placement=placement)

    def finalize(self, designer, item, output):
        return _gp_bandit_finalize(designer, item, output)

    def run_alone(self, designer, count):
        item = self.prepare(designer, count)
        (output,) = _gp_bandit_flush([item], None, sparse=self.sparse, alone=True)
        return self.finalize(designer, item, output)

    def prewarm_factory(self, problem, **kwargs):
        # The walker's synthetic studies reach this program exactly when the
        # factory's surrogate config makes them sparse, as live studies do.
        return VizierGPBandit(problem, **kwargs)


class GPBanditSparseProgram(GPBanditProgram):
    """The sparse (SGPR) twin: the same stages over the collapsed-bound
    posterior, its own bucket family (the inducing-slot count rides in the
    statics)."""

    kind = "gp_bandit_sparse"
    device_phase = "sparse_gp.suggest_batched"
    shardable_batch_axis = "study"
    sparse = True


compute_registry.register(VizierGPBandit, GPBanditProgram())
compute_registry.register(VizierGPBandit, GPBanditSparseProgram())
