"""VizierGPBandit: the GP Bayesian-optimization designer.

Counterpart of the JAX package's ``designers/gp_bandit.py:284``:

- quasi-random (+default-point) seeding for the first trials;
- output warping (half-rank → z-score → infeasible imputation);
- ARD via multi-restart L-BFGS, restarts batched on the device, with the
  previous suggest's optimum prepended as one more restart;
- hyperparameter ensembles (top-k restarts) combined as a uniform mixture;
- UCB/EI/PE acquisition with an L∞ trust region, maximized by the
  vectorized Eagle strategy;
- the sparse-surrogate auto-switch (``surrogate``): from the config's trial
  threshold up, with hysteresis, the single-objective suggest trains the SGPR
  inducing-point posterior (``surrogates.sparse_bandit``) instead of the
  exact GP; ``warm_ard_restarts`` cuts a warm-started train's restart budget;
- multi-objective studies: one cold-trained GP per objective and UCB
  hypervolume-scalarized along 64 random directions
  (``acquisitions.HVScalarizedScoring``).

Transfer priors, joint q-batches, mesh sharding and cross-study batching are
served by the JAX package only; see ROADMAP.md for their place in the port's
queue.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import types
from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.algorithms import designer_policy
from vizier_tpu_torch.converters import core as converters
from vizier_tpu_torch.converters import padding as padding_lib
from vizier_tpu_torch.designers import quasi_random
from vizier_tpu_torch.designers.gp import acquisitions
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import output_warpers
from vizier_tpu_torch.ops import pareto as pareto_ops
from vizier_tpu_torch.optimizers import eagle as eagle_lib
from vizier_tpu_torch.optimizers import lbfgs as lbfgs_lib
from vizier_tpu_torch.optimizers import vectorized as vectorized_lib
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_
from vizier_tpu_torch.surrogates import config as surrogate_config_lib
from vizier_tpu_torch.surrogates import sparse_bandit
from vizier_tpu_torch.surrogates import sparse_gp

Tensor = torch.Tensor


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _train_gp(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.LbfgsOptimizer,
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
        lambda p: model.neg_log_likelihood(p, data), inits, best_n=ensemble_size
    )
    return model.precompute(result.params, data)


def _train_gp_per_metric(
    model: gp_lib.VizierGaussianProcess,
    optimizer: lbfgs_lib.LbfgsOptimizer,
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


@dataclasses.dataclass
class VizierGPBandit(core_lib.Designer):
    """GP-UCB/EI designer over flat (non-conditional) search spaces."""

    problem: base_study_config.ProblemStatement
    acquisition: str = "ucb"  # 'ucb' | 'ei' | 'pe'
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
        self._ard = lbfgs_lib.LbfgsOptimizer(device=self.device)
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
        self._generator = _generator(self.device, self.rng_seed)
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

    def _train(
        self, data: gp_lib.GPData, ensemble_size: int, warm_start: gp_lib.Params
    ) -> gp_lib.GPState:
        """Exact ARD train, counted as warm or cold."""
        states = _train_gp(
            self._model, self._ard, data, self._generator, self._restarts(ensemble_size),
            ensemble_size, warm_start,
        )
        self._record_train()
        return states

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
            self._surrogate_mode = mode
            self._surrogate_counts["crossovers"] += 1
            self._warm_params = self._model.param_collection().random_init_unconstrained(
                _generator(self.device, self.rng_seed + 1 + self._surrogate_counts["crossovers"])
            )
            self._warm_is_trained = False
            self._last_sparse_state = None
        return mode

    def _train_sparse(
        self, data: gp_lib.GPData, ensemble_size: int, warm_start: gp_lib.Params
    ) -> sparse_gp.SparseGPState:
        """Sparse ARD train, counted as warm or cold."""
        states = sparse_bandit._train_sparse_gp(
            self._sparse_model(), self._ard, data, self._generator,
            self._restarts(ensemble_size), ensemble_size, warm_start,
        )
        self._record_train()
        self._last_sparse_state = states
        return states

    def _suggest_sparse(self, count: int) -> List[trial_.TrialSuggestion]:
        """The sparse twin of the single-objective suggest: collapsed-bound
        train, then the same acquisition sweep over the sparse posterior."""
        data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
        states = self._train_sparse(data, self.ensemble_size, self._warm_params)
        if self._warm_update_allowed():
            self._warm_params = self._unconstrained_best(states)
            self._warm_is_trained = True
        result = sparse_bandit._sweep_one(
            self._vec_opt, self._make_acquisition(), states, data, self._generator, count,
            self.use_trust_region,
        )
        self._surrogate_counts["sparse_suggests"] += 1
        return self._decode_result(result, count, kind=f"{self.acquisition}+sparse")

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
        features, n_pad = self._padded_features(self._trials, extra_rows)
        return types.ModelData(features=features, labels=self._padded_labels(warped, n_pad))

    def _num_objectives(self) -> int:
        return sum(1 for m in self.problem.metric_information if not m.is_safety_metric)

    # -- suggest -----------------------------------------------------------

    def suggest(self, count: Optional[int] = None) -> List[trial_.TrialSuggestion]:
        count = count or 1
        if len(self._trials) < self.num_seed_trials:
            return self._seed_suggestions(count)
        if self._num_objectives() > 1:
            return self._suggest_multiobjective(count)
        if self._refresh_surrogate_mode() == surrogate_config_lib.MODE_SPARSE:
            return self._suggest_sparse(count)
        data = gp_lib.GPData.from_model_data(self._warped_model_data(), self.device)
        states = self._train(data, self.ensemble_size, self._warm_params)
        if self._warm_update_allowed():
            self._warm_params = self._unconstrained_best(states)
            self._warm_is_trained = True
        scoring = acquisitions.ScoringFunction(
            predictive=gp_lib.EnsemblePredictive(states),
            acquisition=self._make_acquisition(),
            best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
            trust_region=acquisitions.TrustRegion.from_data(data) if self.use_trust_region else None,
        )
        result = self._vec_opt(
            scoring.score, self._generator, count=count,
            prior_features=_prior_features_from_data(data),
        )
        return self._decode_result(result, count, kind=self.acquisition)

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
        states = _train_gp_per_metric(
            self._model, self._ard, datas, self._generator, self.ard_restarts
        )
        # Cold by definition: GP-UCB-PE owns the warm multi-objective path.
        self._ard_train_counts["cold"] += 1
        scoring = acquisitions.HVScalarizedScoring(
            metric_states=states,
            directions=pareto_ops.draw_directions(self._generator, 64, len(datas)),
            reference_point=torch.stack(refs),
            ucb_coefficient=self.ucb_coefficient,
            trust_region=(
                acquisitions.TrustRegion.from_data(datas[0]) if self.use_trust_region else None
            ),
        )
        result = self._vec_opt(
            scoring.score, self._generator, count=count,
            prior_features=_prior_features_from_data(datas[0]),
        )
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
        if self.acquisition == "ei":
            return acquisitions.EI()
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
