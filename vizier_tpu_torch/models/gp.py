"""The Vizier Gaussian process: masked training, prediction, ensembles.

Counterpart of the JAX package's ``models/gp.py``: an ARD Matern-5/2 GP over mixed
continuous/categorical features, float32 throughout with a noise floor and
jitter. Padded rows are decoupled (off-diagonal zeroed, unit diagonal, zero
residual), so fill values never reach the factorization.

Where the JAX package ``vmap``s over restarts and ensemble members, every
function here takes parameters with a leading batch axis ``B`` and shares
one ``GPData`` across it; the Gram comes from the batched kernel
(``kernels.matern52_ard``) and the factorizations from batched
``torch.linalg`` calls. A cross-study flush stacks S studies' ``GPData``
along a leading study axis (``GPData.num_studies``); the batch is then S
groups of ``B / S`` members, each group over its own study's data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch import types
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.models import params as params_lib

Tensor = torch.Tensor
Params = params_lib.Params

_LOG_2PI = 1.8378770664093453
_JITTER = 1e-5


def rows_per_member(t: Tensor, batch: int) -> Tensor:
    """A data row vector (labels or row mask) for each of ``batch`` members:
    [N] shared by all, or [S, N] for S groups of ``batch / S`` members."""
    if t.dim() == 1:
        return t.expand(batch, -1)
    return kernels.per_member(t, t.shape[0], batch, 1)


def matvec(a: Tensor, v: Tensor) -> Tensor:
    """[..., M, N] times [..., N] -> [..., M] as an elementwise product and a
    reduction along N: every member's result is the same floats whatever the
    batch holds (a batched matrix-vector ``matmul`` on the CPU rounds a
    member differently in a batch of one than in a larger batch), so a study
    computes the same posterior alone and in a flush."""
    return torch.sum(a * v[..., None, :], dim=-1)


# Calls of posterior_cholesky that refactored members in float64, and the
# members refactored.
FLOAT64_REFACTORS: Dict[str, int] = {"calls": 0, "members": 0}


def posterior_cholesky(gram: Tensor) -> Tensor:
    """[B, N, N] float32 Cholesky factors of a posterior's Grams.

    A Gram within float32 rounding of singular (noiseless labels with the
    noise at its floor, near-duplicate rows: condition numbers past 1e8)
    can fail the float32 factorization (``info`` > 0) where it is positive
    definite in exact arithmetic; the reference's factor is then NaN, and
    every prediction from it. Those members alone are factored again in
    float64 and rounded back to float32, so the posterior stays finite. A
    factorization that float32 completes is used as it is.
    """
    chol, info = torch.linalg.cholesky_ex(gram)
    failed = info != 0
    if bool(torch.any(failed)):
        FLOAT64_REFACTORS["calls"] += 1
        FLOAT64_REFACTORS["members"] += int(failed.sum())
        redo = torch.linalg.cholesky_ex(gram[failed].to(torch.float64))[0]
        chol = chol.index_put((torch.nonzero(failed)[:, 0],), redo.to(chol.dtype))
    return chol


@dataclasses.dataclass(frozen=True)
class GPData:
    """Training data as tensors, with validity masks."""

    continuous: Tensor  # [N, Dc] float32 in [0, 1]
    categorical: Tensor  # [N, Ds] int32
    labels: Tensor  # [N] float32 (warped; zero on invalid rows)
    row_mask: Tensor  # [N] bool, True = real data
    cont_dim_mask: Tensor  # [Dc] bool
    cat_dim_mask: Tensor  # [Ds] bool
    # A flush's data has a leading study axis on every field ([S, N, Dc], ...).

    @classmethod
    def from_model_data(
        cls, data: types.ModelData, device: torch.device, metric_index: int = 0
    ) -> "GPData":
        """From host model data, or from S studies' stacked model data
        (``batch_executor.stack_pytrees``), which gives a study axis."""
        data = data.to(device)
        cont = data.features.continuous
        cat = data.features.categorical
        labels = data.labels.padded_array[..., metric_index]
        row_mask = cont.valid_mask(0) & data.labels.valid_mask(0) & ~torch.isnan(labels)
        return cls(
            continuous=cont.padded_array.to(torch.float32),
            categorical=cat.padded_array.to(torch.int32),
            labels=torch.where(
                row_mask, torch.nan_to_num(labels), torch.zeros_like(labels)
            ).to(torch.float32),
            row_mask=row_mask,
            cont_dim_mask=cont.valid_mask(1),
            cat_dim_mask=cat.valid_mask(1),
        )

    @property
    def num_rows(self) -> int:
        return self.continuous.shape[-2]

    @property
    def num_studies(self) -> int:
        """S of a flush's stacked data; 1 for one study's data."""
        return self.continuous.shape[0] if self.continuous.dim() == 3 else 1

    @property
    def device(self) -> torch.device:
        return self.continuous.device

    def features(self) -> kernels.MixedFeatures:
        return kernels.MixedFeatures(self.continuous, self.categorical)


@dataclasses.dataclass(frozen=True)
class VizierGaussianProcess:
    """Static model config + pure functions over (batched params, data)."""

    num_continuous: int
    num_categorical: int
    # Declares a ``mean_scale`` hyperparameter (trained and regularized) that
    # no mean reads: the JAX package's model does the same, and the port
    # keeps its NLL and init draws equal to it.
    use_linear_mean: bool = False
    # HEBO-style learnable Kumaraswamy input warping of the [0,1] continuous
    # features: u -> 1-(1-u^a)^b with per-dimension a, b.
    use_input_warping: bool = False
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", device_lib.resolve(self.device))

    # -- hyperparameter declaration ---------------------------------------

    def param_collection(self) -> params_lib.ParameterCollection:
        sc = params_lib.SoftClip
        spec = params_lib.ParameterSpec
        specs = [
            spec("amplitude", (), sc(0.01, 100.0), 0.1, 10.0, prior_mu=0.0, prior_sigma=1.0),
            spec(
                "noise_stddev", (), sc(1e-3, 1.0), 5e-3, 0.3,
                prior_mu=float(np.log(1e-2)), prior_sigma=1.0,
            ),
        ]
        if self.num_continuous:
            specs.append(
                spec(
                    "continuous_length_scales", (self.num_continuous,), sc(0.005, 100.0),
                    0.05, 2.0, prior_mu=float(np.log(0.3)), prior_sigma=1.0,
                )
            )
        if self.num_categorical:
            # Weak prior centered at ls ~ 0.71 (the reference's categorical
            # regularizer); a tight one zeroes all cross-category correlation.
            specs.append(
                spec(
                    "categorical_length_scales", (self.num_categorical,), sc(0.05, 100.0),
                    0.1, 10.0, prior_mu=float(np.log(np.sqrt(0.5))), prior_sigma=3.5,
                )
            )
        if self.use_input_warping and self.num_continuous:
            for name in ("warp_a", "warp_b"):
                specs.append(
                    spec(
                        name, (self.num_continuous,), sc(0.25, 4.0), 0.8, 1.25,
                        prior_mu=0.0, prior_sigma=0.5,
                    )
                )
        if self.use_linear_mean and self.num_continuous:
            specs.append(spec("mean_scale", (), sc(1e-3, 10.0), 0.1, 1.0, prior_mu=0.0))
        return params_lib.ParameterCollection(tuple(specs))

    # -- kernel ------------------------------------------------------------

    def _warp_features(self, p: Params, f: kernels.MixedFeatures) -> kernels.MixedFeatures:
        if not (self.use_input_warping and self.num_continuous):
            return f
        u = torch.clamp(f.continuous, 1e-6, 1.0 - 1e-6)
        a, b = p["warp_a"][:, None, :], p["warp_b"][:, None, :]
        return kernels.MixedFeatures(1.0 - (1.0 - u ** a) ** b, f.categorical)

    def _kernel(
        self, p: Params, f1: kernels.MixedFeatures, f2: kernels.MixedFeatures, data: GPData,
        **masks: Tensor,
    ) -> Tensor:
        """[B, N, M] kernel; ``masks`` are ``matern52_ard``'s row masks and diagonal."""
        batch = p["amplitude"].shape[0]
        ones = lambda n: torch.ones((batch, n), device=data.device)  # noqa: E731
        cont_ls = p.get("continuous_length_scales", ones(self.num_continuous))
        cat_ls = p.get("categorical_length_scales", ones(self.num_categorical))
        dim_masks = (data.cont_dim_mask, data.cat_dim_mask)
        if self.use_input_warping and self.num_continuous and data.num_studies > 1:
            # Warped features are per member: give every input one block per
            # member, so the groups stay consistent.
            s = data.num_studies

            def member(t: Tensor, base_dim: int) -> Tensor:
                return kernels.per_member(t, s, batch, base_dim)

            same = f2 is f1
            f1 = kernels.MixedFeatures(member(f1.continuous, 2), member(f1.categorical, 2))
            f2 = f1 if same else kernels.MixedFeatures(
                member(f2.continuous, 2), member(f2.categorical, 2))
            masks = {k: (v if k == "diag" else member(v, 1)) for k, v in masks.items()}
            dim_masks = tuple(member(m, 1) for m in dim_masks)
        w1 = self._warp_features(p, f1)
        # The Gram passes one feature set twice: keep it one tensor, so the
        # kernels see the symmetric case.
        w2 = w1 if f2 is f1 else self._warp_features(p, f2)
        return kernels.matern52_ard(
            w1,
            w2,
            amplitude=p["amplitude"],
            continuous_length_scales=cont_ls,
            categorical_length_scales=cat_ls,
            continuous_dim_mask=dim_masks[0],
            categorical_dim_mask=dim_masks[1],
            **masks,
        )

    # -- likelihood --------------------------------------------------------

    def _masked_gram(self, p: Params, data: GPData) -> Tensor:
        """[B, N, N]: K + (noise²+jitter)·I on valid rows; identity on padded rows.

        The masks and the diagonal are the kernel's epilogue (K1's Gram mode
        on the card, ``kernels.apply_masks`` in the plain version).
        """
        noise = p["noise_stddev"] * p["noise_stddev"] + _JITTER  # [B]
        f = data.features()
        return self._kernel(
            p, f, f, data, row_mask1=data.row_mask, row_mask2=data.row_mask, diag=noise
        )

    def neg_log_likelihood(self, unconstrained: Params, data: GPData) -> Tensor:
        """[B] ARD losses: -log p(y | X, θ) + log-normal regularization."""
        device_lib.check(data.continuous, self.device, "GP data")
        coll = self.param_collection()
        p = coll.constrain(unconstrained)
        gram = self._masked_gram(p, data)
        chol, info = torch.linalg.cholesky_ex(gram)
        y = rows_per_member(data.labels, gram.shape[0])
        mask = rows_per_member(data.row_mask, gram.shape[0])
        if chol.is_cuda and torch.cuda.is_current_stream_capturing():
            # Batched cholesky_solve runs MAGMA on CUDA, which cannot be
            # captured into a CUDA graph (``optimizers/graphs.py``): the same
            # solve as two triangular solves.
            lower = torch.linalg.solve_triangular(chol, y[..., None], upper=False)
            alpha = torch.linalg.solve_triangular(chol.mT, lower, upper=True)[..., 0]
        else:
            alpha = torch.cholesky_solve(y[..., None], chol)[..., 0]
        n_valid = torch.sum(mask.to(torch.float32), dim=-1)
        # Padded rows: y = 0 and unit diag ⇒ zero contribution to each term.
        data_fit = 0.5 * torch.sum(y * alpha, dim=-1)
        log_diag = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
        log_det = torch.sum(torch.where(mask, log_diag, torch.zeros_like(log_diag)), -1)
        loss = data_fit + log_det + 0.5 * n_valid * _LOG_2PI + coll.regularization(p)
        # Guard non-finite losses and failed factorizations (the reference's
        # Cholesky returns NaN where torch reports info > 0).
        ok = torch.isfinite(loss) & (info == 0)
        return torch.where(ok, loss, torch.full_like(loss, 1e10))

    # -- predictive --------------------------------------------------------

    def precompute(self, unconstrained: Params, data: GPData) -> "GPState":
        return self.precompute_constrained(self.param_collection().constrain(unconstrained), data)

    def precompute_constrained(self, p: Params, data: GPData) -> "GPState":
        """Cholesky, alpha and the explicit L⁻¹ for matmul-only predicts."""
        device_lib.check(data.continuous, self.device, "GP data")
        gram = self._masked_gram(p, data)
        chol = posterior_cholesky(gram)
        y = rows_per_member(data.labels, gram.shape[0])
        alpha = torch.cholesky_solve(y[..., None], chol)[..., 0]
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        return GPState(model=self, params=p, data=data, chol=chol, alpha=alpha, linv=linv)


@dataclasses.dataclass(frozen=True)
class GPState:
    """Cholesky-precomputed posteriors of B parameter sets over one dataset."""

    model: VizierGaussianProcess
    params: Params  # constrained, leading axis B
    data: GPData
    chol: Tensor  # [B, N, N]
    alpha: Tensor  # [B, N]
    linv: Tensor  # [B, N, N] = chol⁻¹

    def predict(
        self, query: kernels.MixedFeatures, *, include_noise: bool = False
    ) -> Tuple[Tensor, Tensor]:
        """Posterior mean and stddev at query points ([B, Q], [B, Q])."""
        model, p, data = self.model, self.params, self.data
        # [B, Q, N], zero on padded data rows.
        k_star = model._kernel(p, query, data.features(), data, row_mask2=data.row_mask)
        mean = matvec(k_star, self.alpha)
        v = self.linv @ k_star.transpose(-1, -2)  # [B, N, Q]
        var = (p["amplitude"] * p["amplitude"])[:, None] - torch.sum(v * v, dim=-2)
        if include_noise:
            var = var + (p["noise_stddev"] * p["noise_stddev"])[:, None]
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))

    def predict_joint(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        """Posterior mean and full covariance over the query points.

        ``query`` [Q, ...] gives ([B, Q], [B, Q, Q]). A leading candidate
        axis, ``query`` [P, Q, ...], gives ([P, B, Q], [P, B, Q, Q]) from one
        k* launch over all P·Q points ([B, P·Q, N]) and one K(q, q) launch in
        which candidate p is group p of a [P·B] batch ([P·B, Q, Q]). The
        covariance is symmetrized and gets 1e-6 on its diagonal, as the JAX
        package's.
        """
        model, p, data = self.model, self.params, self.data
        batch = p["amplitude"].shape[0]
        q = query.continuous.shape[-2]
        flat = kernels.MixedFeatures(*(t.flatten(0, -2) for t in query))
        # [B, P·Q, N], zero on padded data rows.
        k_star = model._kernel(p, flat, data.features(), data, row_mask2=data.row_mask)
        if query.continuous.dim() == 3:
            count = query.continuous.shape[0]
            k_star = k_star.reshape(batch, count, q, -1).movedim(0, 1)
            # Candidate p's K(q, q) is group p of a [P·B] batch.
            p = {k: v.repeat((count,) + (1,) * (v.dim() - 1)) for k, v in p.items()}
            if model.use_input_warping and model.num_continuous:
                # Warped features are per member: one block per member.
                query = kernels.MixedFeatures(
                    *(torch.repeat_interleave(t, batch, dim=0) for t in query))
            k_qq = model._kernel(p, query, query, data).reshape(count, batch, q, q)
        else:
            k_qq = model._kernel(p, query, query, data)
        mean = matvec(k_star, self.alpha)
        v = self.linv @ k_star.transpose(-1, -2)  # [(P,) B, N, Q]
        cov = k_qq - v.transpose(-1, -2) @ v
        eye = torch.eye(q, dtype=cov.dtype, device=cov.device)
        return mean, 0.5 * (cov + cov.transpose(-1, -2)) + 1e-6 * eye

    def sample(self, query: kernels.MixedFeatures, eps: Tensor) -> Tensor:
        """Marginal posterior samples [num_samples, B, Q] (diagonal
        covariance) from the standard normals ``eps`` [num_samples, B, Q]."""
        mean, stddev = self.predict(query)
        return mean[None] + stddev[None] * eps


@dataclasses.dataclass(frozen=True)
class EnsemblePredictive:
    """Uniform, moment-matched Gaussian mixture over a GPState's batch axis.

    With ``studies`` S the batch is S studies' ensembles (S groups of
    ``B / S`` members): the mixture is taken per study and the predictions
    are [S, Q].
    """

    states: GPState
    studies: Optional[int] = None

    def predict(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        means, stddevs = self.states.predict(query)
        axis = 0
        if self.studies is not None:
            means = means.reshape(self.studies, -1, means.shape[-1])
            stddevs = stddevs.reshape(self.studies, -1, stddevs.shape[-1])
            axis = 1
        mean = torch.mean(means, dim=axis)
        second = torch.mean(stddevs**2 + means**2, dim=axis)
        var = torch.clamp(second - mean**2, min=1e-12)
        return mean, torch.sqrt(var)

    def predict_per_member(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        """Each member's posterior mean and stddev ([B, Q], [B, Q])."""
        return self.states.predict(query)
