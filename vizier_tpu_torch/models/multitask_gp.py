"""Multi-task GP: a separable task kernel over correlated metrics.

Counterpart of the JAX package's ``models/multitask_gp.py``: the covariance
factorizes as ``K((x,i),(x',j)) = k_x(x,x') · B[i,j]`` and the joint Gram is
the Kronecker product ``B ⊗ K_x`` over flattened (task-major) observations,
masked the same way as the single-task GP. INDEPENDENT multi-task is the
per-metric training in ``designers.gp_ucb_pe``.

Task-covariance parameterizations (all signed, so anti-correlated
objectives are representable):

- ``SEPARABLE`` (= ``SEPARABLE_NORMAL``): free lower-triangular Cholesky;
  positive diagonal, signed off-diagonals with a Normal(0, 1) prior.
- ``SEPARABLE_LKJ``: a correlation Cholesky by row normalization of signed
  entries, scaled by a per-task sqrt-diagonal in (1e-6, 1), with an
  LKJ(concentration=1) log-density on the correlation factor.
- ``SEPARABLE_DIAG``: diagonal-only B.

As in ``models.gp``, parameters carry a leading batch axis ``B`` (restarts
or ensemble members) over one shared ``MultiTaskData``. ``K_x`` is K1's
Gram (both sides the same tensors, no masks) through
``VizierGaussianProcess._kernel``; the Kronecker product is a broadcast,
and the factorizations are batched ``torch.linalg`` calls.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.models import params as params_lib

Tensor = torch.Tensor
Params = params_lib.Params

_JITTER = 1e-5
_LOG_2PI = 1.8378770664093453


class MultiTaskType(enum.Enum):
    INDEPENDENT = "INDEPENDENT"
    SEPARABLE = "SEPARABLE"
    SEPARABLE_NORMAL = "SEPARABLE"  # alias of SEPARABLE
    SEPARABLE_LKJ = "SEPARABLE_LKJ"
    SEPARABLE_DIAG = "SEPARABLE_DIAG"


def _with_strict_lower(base: Tensor, vec: Tensor, m: int) -> Tensor:
    """``base`` [..., m, m] plus ``vec`` [..., m(m-1)/2] written into the
    strict lower triangle in row-major order."""
    if m < 2:
        return base
    rows, cols = torch.tril_indices(m, m, offset=-1, device=vec.device)
    lower = torch.zeros(vec.shape[:-1] + (m, m), dtype=vec.dtype, device=vec.device)
    lower[..., rows, cols] = vec
    return base + lower


def _corr_cholesky(vec: Tensor, m: int) -> Tensor:
    """Signed lower-triangle entries [..., m(m-1)/2] → unit-diagonal
    correlation Cholesky [..., m, m]: 1 on the diagonal, then each row
    L2-normalized, so ``LLᵀ`` is a correlation matrix."""
    eye = torch.eye(m, dtype=torch.float32, device=vec.device).expand(vec.shape[:-1] + (m, m))
    l = _with_strict_lower(eye, vec, m)
    return l / torch.linalg.norm(l, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class MultiTaskData:
    """Shared features, per-task labels [M, N] with a joint mask."""

    features_data: gp_lib.GPData  # labels unused; features and dim masks shared
    task_labels: Tensor  # [M, N]
    task_mask: Tensor  # [M, N] bool: task m observed at row n

    @classmethod
    def from_gp_datas(cls, datas: Sequence[gp_lib.GPData]) -> "MultiTaskData":
        return cls(
            features_data=datas[0],
            task_labels=torch.stack([d.labels for d in datas]),
            task_mask=torch.stack([d.row_mask for d in datas]),
        )


@dataclasses.dataclass(frozen=True)
class MultiTaskGaussianProcess:
    """Separable multi-task GP over ``num_tasks`` correlated metrics."""

    num_continuous: int
    num_categorical: int
    num_tasks: int
    multitask_type: MultiTaskType = MultiTaskType.SEPARABLE
    # "cuda" (the default) or "cpu"; CUDA raises when no GPU is present.
    device: device_lib.DeviceLike = "cuda"

    def __post_init__(self):
        if self.multitask_type is MultiTaskType.INDEPENDENT:
            raise ValueError(
                "INDEPENDENT multi-task is the per-metric training in "
                "designers.gp_ucb_pe; MultiTaskGaussianProcess models the "
                "SEPARABLE* variants."
            )
        object.__setattr__(self, "device", device_lib.resolve(self.device))
        object.__setattr__(self, "base", gp_lib.VizierGaussianProcess(
            num_continuous=self.num_continuous, num_categorical=self.num_categorical,
            device=self.device,
        ))

    def param_collection(self) -> params_lib.ParameterCollection:
        spec, sc = params_lib.ParameterSpec, params_lib.SoftClip
        specs = list(self.base.param_collection().specs)
        m = self.num_tasks
        ntril = m * (m - 1) // 2
        # Per-task sqrt-scale in (1e-6, 1) under a Uniform prior (no penalty).
        sqrt_diag = spec("task_sqrt_diag", (m,), sc(1e-6, 1.0, log_space=False), 0.3, 0.95,
                         linear=True, regularize=False)
        if self.multitask_type is MultiTaskType.SEPARABLE_DIAG:
            specs.append(sqrt_diag)
        elif self.multitask_type is MultiTaskType.SEPARABLE_LKJ:
            # The LKJ density in _extra_regularization is the only prior on
            # the correlation entries.
            if m > 1:
                specs.append(spec("task_corr_chol_vec", (ntril,),
                                  sc(-5.0, 5.0, log_space=False), -0.5, 0.5,
                                  linear=True, regularize=False))
            specs.append(sqrt_diag)
        else:
            # Positive diagonal, log-normal prior at 1; signed off-diagonals
            # with a Normal(0, 1) prior.
            specs.append(spec("task_chol_diag", (m,), sc(0.05, 5.0), 0.3, 2.0))
            if m > 1:
                specs.append(spec("task_chol_offdiag", (ntril,),
                                  sc(-5.0, 5.0, log_space=False), -0.5, 0.5,
                                  prior_mu=0.0, prior_sigma=1.0, linear=True))
        return params_lib.ParameterCollection(tuple(specs))

    def _corr(self, p: Params) -> Tensor:
        vec = p.get("task_corr_chol_vec")
        if vec is None:
            vec = torch.zeros(p["amplitude"].shape + (0,), device=p["amplitude"].device)
        return _corr_cholesky(vec, self.num_tasks)

    def _task_cholesky(self, p: Params) -> Tensor:
        """[B, M, M] lower-triangular factor L with B = LLᵀ (+ jitter)."""
        t = self.multitask_type
        if t is MultiTaskType.SEPARABLE_DIAG:
            return torch.diag_embed(p["task_sqrt_diag"])
        if t is MultiTaskType.SEPARABLE_LKJ:
            return self._corr(p) * p["task_sqrt_diag"][..., :, None]
        diag = torch.diag_embed(p["task_chol_diag"])
        if self.num_tasks < 2:
            return diag
        return _with_strict_lower(diag, p["task_chol_offdiag"], self.num_tasks)

    def _task_cov(self, p: Params) -> Tensor:
        """[B, M, M] task covariance LLᵀ + 1e-6·I."""
        chol = self._task_cholesky(p)
        eye = torch.eye(self.num_tasks, device=chol.device)
        return chol @ chol.transpose(-1, -2) + 1e-6 * eye

    def _extra_regularization(self, p: Params) -> Tensor:
        """[B] model-level prior terms beyond the per-spec regularizers: the
        LKJ(1) Cholesky log-density −Σ_i (m − i − 1)·log L_ii."""
        if self.multitask_type is MultiTaskType.SEPARABLE_LKJ and self.num_tasks > 1:
            corr = self._corr(p)
            i = torch.arange(self.num_tasks, dtype=torch.float32, device=corr.device)
            exponents = self.num_tasks - i - 1.0
            diag = torch.diagonal(corr, dim1=-2, dim2=-1)
            return -torch.sum(exponents * torch.log(diag + 1e-12), dim=-1)
        return torch.zeros_like(p["amplitude"])

    def _kron(self, b: Tensor, k: Tensor) -> Tensor:
        """[B, M, M] ⊗ [B, Q, N] → [B, M, Q, M, N]: entry (m, q, t, n) is
        b[m, t]·k[q, n], the task-major Kronecker product before reshaping
        (``torch.kron`` does not batch)."""
        return b[:, :, None, :, None] * k[:, None, :, None, :]

    def _joint_gram(self, p: Params, data: MultiTaskData) -> Tensor:
        """[B, MN, MN]: B ⊗ K_x on pairs of observed (task, row) entries,
        noise² + jitter on their diagonal, identity on the unobserved ones."""
        fd = data.features_data
        f = fd.features()
        kx = self.base._kernel(p, f, f, fd)  # [B, N, N]: K1's Gram, unmasked
        bsz, n = kx.shape[0], kx.shape[-1]
        mn = self.num_tasks * n
        gram = self._kron(self._task_cov(p), kx).reshape(bsz, mn, mn)
        mask = data.task_mask.reshape(-1)
        gram = torch.where(mask[:, None] & mask[None, :], gram, torch.zeros_like(gram))
        noise = p["noise_stddev"] * p["noise_stddev"] + _JITTER  # [B]
        diag = torch.where(mask[None, :], noise[:, None], torch.ones_like(noise[:, None]))
        return gram + torch.diag_embed(diag)

    def _flat_labels(self, data: MultiTaskData) -> Tensor:
        labels = data.task_labels
        return torch.where(data.task_mask, labels, torch.zeros_like(labels)).reshape(-1)

    def neg_log_likelihood(self, unconstrained: Params, data: MultiTaskData) -> Tensor:
        """[B] losses: −log p(y | X, θ) + the priors, 1e10 where the loss is
        not finite or the Cholesky failed."""
        device_lib.check(data.task_labels, self.device, "multi-task data")
        coll = self.param_collection()
        p = coll.constrain(unconstrained)
        gram = self._joint_gram(p, data)
        y = self._flat_labels(data)
        chol, info = torch.linalg.cholesky_ex(gram)
        alpha = torch.cholesky_solve(y.expand(gram.shape[0], -1)[..., None], chol)[..., 0]
        mask = data.task_mask.reshape(-1)
        log_diag = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
        nll = (
            0.5 * torch.sum(y * alpha, dim=-1)
            + torch.sum(torch.where(mask, log_diag, torch.zeros_like(log_diag)), dim=-1)
            + 0.5 * torch.sum(mask.to(torch.float32)) * _LOG_2PI
        )
        loss = nll + coll.regularization(p) + self._extra_regularization(p)
        ok = torch.isfinite(loss) & (info == 0)
        return torch.where(ok, loss, torch.full_like(loss, 1e10))

    def precompute(self, unconstrained: Params, data: MultiTaskData) -> "MultiTaskGPState":
        return self.precompute_constrained(self.param_collection().constrain(unconstrained), data)

    def precompute_constrained(self, p: Params, data: MultiTaskData) -> "MultiTaskGPState":
        """Cholesky, alpha and the explicit L⁻¹ for matmul-only predicts."""
        device_lib.check(data.task_labels, self.device, "multi-task data")
        gram = self._joint_gram(p, data)
        chol = gp_lib.posterior_cholesky(gram)
        y = self._flat_labels(data)
        alpha = torch.cholesky_solve(y.expand(gram.shape[0], -1)[..., None], chol)[..., 0]
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
        return MultiTaskGPState(model=self, params=p, data=data, chol=chol, alpha=alpha, linv=linv)


@dataclasses.dataclass(frozen=True)
class MultiTaskGPState:
    """Precomputed joint posteriors of B parameter sets over one dataset."""

    model: MultiTaskGaussianProcess
    params: Params  # constrained, leading axis B
    data: MultiTaskData
    chol: Tensor  # [B, MN, MN]
    alpha: Tensor  # [B, MN]
    linv: Tensor  # [B, MN, MN] = chol⁻¹

    def predict(self, query: kernels.MixedFeatures) -> Tuple[Tensor, Tensor]:
        """Posterior per task: mean and stddev [B, M, Q], with prior
        variance amp²·B[m, m]."""
        model, p, data = self.model, self.params, self.data
        fd = data.features_data
        kx_star = model.base._kernel(p, query, fd.features(), fd)  # [B, Q, N]
        b = model._task_cov(p)  # [B, M, M]
        bsz, q = kx_star.shape[:2]
        m = model.num_tasks
        k_star = model._kron(b, kx_star).reshape(bsz, m, q, -1)  # [B, M, Q, MN]
        mask = data.task_mask.reshape(-1)
        k_star = torch.where(mask, k_star, torch.zeros_like(k_star))
        mean = (k_star @ self.alpha[:, None, :, None])[..., 0]  # [B, M, Q]
        v = self.linv @ k_star.reshape(bsz, m * q, -1).transpose(-1, -2)  # [B, MN, MQ]
        amp2 = p["amplitude"] * p["amplitude"]
        prior_var = (amp2[:, None] * torch.diagonal(b, dim1=-2, dim2=-1))[..., None]
        var = prior_var - torch.sum(v * v, dim=-2).reshape(bsz, m, q)
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))
