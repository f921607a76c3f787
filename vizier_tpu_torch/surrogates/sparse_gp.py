"""Sparse inducing-point GP: the SGPR collapsed bound, mask-safe.

Counterpart of the JAX package's ``surrogates/sparse_gp.py`` (Titsias'
collapsed bound; "Scalable Thompson Sampling using Sparse Gaussian Process
Models", arXiv:2006.05356). ``m`` inducing points Z chosen from the data
summarize it: training costs O(n·m²) per loss evaluation and a posterior
query O(m²), against the exact GP's O(n³) and O(n²). The hyperparameters
are the exact GP's, so the same multi-restart L-BFGS trains this model and
warm-started restarts carry over.

As in ``models.gp``, parameters carry a leading batch axis ``B`` (restarts or
ensemble members) and share one ``SparseGPData``, or, in a cross-study
flush, S studies' stacked ``SparseGPData`` (a leading study axis on every
field) with ``B / S`` members per study. Every kernel block goes
through ``VizierGaussianProcess._kernel``, so on the card it is K1 (forward)
and K2 (gradient):

- Kmm: K1's Gram mode with the inducing mask on both sides and diagonal
  value ``_KMM_JITTER``: ``amp² + jitter`` on valid slots (the kernel's
  diagonal is exactly ``amp²``), 1 on padded ones, 0 across;
- Knm: K1's cross mode with the data rows' mask and the inducing mask;
- k*: K1's cross mode with the inducing mask.

The products, Choleskys and triangular solves are ``torch.matmul`` and
``torch.linalg``; predictions are matmul-only through the two explicit
triangular inverses formed at precompute.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from vizier_tpu_torch import device as device_lib
from vizier_tpu_torch.models import gp as gp_lib
from vizier_tpu_torch.models import kernels
from vizier_tpu_torch.models import params as params_lib

Tensor = torch.Tensor
Params = params_lib.Params

_LOG_2PI = 1.8378770664093453
# Noise-floor jitter matching the exact GP's Gram stabilizer.
_JITTER = 1e-5
# Kmm jitter: k-center can pick duplicate training rows, so the inducing Gram
# gets a slightly larger diagonal than the data Gram.
_KMM_JITTER = 1e-4


@dataclasses.dataclass(frozen=True)
class SparseGPData:
    """Training data and the selected (padded, masked) inducing set."""

    data: gp_lib.GPData
    z_continuous: Tensor  # [M, Dc] float32 ([S, M, Dc] in a flush)
    z_categorical: Tensor  # [M, Ds] int32
    inducing_mask: Tensor  # [M] bool, True = real inducing point
    inducing_indices: Tensor  # [M] int64 rows of ``data`` the points came from

    @property
    def num_inducing(self) -> int:
        return self.z_continuous.shape[-2]

    def z_features(self) -> kernels.MixedFeatures:
        return kernels.MixedFeatures(self.z_continuous, self.z_categorical)


def select_inducing_kcenter(data: gp_lib.GPData, m: int) -> SparseGPData:
    """Greedy k-center (farthest-point) selection of ``m`` inducing points.

    Deterministic given the data: starts at the best-label valid row (the
    incumbent), then repeatedly takes the valid row farthest from the chosen
    set under the unit-length-scale mixed metric (squared euclidean on
    continuous dims + hamming on categorical ones, both dim-masked). Ties go
    to the lowest row index, as the JAX package's ``argmax`` breaks them.
    The picks stay on the device: no pick reads a value back to the host.
    When fewer than ``m`` valid rows exist the surplus slots repeat chosen
    rows and ``inducing_mask`` masks them out. A flush's stacked data picks
    every study's rows at once, one gather per pick for all studies.
    """
    cont, cat = data.continuous, data.categorical
    valid = data.row_mask
    lead = valid.shape[:-1]  # () or (S,)
    neg_inf = torch.tensor(float("-inf"), dtype=cont.dtype, device=cont.device)
    cont_w = data.cont_dim_mask.to(cont.dtype).unsqueeze(-2)
    cat_w = data.cat_dim_mask.to(cont.dtype).unsqueeze(-2)
    idxs = torch.zeros(lead + (m,), dtype=torch.int64, device=cont.device)
    # Device indices throughout: plain indexing by a 0-d tensor would read it
    # back to the host.
    last = torch.argmax(torch.where(valid, data.labels, neg_inf), dim=-1, keepdim=True)
    idxs[..., 0] = last[..., 0]
    min_d = torch.full(valid.shape, float("inf"), dtype=cont.dtype, device=cont.device)
    for i in range(1, m):
        dc = cont - torch.take_along_dim(cont, last[..., None], dim=-2)
        dist = torch.sum(dc * dc * cont_w, dim=-1)
        if cat.shape[-1]:
            picked = torch.take_along_dim(cat, last[..., None], dim=-2)
            mismatch = (cat != picked).to(cont.dtype)
            dist = dist + torch.sum(mismatch * cat_w, dim=-1)
        min_d = torch.minimum(min_d, dist)
        last = torch.argmax(torch.where(valid, min_d, neg_inf), dim=-1, keepdim=True)
        idxs[..., i] = last[..., 0]
    num_valid = torch.sum(valid.to(torch.int64), dim=-1, keepdim=True)
    mask = torch.arange(m, device=cont.device) < torch.clamp(num_valid, max=m)
    return SparseGPData(
        data=data,
        z_continuous=torch.take_along_dim(cont, idxs[..., None], dim=-2),
        z_categorical=torch.take_along_dim(cat, idxs[..., None], dim=-2),
        inducing_mask=mask.reshape(lead + (m,)),
        inducing_indices=idxs,
    )


def with_pending_capacity(sdata: SparseGPData, data: gp_lib.GPData, extra: int) -> SparseGPData:
    """The same inducing rows Z over another data block (completed + active
    rows with spare rows for a batch's picks), plus ``extra`` masked-off spare
    inducing slots that per-pick conditioning may fill
    (``gp_ucb_pe._append_row_sparse``)."""

    def grow(t: Tensor, axis: int) -> Tensor:
        shape = list(t.shape)
        shape[axis] = extra
        return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=axis)

    return SparseGPData(
        data=data,
        z_continuous=grow(sdata.z_continuous, -2),
        z_categorical=grow(sdata.z_categorical, -2),
        inducing_mask=grow(sdata.inducing_mask, -1),
        inducing_indices=grow(sdata.inducing_indices, -1),
    )


@dataclasses.dataclass(frozen=True)
class SparseGaussianProcess:
    """Static sparse-model config + pure functions over (batched params, data).

    Wraps the exact model for its kernel and hyperparameters; ``num_inducing``
    is the padded inducing-slot count.
    """

    base: gp_lib.VizierGaussianProcess
    num_inducing: int

    @property
    def device(self) -> torch.device:
        return self.base.device

    def param_collection(self) -> params_lib.ParameterCollection:
        return self.base.param_collection()

    # -- masked covariance blocks ------------------------------------------

    def _masked_kmm(self, p: Params, sdata: SparseGPData) -> Tensor:
        """[B, M, M]: K(Z, Z) + jitter·I on valid slots; identity on padded slots."""
        zf = sdata.z_features()
        m = sdata.inducing_mask
        jitter = torch.full_like(p["amplitude"], _KMM_JITTER)
        return self.base._kernel(p, zf, zf, sdata.data, row_mask1=m, row_mask2=m, diag=jitter)

    def _masked_knm(self, p: Params, sdata: SparseGPData) -> Tensor:
        """[B, N, M]: K(X, Z), zero on padded rows and padded inducing slots."""
        return self.base._kernel(
            p, sdata.data.features(), sdata.z_features(), sdata.data,
            row_mask1=sdata.data.row_mask, row_mask2=sdata.inducing_mask,
        )

    def _factorize(self, p: Params, sdata: SparseGPData):
        """The shared SGPR factorization (GPflow notation), per batch member.

        L  = chol(Kmm)                                  [B, M, M]
        A  = L⁻¹ Kmn / σ                                [B, M, N]
        B  = I + A Aᵀ,  LB = chol(B)                    [B, M, M]
        c  = LB⁻¹ A y / σ                               [B, M]

        Padded inducing slots have zero A rows, so unit rows of B, a unit LB
        diagonal and zero c entries; padded data rows have zero A columns and
        zero labels. ``info`` [B] is nonzero where either Cholesky failed.
        """
        device_lib.check(sdata.data.continuous, self.device, "GP data")
        kmm = self._masked_kmm(p, sdata)
        knm = self._masked_knm(p, sdata)
        chol, info = torch.linalg.cholesky_ex(kmm)
        sigma2 = p["noise_stddev"] * p["noise_stddev"] + _JITTER  # [B]
        sigma = torch.sqrt(sigma2)[:, None, None]
        a = torch.linalg.solve_triangular(chol, knm.transpose(-1, -2), upper=False) / sigma
        eye = torch.eye(a.shape[-2], dtype=a.dtype, device=a.device)
        chol_b, info_b = torch.linalg.cholesky_ex(eye + a @ a.transpose(-1, -2))
        y = sdata.data.labels
        # One study's labels broadcast over the batch; a flush's per member.
        ay = gp_lib.matvec(a, gp_lib.rows_per_member(y, a.shape[0]))[..., None]  # [B, M, 1]
        c = torch.linalg.solve_triangular(chol_b, ay, upper=False)[..., 0] / sigma[..., 0]
        return chol, chol_b, a, c, sigma2, info | info_b

    # -- collapsed bound (the ARD loss) ------------------------------------

    def neg_log_likelihood(self, unconstrained: Params, sdata: SparseGPData) -> Tensor:
        """[B] negated Titsias bound + the exact GP's ARD regularizer.

        -ELBO = ½[n·log 2π + log|B| + n·log σ² + yᵀy/σ² − cᵀc]
                + ½/σ²·tr(Knn − Qnn)

        with every n-indexed term restricted to valid rows.
        """
        coll = self.param_collection()
        p = coll.constrain(unconstrained)
        _, chol_b, a, c, sigma2, info = self._factorize(p, sdata)
        data = sdata.data
        batch = sigma2.shape[0]
        y = data.labels
        row_mask = gp_lib.rows_per_member(data.row_mask, batch)
        inducing_mask = gp_lib.rows_per_member(sdata.inducing_mask, batch)
        n_valid = torch.sum(row_mask.to(y.dtype), dim=-1)
        log_diag = torch.log(torch.diagonal(chol_b, dim1=-2, dim2=-1))
        log_det = n_valid * torch.log(sigma2) + 2.0 * torch.sum(
            torch.where(inducing_mask, log_diag, torch.zeros_like(log_diag)), dim=-1
        )
        yy = torch.dot(y, y) if y.dim() == 1 else gp_lib.rows_per_member(
            torch.sum(y * y, dim=-1, keepdim=True), batch)[:, 0]
        quad = yy / sigma2 - torch.sum(c * c, dim=-1)
        amp2 = p["amplitude"] * p["amplitude"]
        # tr(Knn − Qnn)/σ²: diag(Knn) = amp² on valid rows; ΣA² is tr(Qnn)/σ²
        # (padded columns are zero).
        trace = n_valid * amp2 / sigma2 - torch.sum(a * a, dim=(-2, -1))
        nll = 0.5 * (n_valid * _LOG_2PI + log_det + quad + trace)
        loss = nll + coll.regularization(p)
        # Guard non-finite losses and failed factorizations (the reference's
        # Cholesky returns NaN where torch reports info > 0).
        ok = torch.isfinite(loss) & (info == 0)
        return torch.where(ok, loss, torch.full_like(loss, 1e10))

    # -- predictive --------------------------------------------------------

    def precompute(self, unconstrained: Params, sdata: SparseGPData) -> "SparseGPState":
        """Factorize once; posterior queries are then matmul-only O(m²)."""
        return self.precompute_constrained(self.param_collection().constrain(unconstrained), sdata)

    def precompute_constrained(self, p: Params, sdata: SparseGPData) -> "SparseGPState":
        """The factorization from constrained params (UCB-PE's per-pick
        re-conditioning overrides the noise and grows the pending rows)."""
        chol, chol_b, _, c, _, _ = self._factorize(p, sdata)
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device).expand_as(chol)
        linv = torch.linalg.solve_triangular(chol, eye, upper=False)
        lb_inv = torch.linalg.solve_triangular(chol_b, eye, upper=False)
        # mean(x*) = k*ᵀ L⁻ᵀ LB⁻ᵀ c: the two back-substitutions fold into one
        # [M] weight vector; the variance needs both inverses.
        w = gp_lib.matvec(linv.transpose(-1, -2), gp_lib.matvec(lb_inv.transpose(-1, -2), c))
        return SparseGPState(
            model=self, params=p, sdata=sdata, w=w, linv=linv, lb_linv=lb_inv @ linv
        )


@dataclasses.dataclass(frozen=True)
class SparseGPState:
    """Factorized SGPR posteriors of B parameter sets over one inducing set."""

    model: SparseGaussianProcess
    params: Params  # constrained, leading axis B
    sdata: SparseGPData
    w: Tensor  # [B, M] predictive-mean weights
    linv: Tensor  # [B, M, M] = chol(Kmm)⁻¹
    lb_linv: Tensor  # [B, M, M] = chol(B)⁻¹ @ chol(Kmm)⁻¹

    @property
    def data(self) -> gp_lib.GPData:
        return self.sdata.data

    def member(self, i: int) -> "SparseGPState":
        """Batch member ``i`` as a batch of one."""
        sl = slice(i, i + 1)
        return dataclasses.replace(
            self, params={k: v[sl] for k, v in self.params.items()},
            w=self.w[sl], linv=self.linv[sl], lb_linv=self.lb_linv[sl],
        )

    def first_members(self) -> "SparseGPState":
        """Each study's member 0 of a flush's state: one member per study."""
        sl = slice(None, None, self.w.shape[0] // self.sdata.data.num_studies)
        return dataclasses.replace(
            self, params={k: v[sl] for k, v in self.params.items()},
            w=self.w[sl], linv=self.linv[sl], lb_linv=self.lb_linv[sl],
        )

    def predict(
        self, query: kernels.MixedFeatures, *, include_noise: bool = False
    ) -> Tuple[Tensor, Tensor]:
        """Posterior mean and stddev at query points ([B, Q], [B, Q]).

        var(x*) = k** − ‖L⁻¹k*‖² + ‖LB⁻¹L⁻¹k*‖²: the SGPR predictive.
        """
        model, p, sdata = self.model, self.params, self.sdata
        # [B, Q, M], zero on padded inducing slots.
        k_star = model.base._kernel(
            p, query, sdata.z_features(), sdata.data, row_mask2=sdata.inducing_mask
        )
        mean = gp_lib.matvec(k_star, self.w)
        k_t = k_star.transpose(-1, -2)
        t1 = self.linv @ k_t  # [B, M, Q]
        t2 = self.lb_linv @ k_t
        amp2 = (p["amplitude"] * p["amplitude"])[:, None]
        var = amp2 - torch.sum(t1 * t1, dim=-2) + torch.sum(t2 * t2, dim=-2)
        if include_noise:
            var = var + (p["noise_stddev"] * p["noise_stddev"])[:, None]
        return mean, torch.sqrt(torch.clamp(var, min=1e-12))

    def sample(
        self, query: kernels.MixedFeatures, generator: torch.Generator, num_samples: int
    ) -> Tensor:
        """Marginal posterior samples [B, num_samples, Q] (diagonal covariance)."""
        mean, stddev = self.predict(query)
        eps = torch.randn(
            (mean.shape[0], num_samples, mean.shape[1]), generator=generator,
            dtype=mean.dtype, device=mean.device,
        )
        return mean[:, None, :] + stddev[:, None, :] * eps


# The exact GP's uniform, moment-matched mixture over the batch axis serves
# the sparse posterior unchanged: it needs only ``states.predict``.
SparseEnsemblePredictive = gp_lib.EnsemblePredictive
