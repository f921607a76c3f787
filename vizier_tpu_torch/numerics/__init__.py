"""The numerical core's facade: models, optimizers, padded types.

The port's counterpart of the JAX package's ``jax/__init__.py`` (the
reference facade ``vizier/jax``), with the same names. It lives under
``numerics`` so that no module of the port reads as ``jax``.
"""

from vizier_tpu_torch.models.gp import (
    EnsemblePredictive,
    GPData,
    GPState,
    VizierGaussianProcess,
)
from vizier_tpu_torch.models.kernels import MixedFeatures, matern52_ard
from vizier_tpu_torch.models.multitask_gp import MultiTaskGaussianProcess, MultiTaskType
from vizier_tpu_torch.models.output_warpers import create_default_warper
from vizier_tpu_torch.models.params import ParameterCollection, ParameterSpec, SoftClip
from vizier_tpu_torch.models.stacked_residual import (
    StackedResidualGP,
    train_stacked_residual_gp,
)
from vizier_tpu_torch.optimizers.lbfgs import (
    DEFAULT_RANDOM_RESTARTS,
    AdamOptimizer,
    LbfgsOptimizer,
    Optimizer,
    default_optimizer,
)
from vizier_tpu_torch.types import ContinuousAndCategorical, ModelData, ModelInput, PaddedArray
