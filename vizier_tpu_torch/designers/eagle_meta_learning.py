"""Eagle meta-learning preset: tune the firefly hyperparameters online.

Copy of the JAX package's ``designers/eagle_meta_learning.py``: a
log-scaled search space over the eagle strategy's own coefficients, plus a
factory that wires it into :class:`MetaLearningDesigner` over the port's
``eagle_strategy.py``, so the firefly coefficients are tuned on the user's
objective instead of fixed at their defaults.

The tuned set: perturbation (and its lower bound), gravity, negative
gravity, continuous and categorical visibility, the categorical
perturbation factor and the pool-size factor. There are no ``discrete_*``
or ``pure_categorical_perturbation`` knobs: DISCRETE parameters go through
the categorical force model. FireflyConfig fields outside the tuned set
(``max_perturbation``, ``explore_rate``, ``penalize_factor``,
``max_pool_size``) stay at their defaults.
"""

from __future__ import annotations

from typing import Optional

from vizier_tpu_torch.algorithms import core as core_lib
from vizier_tpu_torch.designers import eagle_strategy
from vizier_tpu_torch.designers import meta_learning
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import parameter_config as pc


def meta_eagle_search_space() -> pc.SearchSpace:
    """Search space over the firefly coefficients (log-uniform, the eagle defaults)."""
    space = pc.SearchSpace()
    root = space.root
    root.add_float_param(
        "perturbation", 1e-4, 1e2, default_value=1e-1, scale_type=pc.ScaleType.LOG
    )
    root.add_float_param(
        "perturbation_lower_bound",
        1e-5,
        1e-1,
        default_value=1e-3,
        scale_type=pc.ScaleType.LOG,
    )
    root.add_float_param(
        "gravity", 1e-2, 1e2, default_value=1.0, scale_type=pc.ScaleType.LOG
    )
    root.add_float_param(
        "negative_gravity",
        2e-4,
        2.0,
        default_value=2e-2,
        scale_type=pc.ScaleType.LOG,
    )
    root.add_float_param(
        "visibility", 3e-2, 3e2, default_value=3.0, scale_type=pc.ScaleType.LOG
    )
    root.add_float_param(
        "categorical_visibility",
        2e-3,
        2e1,
        default_value=2e-1,
        scale_type=pc.ScaleType.LOG,
    )
    root.add_float_param(
        "categorical_perturbation_factor",
        2.5e-1,
        2.5e3,
        default_value=2.5e1,
        scale_type=pc.ScaleType.LOG,
    )
    root.add_float_param(
        "pool_size_factor", 1.0, 2.0, default_value=1.2, scale_type=pc.ScaleType.LOG
    )
    return space


def eagle_designer_factory(
    problem: base_study_config.ProblemStatement,
    *,
    seed: Optional[int] = None,
    **hyperparams: float,
) -> eagle_strategy.EagleStrategyDesigner:
    """Builds an eagle designer from meta-suggested coefficient values."""
    config = eagle_strategy.FireflyConfig(
        **{k: float(v) for k, v in hyperparams.items()}
    )
    return eagle_strategy.EagleStrategyDesigner(
        problem=problem, config=config, seed=seed
    )


def eagle_meta_learning_designer(
    problem: base_study_config.ProblemStatement,
    *,
    config: Optional[meta_learning.MetaLearningConfig] = None,
    meta_factory: Optional[core_lib.DesignerFactory] = None,
    seed: Optional[int] = None,
) -> meta_learning.MetaLearningDesigner:
    """The eagle meta-learning setup as one call."""
    return meta_learning.MetaLearningDesigner(
        problem=problem,
        tuning_space=meta_eagle_search_space(),
        inner_factory=lambda p, **hp: eagle_designer_factory(p, seed=seed, **hp),
        meta_factory=meta_factory,
        config=config or meta_learning.MetaLearningConfig(),
        seed=seed,
    )
