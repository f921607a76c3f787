"""The designer (algorithm) zoo of the port: the GP bandits, their
quasi-random seeding, and the JAX package's other designers and wrappers."""

from vizier_tpu_torch.designers.grid import GridSearchDesigner
from vizier_tpu_torch.designers.quasi_random import HaltonSequence, QuasiRandomDesigner
from vizier_tpu_torch.designers.random import RandomDesigner

__all__ = [
    "GridSearchDesigner",
    "HaltonSequence",
    "QuasiRandomDesigner",
    "RandomDesigner",
]


def __getattr__(name):
    # The torch-importing designers load on first use.
    lazy = {
        "VizierGPBandit": ("vizier_tpu_torch.designers.gp_bandit", "VizierGPBandit"),
        "VizierGPUCBPEBandit": ("vizier_tpu_torch.designers.gp_ucb_pe", "VizierGPUCBPEBandit"),
        "UCBPEConfig": ("vizier_tpu_torch.designers.gp_ucb_pe", "UCBPEConfig"),
        "NSGA2Designer": ("vizier_tpu_torch.designers.evolution", "NSGA2Designer"),
        "CMAESDesigner": ("vizier_tpu_torch.designers.cmaes", "CMAESDesigner"),
        "PyCMAESDesigner": ("vizier_tpu_torch.designers.pycmaes", "PyCMAESDesigner"),
        "EagleStrategyDesigner": ("vizier_tpu_torch.designers.eagle_strategy",
                                  "EagleStrategyDesigner"),
        "BOCSDesigner": ("vizier_tpu_torch.designers.bocs", "BOCSDesigner"),
        "HarmonicaDesigner": ("vizier_tpu_torch.designers.harmonica", "HarmonicaDesigner"),
        "ScalarizingDesigner": ("vizier_tpu_torch.designers.scalarizing_designer",
                                "ScalarizingDesigner"),
        "ScheduledDesigner": ("vizier_tpu_torch.designers.scheduled_designer",
                              "ScheduledDesigner"),
        "UnsafeAsInfeasibleDesigner": (
            "vizier_tpu_torch.designers.unsafe_as_infeasible_designer",
            "UnsafeAsInfeasibleDesigner",
        ),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
