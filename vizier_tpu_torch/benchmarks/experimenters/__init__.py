"""Benchmark experimenters: the base protocol, the synthetic suites and the
wrappers that the factory builds."""

from vizier_tpu_torch.benchmarks.experimenters.base import Experimenter, NumpyExperimenter
from vizier_tpu_torch.benchmarks.experimenters.synthetic.classic import (
    BernoulliMultiArmExperimenter,
    Branin2DExperimenter,
    FixedMultiArmExperimenter,
    HartmannExperimenter,
)
from vizier_tpu_torch.benchmarks.experimenters.synthetic.multiobjective import (
    MultiObjectiveExperimenter,
)
from vizier_tpu_torch.benchmarks.experimenters.wrappers import (
    DiscretizingExperimenter,
    NoisyExperimenter,
    ShiftingExperimenter,
)
