"""Benchmark experimenters: base protocol, synthetic suites, wrappers,
combinatorial (COMBO) problems, and data-backed surrogate handlers."""

from vizier_tpu_torch.benchmarks.experimenters.base import Experimenter, NumpyExperimenter
from vizier_tpu_torch.benchmarks.experimenters.combinatorial import (
    CentroidExperimenter,
    ContaminationExperimenter,
    IsingExperimenter,
    L1CategoricalExperimenter,
    MAXSATExperimenter,
    PestControlExperimenter,
)
from vizier_tpu_torch.benchmarks.experimenters.nasbench101 import (
    NASBench101Experimenter,
    TabularNASBench101,
)
from vizier_tpu_torch.benchmarks.experimenters.surrogates import (
    Atari100kExperimenter,
    Atari100kHandler,
    HPOBHandler,
    NASBench201Handler,
    PredictorExperimenter,
    TabularSurrogateExperimenter,
)
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
    InfeasibleExperimenter,
    NoisyExperimenter,
    NormalizingExperimenter,
    PermutingExperimenter,
    ShiftingExperimenter,
    SignFlipExperimenter,
    SparseExperimenter,
    SwitchExperimenter,
)
