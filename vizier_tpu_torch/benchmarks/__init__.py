"""Benchmark experimenters, runners, and analyzers.

Counterpart of the JAX package's ``benchmarks`` package: the experimenters
(BBOB, the classics, ZDT/DTLZ, SimpleKD, the combinatorial problems,
NASBench-101, the tabular surrogates, the factory and every wrapper), the
runner and its state, and the analyzers (regret, convergence, exploration
scores, state and record analyzers, plots), each a copy on the port's data
model. ``regret`` holds the DEFAULT designer's regret run
(``python -m vizier_tpu_torch.benchmarks.regret``).
"""

from vizier_tpu_torch.benchmarks.analyzers.convergence_curve import (
    ConvergenceCurve,
    ConvergenceCurveConverter,
    HypervolumeCurveConverter,
    LogEfficiencyConvergenceCurveComparator,
    SimpleRegretComparator,
    WinRateComparator,
)
from vizier_tpu_torch.benchmarks.analyzers.exploration_score import (
    compute_average_marginal_parameter_entropy,
    compute_parameter_entropy,
)
from vizier_tpu_torch.benchmarks.analyzers.simple_regret_score import t_test_mean_score
from vizier_tpu_torch.benchmarks.experimenters.base import (
    Experimenter,
    NumpyExperimenter,
    bbob_problem,
)
from vizier_tpu_torch.benchmarks.experimenters.synthetic.classic import (
    BernoulliMultiArmExperimenter,
    Branin2DExperimenter,
    FixedMultiArmExperimenter,
    HartmannExperimenter,
)
from vizier_tpu_torch.benchmarks.runners.benchmark_runner import (
    AddPriorTrials,
    BenchmarkRunner,
    BenchmarkSubroutine,
    EvaluateActiveTrials,
    GenerateAndEvaluate,
    GenerateSuggestions,
)
from vizier_tpu_torch.benchmarks.runners.benchmark_state import BenchmarkState, PolicySuggester
