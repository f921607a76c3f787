"""Static analysis suite of the port: lock order, CUDA-graph discipline,
the switch registry, compute-IR conformance and runtime lock order.

The port's copy of the JAX package's ``analysis/`` (stdlib ``ast`` only, so
it runs without torch). Run it as ``python -m vizier_tpu_torch.analysis``;
the command line and ``tests/test_torch_analysis.py`` share
:func:`vizier_tpu_torch.analysis.suite.run_suite` and the package's own
``baseline.toml``.
"""

from vizier_tpu_torch.analysis import registry
from vizier_tpu_torch.analysis.common import Finding, Project
from vizier_tpu_torch.analysis.suite import (
    ALL_PASSES,
    SuiteConfig,
    SuiteResult,
    format_report,
    load_config,
    run_suite,
)

__all__ = [
    "ALL_PASSES",
    "Finding",
    "Project",
    "SuiteConfig",
    "SuiteResult",
    "format_report",
    "load_config",
    "registry",
    "run_suite",
]
