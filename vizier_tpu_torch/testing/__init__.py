"""Shared test fixtures, runners, and statistical comparison testers.

The port's copy of the JAX package's ``testing`` package, with the same
exports: the SimpleKD convergence tester, the regret and efficiency
comparison testers, the random-metrics runner and the nested-structure
assertions. Its modules: ``failing`` and ``chaos`` (seeded fault injection
for designers, compute-IR programs, datastores and service stubs),
``chaos_flushes`` (chaos strikes through the batch executor),
``netchaos`` (the fleet's network faults), ``test_studies``,
``test_runners``, ``optimizer_test_utils``, ``numpy_assertions``,
``simplekd_runner``, ``comparator_runner`` and ``stress`` (the service
stress round; needs protobuf and gRPC).

The exports load lazily (PEP 562), so the serving runtime's import of
``netchaos`` pulls in none of the benchmark machinery.
"""

import importlib

# name -> submodule that defines it.
_EXPORTS = {
    "ConvergenceTestError": "simplekd_runner",
    "EfficiencyComparisonTester": "comparator_runner",
    "FailedComparisonTestError": "comparator_runner",
    "RandomMetricsRunner": "test_runners",
    "SimpleKDConvergenceTester": "simplekd_runner",
    "SimpleRegretComparisonTester": "comparator_runner",
    "assert_arraytree_allclose": "numpy_assertions",
    "assert_pytree_allclose": "numpy_assertions",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
