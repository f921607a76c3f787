"""vizier_tpu_torch.loadgen: the production-shaped traffic engine.

The port's copy of the JAX package's ``loadgen`` package (the same
``__all__``): seeded deterministic traffic models (``models``), a
virtual-client driver that runs them against real serving targets with the
opt-in planes toggled per scenario (``driver``), and the assertion engine
that turns one run into a soak report (``report``). Entry point:
``python -m vizier_tpu_torch.loadgen.soak``.

The exports load lazily (PEP 562), so ``models`` and ``report`` import on a
host without protobuf and gRPC.
"""

import importlib

# name -> submodule that defines it.
_EXPORTS = {
    "EventSpec": "models",
    "LoadgenPolicyFactory": "driver",
    "PlaneConfig": "models",
    "RequestRecord": "driver",
    "Scenario": "models",
    "ScenarioConfig": "models",
    "SoakResult": "driver",
    "StudyOutcome": "driver",
    "StudySpec": "models",
    "build_report": "report",
    "build_scenario": "models",
    "default_event_track": "models",
    "loadgen_reliability": "driver",
    "parse_event_track": "models",
    "ranksum_p": "report",
    "render_verdict": "report",
    "run": "driver",
    "run_gated_off": "driver",
    "run_reference": "driver",
    "scenario_env": "driver",
    "smoke_config": "models",
    "soak_config": "models",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
