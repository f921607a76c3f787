"""Device-phase timing of the port, held to the JAX package's ``jax_timing``.

On the same sequence of phase names both packages record the same spans
(``jax.<phase>``), the same compile/execute modes and the same
``vizier_jax_phase_seconds{phase,mode}`` series with the same counts; with
the knob off both are inert. The CUDA-event side (``device_ms``, event time
within the host wall) runs on the card: ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu.observability import config as jconfig
from vizier_tpu.observability import jax_timing
from vizier_tpu.observability import metrics as jmetrics
from vizier_tpu.observability import tracing as jtracing
from vizier_tpu_torch.observability import config as config_lib
from vizier_tpu_torch.observability import device_timing
from vizier_tpu_torch.observability import metrics as metrics_lib
from vizier_tpu_torch.observability import tracing as tracing_lib

_SEQUENCE = ["gp_bandit.train_gp", "gp_bandit.acquisition", "gp_bandit.train_gp",
             "gp_ucb_pe.suggest_batched", "gp_bandit.train_gp", "gp_bandit.acquisition"]


@pytest.fixture
def both_on():
    jtracer, tracer = jtracing.Tracer(), tracing_lib.Tracer()
    jprev, prev = jtracing.set_tracer(jtracer), tracing_lib.set_tracer(tracer)
    jax_timing.set_config(jconfig.ObservabilityConfig())
    device_timing.set_config(config_lib.ObservabilityConfig())
    jax_timing.reset_compile_tracking()
    device_timing.reset_compile_tracking()
    yield jtracer, tracer
    jax_timing.set_config(None)
    device_timing.set_config(None)
    jax_timing.reset_compile_tracking()
    device_timing.reset_compile_tracking()
    jtracing.set_tracer(jprev)
    tracing_lib.set_tracer(prev)


def _run(module, registry, names, **kw):
    modes = []
    for name in names:
        with module.device_phase(name, registry=registry, **kw) as phase:
            torch.ones(2).sum()
        modes.append("compile" if phase.first_call else "execute")
    return modes


def test_modes_and_histogram_series_equal_the_jax_packages(both_on):
    jregistry, registry = jmetrics.MetricsRegistry(), metrics_lib.MetricsRegistry()
    theirs = _run(jax_timing, jregistry, _SEQUENCE)
    ours = _run(device_timing, registry, _SEQUENCE, device="cpu")
    assert ours == theirs == ["compile", "compile", "execute", "compile", "execute", "execute"]
    jhist = jregistry.get("vizier_jax_phase_seconds")
    hist = registry.get("vizier_jax_phase_seconds")
    assert sorted(hist.series_data()) == sorted(jhist.series_data())
    for key in jhist.series_data():
        labels = dict(key)
        assert hist.count(**labels) == jhist.count(**labels)
    assert registry.names() == jregistry.names() == ["vizier_jax_phase_seconds"]


def test_spans_carry_the_jax_packages_names_and_modes(both_on):
    jtracer, tracer = both_on
    _run(jax_timing, jmetrics.MetricsRegistry(), _SEQUENCE)
    _run(device_timing, metrics_lib.MetricsRegistry(), _SEQUENCE, device="cpu")
    theirs = [(s.name, s.attributes["mode"], s.attributes["first_call"])
              for s in jtracer.finished_spans()]
    ours = [(s.name, s.attributes["mode"], s.attributes["first_call"])
            for s in tracer.finished_spans()]
    assert ours == theirs
    assert all(s.attributes["device_ms"] is None and s.attributes["host_ms"] >= 0
               for s in tracer.finished_spans())


def test_recent_phases_hold_mode_and_host_time(both_on):
    _run(device_timing, metrics_lib.MetricsRegistry(), _SEQUENCE[:3], device="cpu")
    rows = device_timing.recent()
    assert [(name, mode) for name, mode, _, _ in rows] == [
        ("gp_bandit.train_gp", "compile"), ("gp_bandit.acquisition", "compile"),
        ("gp_bandit.train_gp", "execute")]
    assert all(host >= 0 and event is None for _, _, host, event in rows)


@pytest.mark.parametrize("config", [
    config_lib.ObservabilityConfig.disabled(),
    config_lib.ObservabilityConfig(jax_profiling=False),
], ids=["master_off", "knob_off"])
def test_off_is_inert_as_in_the_jax_package(both_on, config):
    jtracer, tracer = both_on
    device_timing.set_config(config)
    jax_timing.set_config(jconfig.ObservabilityConfig(
        enabled=config.enabled, jax_profiling=config.jax_profiling))
    registry, jregistry = metrics_lib.MetricsRegistry(), jmetrics.MetricsRegistry()
    _run(device_timing, registry, _SEQUENCE, device="cuda")  # no CUDA call when off
    _run(jax_timing, jregistry, _SEQUENCE)
    assert registry.names() == jregistry.names() == []
    assert tracer.finished_spans() == [] == jtracer.finished_spans()
    assert device_timing.recent() == []
    with device_timing.device_phase("x", device="cuda") as phase:
        assert not phase.enabled and phase.host_ms is None


def test_a_phase_named_none_is_not_timed(both_on):
    with device_timing.device_phase(None, device="cpu") as phase:
        pass
    assert not phase.enabled and device_timing.recent() == []


def test_the_off_switch_reads_the_ported_knob(monkeypatch):
    monkeypatch.setenv("VIZIER_TORCH_OBSERVABILITY_JAX", "0")
    device_timing.set_config(None)
    try:
        assert not device_timing._profiling_on()
        monkeypatch.setenv("VIZIER_TORCH_OBSERVABILITY_JAX", "1")
        device_timing.set_config(None)
        assert device_timing._profiling_on()
    finally:
        device_timing.set_config(None)


def test_the_designers_time_their_stages_under_the_jax_packages_names(both_on):
    """A sequential suggest of each GP designer records its train and sweep
    phases under the JAX package's names; the programs declare theirs."""
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.compute import registry as compute_registry
    from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe
    from vizier_tpu_torch.optimizers import lbfgs

    problem = vz.ProblemStatement()
    problem.search_space.root.add_float_param("x", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="y", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    fast = dict(ard_optimizer=lbfgs.AdamOptimizer(maxiter=5, device="cpu"), ard_restarts=2,
                max_acquisition_evaluations=100, device="cpu")
    for module in (gp_bandit, gp_ucb_pe):
        designer = module.default_factory(problem, seed=1, **fast)
        trials = [vz.Trial(id=i + 1, parameters={"x": 0.1 * i}) for i in range(4)]
        for t in trials:
            t.complete(vz.Measurement(metrics={"y": float(t.parameters["x"].value) ** 2}))
        from vizier_tpu_torch.algorithms import core as core_lib

        designer.update(core_lib.CompletedTrials(trials))
        designer.suggest(1)
    names = [name for name, _, _, _ in device_timing.recent()]
    assert names == ["gp_bandit.train_gp", "gp_bandit.acquisition",
                     "gp_ucb_pe.train_gp", "gp_ucb_pe.acquisition"]
    phases = {p.kind: p.device_phase for p in compute_registry.programs()}
    assert phases == {
        "gp_bandit": "gp_bandit.suggest_batched",
        "gp_bandit_sparse": "sparse_gp.suggest_batched",
        "gp_ucb_pe": "gp_ucb_pe.suggest_batched",
        "gp_ucb_pe_sparse": "sparse_gp.ucb_pe_suggest_batched",
    }
