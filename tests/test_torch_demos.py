"""The port's demos and default factories, at a tiny size on the CPU.

- ``default_factory`` of both GP designers builds the designer the JAX
  package's does (same class name, ``rng_seed = seed or 0``, keyword
  arguments passed through), on the device it is given.
- ``run_benchmark``'s ``main`` runs every designer and writes no plot
  without ``--out`` (matplotlib blocked); ``run_vizier_server`` serves
  ``run_vizier_client`` over gRPC; the client alone serves in process.
"""

from __future__ import annotations

import sys
import threading

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.designers import gp_bandit as jgp_bandit
from vizier_tpu.designers import gp_ucb_pe as jgp_ucb_pe
from vizier_tpu_torch import pyvizier as vz
from vizier_tpu_torch.demos import run_benchmark, run_vizier_client, run_vizier_server
from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe


def _problem(pkg):
    p = pkg.ProblemStatement()
    p.search_space.root.add_float_param("x", 0.0, 1.0)
    p.metric_information.append(
        pkg.MetricInformation(name="y", goal=pkg.ObjectiveMetricGoal.MAXIMIZE))
    return p


@pytest.mark.parametrize("ours,theirs", [(gp_bandit, jgp_bandit), (gp_ucb_pe, jgp_ucb_pe)],
                         ids=["gp_bandit", "gp_ucb_pe"])
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_default_factory_builds_the_jax_packages_designer(ours, theirs, seed):
    designer = ours.default_factory(_problem(vz), seed=seed, device="cpu",
                                    max_acquisition_evaluations=123)
    reference = theirs.default_factory(_problem(jvz), seed=seed, max_acquisition_evaluations=123)
    assert type(designer).__name__ == type(reference).__name__
    assert designer.rng_seed == reference.rng_seed == (seed or 0)
    assert designer.max_acquisition_evaluations == reference.max_acquisition_evaluations == 123
    assert designer.device == torch.device("cpu")


def test_run_benchmark_runs_every_designer_without_matplotlib(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    best = run_benchmark.main(
        ["--platform", "cpu", "--function", "Sphere", "--dim", "2", "--trials", "4",
         "--repeats", "1"])
    assert sorted(best) == ["gp_ucb", "quasirandom", "random"]
    assert all(len(v) == 1 and v[0] >= 0.0 for v in best.values())
    out = capsys.readouterr().out
    assert "gp_ucb repeat 0: 4 trials" in out and "wrote" not in out


def test_run_benchmark_defaults_to_the_card():
    import argparse

    parser_defaults = {}
    original = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        parsed = original(self, argv, namespace)
        parser_defaults.update(vars(parsed))
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            run_benchmark.main([])
    assert parser_defaults["platform"] == "cuda" and parser_defaults["out"] is None


def test_the_server_demo_serves_the_client_demo_over_grpc():
    from vizier_tpu_torch.service import vizier_server

    port = vizier_server._pick_port()
    server = threading.Thread(
        target=run_vizier_server.main,
        args=(["--platform", "cpu", "--port", str(port), "--seconds", "20"],), daemon=True)
    server.start()
    best = run_vizier_client.main(
        ["--endpoint", f"localhost:{port}", "--platform", "cpu", "--trials", "3",
         "--algorithm", "RANDOM_SEARCH", "--study_id", "grpc-demo"])
    assert 0.0 < best <= 1.0


def test_the_client_demo_serves_itself_in_process():
    best = run_vizier_client.main(
        ["--platform", "cpu", "--trials", "3", "--algorithm", "QUASI_RANDOM_SEARCH",
         "--study_id", "in-process-demo"])
    assert 0.0 < best <= 1.0
