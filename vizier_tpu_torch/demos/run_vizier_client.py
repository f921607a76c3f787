"""Client demo: optimizes a toy objective against a Vizier server.

The port's counterpart of the JAX package's ``demos/run_vizier_client.py``.

Usage::

  python -m vizier_tpu_torch.demos.run_vizier_client --endpoint localhost:28080
      [--trials 20] [--algorithm DEFAULT] [--platform cuda|cpu]

Without ``--endpoint`` the study is served in this process, its designers on
``--platform`` (``cuda`` by default, which needs a GPU).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def evaluate(lr: float, layers: int) -> float:
    return 1.0 - 100.0 * (lr - 0.01) ** 2 - 0.05 * abs(layers - 3)


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Runs the study; returns the best accuracy found."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--endpoint", default=None)
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--algorithm", default="DEFAULT")
    parser.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--study_id", default="client-demo")
    args = parser.parse_args(argv)

    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.service import clients

    clients.environment_variables.device = args.platform
    config = vz.StudyConfig(algorithm=args.algorithm)
    root = config.search_space.root
    root.add_float_param("learning_rate", 1e-4, 1e-1, scale_type=vz.ScaleType.LOG)
    root.add_int_param("layers", 1, 8)
    config.metric_information.append(
        vz.MetricInformation(name="accuracy", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    study = clients.Study.from_study_config(
        config, owner="demo", study_id=args.study_id, endpoint=args.endpoint
    )
    for i in range(args.trials):
        for trial in study.suggest(count=1):
            params = trial.parameters
            acc = evaluate(params["learning_rate"], params["layers"])
            trial.complete(vz.Measurement(metrics={"accuracy": acc}))
            print(f"trial {i + 1}: acc={acc:.4f} params={params}")
    best = list(study.optimal_trials())[0].materialize()
    value = best.final_measurement.metrics["accuracy"].value
    print("best:", value, dict(best.parameters.as_dict()))
    return value


if __name__ == "__main__":
    main()
