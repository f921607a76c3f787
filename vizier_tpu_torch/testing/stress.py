"""Shared multi-client service-stress topology.

The port's copy of the JAX package's ``testing/stress.py``: a 2-D
RANDOM_SEARCH study, N thread-pool clients each running their own
suggest→complete loop, over the port's ``service/clients.py``. It needs
protobuf and gRPC (the client's transport), so it runs where the service
runs, not on a host with only the serving stack.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import List, Tuple

from vizier_tpu_torch import pyvizier as vz


def stress_study_config() -> vz.StudyConfig:
    sc = vz.StudyConfig()
    sc.search_space.root.add_float_param("x", 0.0, 1.0)
    sc.search_space.root.add_float_param("y", 0.0, 1.0)
    sc.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MINIMIZE)
    )
    sc.algorithm = "RANDOM_SEARCH"
    return sc


def run_stress_round(
    study, num_clients: int, trials_each: int
) -> Tuple[float, int, List[List[int]]]:
    """Runs the N-client suggest→complete round on a ``clients.Study``.

    Returns ``(wall_s, completed, per_worker_trial_ids)``: ``completed``
    counts COMPLETED trials only (an ACTIVE row left behind by a dropped
    completion must not pass for throughput), and the per-worker id lists
    let callers assert cross-worker trial disjointness.
    """

    def worker(worker_id: int) -> List[int]:
        my_ids: List[int] = []
        for _ in range(trials_each):
            (trial,) = study.suggest(count=1, client_id=f"worker_{worker_id}")
            x, y = float(trial.parameters["x"]), float(trial.parameters["y"])
            trial.complete(
                vz.Measurement(metrics={"obj": (x - 0.3) ** 2 + (y - 0.7) ** 2})
            )
            my_ids.append(trial.id)
        return my_ids

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=num_clients) as pool:
        per_worker = list(pool.map(worker, range(num_clients)))
    wall = time.perf_counter() - t0
    completed = len(
        list(study.trials(vz.TrialFilter(status=[vz.TrialStatus.COMPLETED])))
    )
    return wall, completed, per_worker
