"""When do 8 concurrent suggests reach the port's batch executor?

    python3 serving_arrivals.py [--trials 480] [--rounds 2]

Host-only measurement on the CPU, for the flush window of the serving
phases of ``chip_smoke.py``: the same 8 studies (bench.py's 20-D objective,
study i with ``trials + 2i`` completed trials, one ``InRamPolicySupporter``
each) are served by 8 threads at once through the port's policy factory,
``CachedDesignerStatePolicy`` and ``ServingRuntime(ServingConfig())``, as
the phases serve them. ``BatchExecutor.suggest`` is replaced by a recorder:
it notes when each request arrives and when its host-side ``prepare`` ends
(milliseconds after the threads are released), then stops the request, so
no device program runs. Each round rebuilds the studies' designers (the
stopped requests drop their cache entries), as a cold round does. Prints
the sorted times per round.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time

import torch


class _Stop(Exception):
    """Ends a recorded request before any device work."""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=480)
    parser.add_argument("--rounds", type=int, default=2)
    opts = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch import serving
    from vizier_tpu_torch.compute import registry
    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.pythia import local_policy_supporters, policy
    from vizier_tpu_torch.pyvizier import study_config
    from vizier_tpu_torch.service import policy_factory

    logging.disable(logging.WARNING)  # each stopped request logs its invalidation
    torch.set_num_threads(2)
    start = [0.0]
    arrived, prepared = [], []
    lock = threading.Lock()

    def record(self, designer, count=None):
        t_arrive = time.perf_counter() - start[0]
        program, _ = registry.resolve(designer, count)
        program.prepare(designer, count)
        with lock:
            arrived.append(t_arrive * 1e3)
            prepared.append((time.perf_counter() - start[0]) * 1e3)
        raise _Stop()

    batch_executor.BatchExecutor.suggest = record
    factory = policy_factory.DefaultPolicyFactory(
        serving.ServingRuntime(serving.ServingConfig()), device="cpu")
    studies = []
    for i in range(chip_smoke._SERVE_STUDIES):
        config = chip_smoke._serving_config(study_config, vz, "DEFAULT")
        supporter = local_policy_supporters.InRamPolicySupporter(config, study_guid=f"s{i}")
        supporter.AddTrials(chip_smoke._serving_trials(vz, i, opts.trials + 2 * i))
        studies.append((config, supporter, f"s{i}"))
    for r in range(opts.rounds):
        arrived.clear()
        prepared.clear()
        barrier = threading.Barrier(len(studies), action=lambda: start.__setitem__(
            0, time.perf_counter()))

        def run(i):
            config, supporter, name = studies[i]
            barrier.wait()
            request = policy.SuggestRequest(study_descriptor=supporter.study_descriptor(),
                                            count=chip_smoke._COUNT)
            try:
                factory(config, config.algorithm, supporter, name).suggest(request)
            except _Stop:
                pass

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(studies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"round {r}: arrivals at the executor (ms) {[round(v, 1) for v in sorted(arrived)]}")
        print(f"round {r}: prepare done (ms) {[round(v, 1) for v in sorted(prepared)]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
