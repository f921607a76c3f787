"""The port's demos: a Vizier server, a client against it, and a benchmark.

Each runs with ``python -m vizier_tpu_torch.demos.<name>``; ``--platform``
picks ``cuda`` (the default) or ``cpu``.
"""
