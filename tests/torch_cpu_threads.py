"""Pins torch to one CPU thread in the port's tests.

Every ``tests/test_torch_*.py`` imports this module. The suite runs under
several pytest-xdist workers on one machine; at torch's default (one thread
per core) each worker's torch ops spread over every core, and the workers
then oversubscribe the machine many times over.
"""

import torch

torch.set_num_threads(1)
