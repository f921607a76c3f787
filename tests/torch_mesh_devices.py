"""An 8-device host for the port's mesh tests on the CPU.

The JAX package's tests get eight devices from the conftest's
``--xla_force_host_platform_device_count=8``; the port lists its devices in
one function, ``parallel.mesh.local_devices``, and these tests replace it
with one that returns ``n`` CPU entries. Nothing in the program stands in
for a device: the switch is the tests' own.
"""

from __future__ import annotations

import torch

from vizier_tpu_torch import parallel
from vizier_tpu_torch.parallel import mesh as mesh_lib


def patch_devices(monkeypatch, n: int = 8) -> None:
    """``local_devices`` returns ``n`` CPU devices for the test's duration.

    As the JAX package's conftest does for its tests, the GP designers'
    auto-mesh is switched off (``VIZIER_TORCH_DISABLE_MESH``); a test of the
    designers' mesh asks for it with ``use_mesh=True`` or unsets the switch.
    """
    monkeypatch.setenv("VIZIER_TORCH_DISABLE_MESH", "1")

    def devices(device="cuda"):
        del device
        return [torch.device("cpu")] * n

    monkeypatch.setattr(mesh_lib, "local_devices", devices)
    monkeypatch.setattr(parallel, "local_devices", devices)
