"""The mesh execution plane: device placements for the batch executor.

Counterpart of the JAX package's ``parallel/mesh.py`` on one host. The
process's devices (:func:`local_devices`: the CUDA devices of the host, or
the CPU) are carved into **placements** that the executor schedules over:

- **inter-flush concurrency** — different buckets are sticky-assigned to
  different placements; with two or more placements each one has its own
  worker thread (``vizier-mesh-worker-<i>``) that runs every launch of its
  buckets, so concurrent buckets no longer queue behind one thread;
- **intra-flush sharding** — a flush on a placement of S > 1 devices splits
  its leading study axis into S equal chunks (:meth:`DevicePlacement.shard`),
  one per device, and runs each chunk on its device;
- **shard-granularity padding** — a placement pads a flush to the next
  power-of-two multiple of its device count (:meth:`DevicePlacement.pad_to`),
  never more than one grid step above its occupancy; :meth:`pad_grid` is
  the fixed set of padded sizes, the layouts the prewarm walker captures.

Assignment is sticky (a bucket's first flush picks the least loaded
placement, every later flush and the prewarm walker reuse it), so each
bucket's CUDA graphs are captured on one placement.

Everything is opt-in: ``VIZIER_TORCH_MESH=0`` (the default) builds no
placement and the executor keeps its one scheduler thread. A device is a
real ``torch.device``: a ``num_devices`` above the host's count is capped,
as in the JAX package, and nothing stands in for a device that is not
there.

The multi-host coordinator seam (:func:`multihost_mesh`): with a coordinator
address (``VIZIER_TORCH_MESH_COORDINATOR``) the process joins a
``torch.distributed`` group (``parallel.initialize_multihost``, gloo) and the
device list spans every process's devices (:func:`global_devices`): each
entry is a :class:`ProcessDevice`, which names its process and, in the
process that holds it, its ``torch.device``. The placements are carved from
that list as on one host. An executor assigns buckets only to the placements
of its own process's devices and refuses a placement that spans processes.
The device counts are gathered once, at the join
(:func:`gather_device_counts`); building the list, the placements or an
executor afterwards needs no communication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

from vizier_tpu_torch.analysis import registry as _registry


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Knobs of the mesh execution plane (``VIZIER_TORCH_MESH*``).

    ``enabled=False`` (the default) lists no device, starts no worker and
    shards nothing.
    """

    # Master switch: carve devices into placements.
    enabled: bool = False
    # Devices to use (0 = every local device). Capped at the host's count.
    num_devices: int = 0
    # Devices per placement. 1 (the default): N single-device placements
    # running different buckets; > 1 also splits each flush's study axis
    # over the placement's devices.
    shard_devices: int = 1
    # Multi-host coordinator seam (:func:`multihost_mesh`): when set, the
    # process joins a torch.distributed group before building placements,
    # so several processes' devices are one mesh. Empty = single host.
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    @classmethod
    def from_env(cls) -> "MeshConfig":
        return cls(
            enabled=_registry.env_on("VIZIER_TORCH_MESH"),
            num_devices=_registry.env_int("VIZIER_TORCH_MESH_DEVICES", 0),
            shard_devices=max(1, _registry.env_int("VIZIER_TORCH_MESH_SHARD_DEVICES", 1)),
            coordinator_address=_registry.env_str("VIZIER_TORCH_MESH_COORDINATOR"),
            num_processes=_registry.env_int("VIZIER_TORCH_MESH_PROCESSES", 0),
            process_id=_registry.env_int("VIZIER_TORCH_MESH_PROCESS_ID", -1),
        )


def local_devices(device: Any = "cuda") -> List[Any]:
    """The process's devices of ``device``'s type: ``cuda:i`` for every card
    the process sees, or the one CPU. The one place the port lists devices.
    CUDA without a card raises (``device.resolve``), as every entry point does."""
    import torch

    from vizier_tpu_torch import device as device_lib

    dev = device_lib.resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


@dataclasses.dataclass(frozen=True)
class ProcessDevice:
    """One entry of a device list that spans processes.

    ``id`` is the entry's place in the global list (process-major), and
    ``device`` the real ``torch.device`` in the process that holds it (None in
    every other process). ``process_index`` is what the carve groups by.
    """

    process_index: int
    local_index: int
    id: int
    device: Optional[Any] = None


def device_of(entry: Any) -> Optional[Any]:
    """The ``torch.device`` of a device-list entry in this process: the entry
    itself, a :class:`ProcessDevice`'s device, or None when another process
    holds it."""
    return entry.device if isinstance(entry, ProcessDevice) else entry


def _distributed_initialized() -> bool:
    """Whether this process's ``torch.distributed`` group is up. Read from
    ``torch.distributed`` alone: no device is touched."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


# What this process's join gathered (:func:`gather_device_counts`): the
# group, the device type counted and every process's count of it. None
# until a join; a group that is gone or replaced makes it stale.
_JOINED: Optional[Tuple[Any, str, Tuple[int, ...]]] = None


def gather_device_counts(device: Any = "cuda") -> None:
    """Gathers every process's count of ``device``'s type over the group
    (one ``all_gather_object``: every process of the group calls this
    together, from ``parallel.initialize_multihost``) and keeps it for
    :func:`global_devices`. Counts cannot change after the join, so a
    process gathers them once per group; a later call returns at once."""
    import torch.distributed as dist

    global _JOINED
    if _JOINED is not None and _JOINED[0] is dist.group.WORLD:
        return  # joined already: a second gather would wait for every peer
    local = local_devices(device)
    counts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    _JOINED = (dist.group.WORLD, local[0].type, tuple(counts))


def global_devices(device: Any = "cuda") -> List[Any]:
    """Every process's devices of ``device``'s type, in process order.

    Until this process has joined a group (:func:`gather_device_counts`,
    through ``parallel.initialize_multihost``): :func:`local_devices`. After
    it: one :class:`ProcessDevice` per device of every process, built from
    the counts the join gathered, with no communication.
    """
    import torch.distributed as dist

    local = local_devices(device)
    joined = _JOINED
    if joined is None or not _distributed_initialized() or joined[0] is not dist.group.WORLD:
        return local
    _, kind, counts = joined
    if local[0].type != kind:
        raise ValueError(f"The group was joined with {kind} devices, not {local[0].type}.")
    rank = dist.get_rank()
    out: List[Any] = []
    for process, count in enumerate(counts):
        for i in range(count):
            out.append(ProcessDevice(process, i, len(out), local[i] if process == rank else None))
    return out


class DevicePlacement:
    """One schedulable device group and its padding grid.

    The executor's unit of dispatch: each placement owns the buckets
    sticky-assigned to it (and, when there are several placements, one
    worker thread). :meth:`shard` splits a stacked flush over its devices.
    """

    def __init__(self, index: int, devices: Sequence[Any]):
        if not devices:
            raise ValueError("A DevicePlacement needs at least one device.")
        self.index = index
        self.devices = tuple(devices)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def torch_devices(self) -> Tuple[Any, ...]:
        """The placement's devices as ``torch.device``s (a
        :class:`ProcessDevice` unwrapped), what every launch is given."""
        return tuple(device_of(d) for d in self.devices)

    def label(self) -> str:
        """Low-cardinality metrics/tracing label (one per placement)."""
        return f"mesh{self.index}"

    @property
    def is_local(self) -> bool:
        """Whether this process holds every device of the placement."""
        return all(d is not None for d in self.torch_devices)

    @property
    def spans_processes(self) -> bool:
        return len({getattr(d, "process_index", 0) for d in self.devices}) > 1

    def describe(self) -> str:
        ids = ",".join(str(getattr(d, "id", d)) for d in self.devices)
        return f"mesh{self.index}[devices {ids}]"

    def shard(self, tree: Any) -> List[Any]:
        """A stacked (leading study axis) pytree as ``num_devices`` equal
        chunks, chunk k's tensor leaves on device k. Numpy leaves stay on the
        host, sliced: a program moves them when it converts them. The
        executor pads the batch to a multiple of ``num_devices``."""
        from vizier_tpu_torch.parallel import batch_executor

        leaves = batch_executor.tree_leaves(tree)
        size = leaves[0].shape[0] if leaves else 0
        if size % self.num_devices:
            raise ValueError(
                f"A batch of {size} does not split over {self.num_devices} devices.")
        step = size // self.num_devices
        return [
            batch_executor.tree_map(
                lambda a, k=k, dev=dev: _to(a[k * step : (k + 1) * step], dev), tree)
            for k, dev in enumerate(self.torch_devices)
        ]

    # -- shard-granularity padding -----------------------------------------

    def pad_to(self, occupancy: int, max_batch_size: int) -> int:
        """The padded batch of ``occupancy`` live slots on this placement.

        The next power-of-two multiple of the device count, capped at the
        whole bucket (``ceil(max_batch_size / S) * S``): every device gets an
        equal share and a flush computes at most one grid step of padding.
        """
        s = self.num_devices
        chunks = max(1, math.ceil(occupancy / s))
        cap = max(chunks, math.ceil(max_batch_size / s))
        q = 1
        while q < chunks:
            q *= 2
        return s * min(q, cap)

    def pad_grid(self, max_batch_size: int) -> List[int]:
        """Every padded batch :meth:`pad_to` can produce: the layouts the
        prewarm walker runs per (bucket, placement)."""
        s = self.num_devices
        cap = max(1, math.ceil(max_batch_size / s))
        grid: List[int] = []
        q = 1
        while q < cap:
            grid.append(s * q)
            q *= 2
        grid.append(s * cap)
        return grid


def _to(leaf: Any, device: Any) -> Any:
    import torch

    return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf


def multihost_mesh(config: MeshConfig, device: Any = "cuda") -> List[Any]:
    """The multi-host coordinator seam: the device list the placements tile.

    Single host (no coordinator, no group): the host's own devices. With
    ``coordinator_address`` set (``VIZIER_TORCH_MESH_COORDINATOR``) the
    process first joins the group through ``parallel.initialize_multihost``
    (the same explicit wiring), and the list spans every process's devices
    (:func:`global_devices`), as it does whenever the process has joined.
    """
    if config.coordinator_address:
        from vizier_tpu_torch import parallel as parallel_lib

        parallel_lib.initialize_multihost(
            coordinator_address=config.coordinator_address,
            num_processes=config.num_processes or None,
            process_id=config.process_id if config.process_id >= 0 else None,
            device=device,
        )
    return global_devices(device)


def _carve_device_groups(devices: Sequence[Any], s: int) -> List[List[Any]]:
    """Groups ``devices`` into shard groups of ``s``, process-local first.

    Devices are grouped by ``process_index`` (0 when a device has none) in
    order; each process's devices are carved into s-sized groups, then the
    processes' remainders, pooled in process order, into more groups. A
    final remainder smaller than ``s`` is dropped.
    """
    by_process: dict = {}
    order: List[Any] = []
    for device in devices:
        pid = getattr(device, "process_index", 0)
        if pid not in by_process:
            by_process[pid] = []
            order.append(pid)
        by_process[pid].append(device)
    groups: List[List[Any]] = []
    leftovers: List[Any] = []
    for pid in order:
        local = by_process[pid]
        for start in range(0, len(local) - s + 1, s):
            groups.append(local[start : start + s])
        leftovers.extend(local[len(local) - len(local) % s :])
    for start in range(0, len(leftovers) - s + 1, s):
        groups.append(leftovers[start : start + s])
    return groups


def build_placements(config: MeshConfig, device: Any = "cuda") -> List[DevicePlacement]:
    """Carves the devices of ``device``'s type (every process's, on a
    multi-host mesh) into placements.

    ``num_devices`` caps how many devices take part; ``shard_devices`` groups
    them into equal placements (:func:`_carve_device_groups`); a trailing
    group smaller than ``shard_devices`` is dropped, and with fewer devices
    than one group the placement takes them all.
    """
    devices = multihost_mesh(config, device)
    if config.num_devices:
        devices = devices[: config.num_devices]
    s = max(1, config.shard_devices)
    groups = _carve_device_groups(devices, s)
    placements = [DevicePlacement(i, group) for i, group in enumerate(groups)]
    if not placements:  # fewer devices than one shard group: use them all
        placements = [DevicePlacement(0, list(devices))]
    return placements
