"""Device meshes over CUDA devices and processes.

Port of ``trialign/dist/mesh.py``.  A mesh is a (data, model) grid of slots;
each slot is a process rank and a ``torch.device`` of that process.  The
'data' axis spreads independent triplets of a batch; the 'model' axis
splits one long triplet's tile grid into stripes of tile columns
(``dist/halo.py``).  ``mesh.shape["data"]`` and ``mesh.shape["model"]``
read as the reference's ``jax.sharding.Mesh`` does.

A mesh may name one device more than once: its slots then share that
device, each on a CUDA stream of its own.  That is how one card runs a
2- or 4-stripe halo, and how the CPU tests build a mesh of n slots
(``devices=[torch.device("cpu")] * n``), the counterpart of the reference's
virtual CPU devices.

Processes join with :func:`init_distributed` (``torch.distributed`` on
``gloo``).  What crosses processes is host data: the scores a data slot
computes and, for a model axis that spans processes, the face slabs a
stripe hands on, staged through pinned host buffers.  NCCL carries device
tensors only, so the port refuses it until a send of device tensors between
cards can be tested.
"""

from __future__ import annotations

import os
from contextlib import nullcontext
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class Slot(NamedTuple):
    """One position of a mesh: the rank of the process that owns it and a
    device of that process."""

    rank: int
    device: torch.device


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A (data, model) grid of :class:`Slot`s."""

    axis_names = ("data", "model")

    def __init__(self, slots: Sequence[Sequence[Slot]]):
        self.slots = [list(row) for row in slots]
        if not self.slots or not self.slots[0] or \
                any(len(row) != len(self.slots[0]) for row in self.slots):
            raise ValueError("a mesh is a non-empty rectangle of slots")
        self.shape = {"data": len(self.slots), "model": len(self.slots[0])}

    def devices(self) -> List[List[torch.device]]:
        """The slots' devices, as the reference's ``Mesh.devices``."""
        return [[s.device for s in row] for row in self.slots]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.slots})"


def normalize(device) -> torch.device:
    """``device`` with the index a bare "cuda" stands for."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SlotStreams:
    """A CUDA stream for each of some slots' devices (none on the CPU).
    Each stream waits on its device's current stream when made, so it sees
    what the caller queued there; :meth:`join` makes each device's current
    stream wait on the streams, so that the caller reads complete results
    and the allocator reuses nothing early."""

    def __init__(self, devices: Sequence):
        self.devices = [normalize(d) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def on(self, k: int):
        """A context that makes slot k's stream current."""
        s = self.streams[k]
        return torch.cuda.stream(s) if s is not None else nullcontext()

    def join(self) -> None:
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)


def local_devices() -> List[torch.device]:
    """This process's CUDA devices ([] without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_devices(local: Optional[Sequence] = None) -> List[Slot]:
    """Every process's devices as slots, rank by rank: ``local`` (this
    process's CUDA devices by default) gathered from every process when a
    process group is up."""
    mine = [torch.device(d) for d in
            (local_devices() if local is None else local)]
    if not dist.is_initialized():
        return [Slot(0, d) for d in mine]
    everyone: List = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in mine])
    return [Slot(r, torch.device(d)) for r, devs in enumerate(everyone)
            for d in devs]


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (this process's CUDA devices,
    or every process's once :func:`init_distributed` has run, by default).
    ``devices`` may hold ``torch.device``s (of this process) or
    :class:`Slot`s, and may repeat a device.  Raises ValueError when there
    are too few, as the reference does."""
    if devices is None:
        devices = global_devices()
    slots = [d if isinstance(d, Slot) else Slot(rank(), torch.device(d))
             for d in devices]
    n = data * model
    if n > len(slots):
        raise ValueError(f"mesh wants {n} devices, only {len(slots)} "
                         "available")
    return Mesh([slots[r * model:(r + 1) * model] for r in range(data)])


def default_mesh() -> Mesh:
    """All of this process's devices on the 'data' axis (throughput
    mode)."""
    devices = local_devices()
    return make_mesh(data=max(1, len(devices)), model=1, devices=devices)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> bool:
    """Join a process group if one is configured; returns True if this
    process is then part of one.

    ``coordinator_address`` ("host:port" or "tcp://host:port") is the
    rendezvous of ``torch.distributed.init_process_group``,
    ``num_processes`` its world size and ``process_id`` this process's rank.
    Without arguments it reads the environment that ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and returns
    False when there is none.  ``backend`` must be ``gloo`` (host data, any
    number of ranks a card): every collective of ``dist/`` moves host
    tensors, which ``nccl`` does not carry, so any other backend raises
    ValueError rather than being switched."""
    if backend != "gloo":
        raise ValueError(f"backend {backend!r}: the port's multi-process "
                         "paths move host tensors and run on 'gloo' only")
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        dist.init_process_group(backend, init_method="env://")
        return True
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    if num_processes is None or process_id is None:
        raise ValueError("an address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
    return True


def multihost_mesh(model_per_host: int = 1,
                   local: Optional[Sequence] = None) -> Mesh:
    """(data, model) mesh for several processes: the model axis within a
    process, the data axis across processes.  ``local`` is this process's
    devices (its CUDA devices by default); every process must give as
    many."""
    slots = global_devices(local)
    model = max(1, model_per_host)
    by_rank = {}
    for s in slots:
        by_rank.setdefault(s.rank, []).append(s)
    rows = []
    for r in sorted(by_rank):
        own = by_rank[r]
        if len(own) % model:
            raise ValueError(f"process {r} has {len(own)} devices, not a "
                             f"multiple of model_per_host={model}")
        rows += [own[i:i + model] for i in range(0, len(own), model)]
    if not rows:
        raise ValueError("mesh wants 1 device, only 0 available")
    return Mesh(rows)
