"""Coordinator: who am I in the fleet, and how do hosts rendezvous (port of
``repro/fleet/coordinator.py``).

The paper's 8x8 macro is one tile; one Engine on one host is the serving
analogue.  Fleet scale means many identical Engines under one controller —
this module is that controller's substrate.  Two implementations of one
small :class:`Coordinator` protocol:

  * :class:`DistributedCoordinator` — a thin wrapper over
    ``torch.distributed`` for REAL multi-process fleets: process
    index/count, a barrier (``dist.barrier``), a host-0 controller
    election, and an object all-gather (``all_gather_object``) used to ship
    per-host telemetry snapshots to the controller.  Each process drives
    exactly one :class:`FleetHost`, on ``cuda:<local rank>``.
  * :class:`LocalCoordinator` — an in-process **virtual fleet**: a device
    list is partitioned into ``n_hosts`` contiguous groups.  A list may
    name one device more than once: ``["cuda:0", "cuda:0"]`` is two virtual
    hosts on one card, ``["cpu", "cpu"]`` the CPU tests' fleet (the
    counterpart of the reference's forced host-device count).  One Python
    process drives every virtual host, so the multi-host control flow —
    per-host step times into the straggler monitor, telemetry merge on the
    controller, shrink/resume after a flagged host — runs without spawning
    processes.

A virtual host is a tuple of torch devices; its Engine runs on the first
(:attr:`FleetHost.device`).  There are no sub-meshes: ``model_parallel``
only enters the :class:`~repro_torch.runtime.elastic.MeshPlan` arithmetic
of a straggler shrink.

Both sides agree on the contract the fleet engine/server layers consume:
``hosts()`` (the hosts THIS process drives), ``process_count``,
``controller`` / ``is_controller``, ``barrier(tag)``, and
``all_gather(per_host)`` returning the full fleet view on every caller.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import partition_devices


@dataclass(frozen=True)
class FleetHost:
    """One host's identity: its fleet-wide index and its devices."""

    index: int
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """The device this host's Engine runs on (its first)."""
        return self.devices[0]

    @property
    def n_devices(self) -> int:
        return len(self.devices)


class Coordinator:
    """Protocol (duck-typed; both implementations subclass for isinstance
    convenience, but the fleet layers only rely on the methods below)."""

    def hosts(self) -> List[FleetHost]:
        """The hosts this process drives (1 for distributed, N for local)."""
        raise NotImplementedError

    @property
    def process_count(self) -> int:
        raise NotImplementedError

    @property
    def controller(self) -> int:
        """Host index elected controller (host 0 by convention)."""
        return 0

    def is_controller(self) -> bool:
        """Does this process drive the controller host?"""
        return any(h.index == self.controller for h in self.hosts())

    def barrier(self, tag: str) -> None:
        raise NotImplementedError

    def all_gather(self, per_host: Dict[int, Any]) -> Dict[int, Any]:
        """Combine each process's {host_index: obj} into the fleet view."""
        raise NotImplementedError


class LocalCoordinator(Coordinator):
    """In-process virtual fleet: N hosts over a device list.

    ``LocalCoordinator(2)`` splits every visible card into two hosts (and
    raises with one card: nothing quietly shares a device);
    ``LocalCoordinator(2, devices=["cuda:0", "cuda:0"])`` asks for two
    hosts on one card.  Every cross-host primitive is trivial (one process,
    synchronous), which is the point: the *control flow* above it —
    per-host Engines, merged registries, straggler shrink — is identical to
    the distributed path.
    """

    def __init__(self, n_hosts: int, *, devices: Optional[Sequence] = None,
                 model_parallel: int = 2):
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
        self.model_parallel = model_parallel
        self._hosts = [FleetHost(i, devs) for i, devs in
                       enumerate(partition_devices(n_hosts, devices))]

    def hosts(self) -> List[FleetHost]:
        return list(self._hosts)

    @property
    def process_count(self) -> int:
        return 1

    def barrier(self, tag: str) -> None:  # one process: always in sync
        return None

    def all_gather(self, per_host: Dict[int, Any]) -> Dict[int, Any]:
        return dict(per_host)

    def drop_host(self, index: int) -> FleetHost:
        """Remove a virtual host from the fleet (straggler shrink)."""
        for i, h in enumerate(self._hosts):
            if h.index == index:
                return self._hosts.pop(i)
        raise KeyError(f"no virtual host {index}")


class DistributedCoordinator(Coordinator):
    """Thin wrapper over ``torch.distributed`` for real multi-process fleets.

    ``initialize=True`` calls ``init_process_group`` — ``nccl`` when this
    host's device is a card, ``gloo`` on the CPU — at
    ``coordinator_address`` (an ``init_method`` URL: ``tcp://host:port`` or
    ``file:///path``; default ``env://``), with ``num_processes`` /
    ``process_id`` as world size and rank (default: the environment's).
    Pass ``initialize=False`` when the runtime already did; with no process
    group at all this is process 0 of 1 and every primitive is local.

    ``device`` is this process's host device: ``None`` means
    ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank), raising without
    a card; pass ``"cpu"`` for a CPU fleet.  :meth:`close` destroys a
    process group this coordinator created.
    """

    def __init__(self, *, initialize: bool = False,
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device: DeviceLike = None):
        import torch.distributed as dist

        if device is None:
            rank = process_id if process_id is not None \
                else os.environ.get("RANK", 0)
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's object collectives use it
        self._owns = False
        if initialize:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=coordinator_address,
                world_size=-1 if num_processes is None else num_processes,
                rank=-1 if process_id is None else process_id)
            self._owns = True
        self._dist = dist if dist.is_available() and dist.is_initialized() \
            else None
        self._index = self._dist.get_rank() if self._dist else 0
        self._count = self._dist.get_world_size() if self._dist else 1
        self._host = FleetHost(self._index, (dev,))

    def hosts(self) -> List[FleetHost]:
        return [self._host]

    @property
    def process_count(self) -> int:
        return self._count

    def barrier(self, tag: str) -> None:
        if self._dist is not None:
            self._dist.barrier()

    def all_gather(self, per_host: Dict[int, Any]) -> Dict[int, Any]:
        """Gather one picklable object per process (telemetry snapshots)."""
        if self._dist is None:
            return dict(per_host)
        objs = [None] * self._count
        self._dist.all_gather_object(objs, per_host.get(self._index))
        return dict(enumerate(objs))

    def close(self) -> None:
        """Destroy the process group if this coordinator created it."""
        if self._owns:
            self._dist.destroy_process_group()
            self._owns = False
            self._dist = None
