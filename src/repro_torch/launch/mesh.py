"""Device partitioning for the virtual fleet (port of
``repro/launch/mesh.py::partition_devices``).

The reference's other builders (``make_production_mesh``,
``make_test_mesh``, ``make_submesh``, ``dp_axes``, ``tp_axis``,
``dp_size``) build and read XLA device meshes for SPMD partitioning; one
H100 runs no mesh, so they have no counterpart here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


def visible_devices() -> List[torch.device]:
    """Every visible card, ``cuda:0`` .. ``cuda:<n-1>``; raises without
    one (:func:`repro_torch.device.resolve_device`)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def partition_devices(n_hosts: int, devices: Optional[Sequence] = None
                      ) -> List[Tuple]:
    """Split ``devices`` (default: every visible card) into ``n_hosts``
    equal contiguous groups; a ``ValueError`` when the count does not
    divide.  A list may name one device more than once."""
    devices = list(devices if devices is not None else visible_devices())
    if n_hosts < 1 or len(devices) % n_hosts != 0:
        raise ValueError(
            f"cannot split {len(devices)} devices into {n_hosts} equal "
            f"virtual hosts")
    per = len(devices) // n_hosts
    return [tuple(devices[i * per:(i + 1) * per]) for i in range(n_hosts)]
