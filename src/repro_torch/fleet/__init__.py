"""Fleet subsystem: many Engines under one controller (port of
``repro.fleet``).

  coordinator     — who am I / rendezvous: ``DistributedCoordinator``
                    (torch.distributed) and ``LocalCoordinator`` (in-process
                    virtual fleet over a device list, CPU-testable).
  fleet_engine    — per-host Engines + fleet StragglerMonitor +
                    ``FleetTrainLoop`` (straggler shrink + checkpoint-resume
                    over the existing FaultTolerantLoop).
  fleet_server    — per-host Servers, round-robin routing, merged SLOs.
  telemetry_merge — tagged per-host Registry snapshots -> one exact fleet
                    view (``Registry.merge``).
"""
from repro_torch.fleet.coordinator import (Coordinator,
                                           DistributedCoordinator,
                                           FleetHost, LocalCoordinator)
from repro_torch.fleet.fleet_engine import (FleetEngine, FleetTrainLoop,
                                            HostStragglerError)
from repro_torch.fleet.fleet_server import FleetServer
from repro_torch.fleet.telemetry_merge import (fleet_slos, merge_registries,
                                               merge_tagged, tagged_snapshot)

__all__ = [
    "Coordinator", "DistributedCoordinator", "FleetHost", "LocalCoordinator",
    "FleetEngine", "FleetTrainLoop", "HostStragglerError", "FleetServer",
    "fleet_slos", "merge_registries", "merge_tagged", "tagged_snapshot",
]
