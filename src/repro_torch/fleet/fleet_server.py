"""FleetServer: the continuous-batching Server on every host of a fleet
(port of ``repro/fleet/fleet_server.py``).

One :class:`repro_torch.launch.server.Server` per host, each on its host's
Engine with its own telemetry Registry; requests are routed round-robin at
submit and every host decodes its own lockstep batch.  Each host's token
streams are bit-identical to those of a single-host Server fed that host's
requests — the oracle the fleet tests assert against.  They equal one
Server's fed every request only where a request's stream does not depend
on its batch mates: with the fabric off.  Under a fabric a decode step
quantizes its activations per tensor, over every slot of the batch, and
routing changes the batches.

Per-tick host wall times feed the fleet :class:`StragglerMonitor` with real
per-host entries (only hosts that actually decoded a tick report — idle
hosts must not drag the fleet median toward zero), and
:meth:`FleetServer.slos` reads the SLO trio off the MERGED registry view, so
fleet TTFT/TPOT percentiles are exact as-if-one-registry numbers.

Params are copied to each host's device once, at construction; a host on
the params' own device serves the same tensors (serving writes no param).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.fleet.fleet_engine import FleetEngine
from repro_torch.launch.server import Handle, Request, Server
from repro_torch.telemetry import clock, serving_slos
from repro_torch.tree import tree_map

__all__ = ["FleetServer"]


class FleetServer:
    """Route -> per-host Server -> merged telemetry.  Same submit/poll/drain
    surface as :class:`repro_torch.launch.server.Server`, fleet-wide."""

    def __init__(self, cfg, params, fleet: FleetEngine, **server_kw):
        self.fleet = fleet
        self.attn_impl = None
        self.servers: Dict[int, Server] = {}
        for h in fleet.active_hosts():
            dev = fleet.host(h).device
            srv = Server(cfg, tree_map(lambda x: x.to(dev), params),
                         engine=fleet.engine(h), host=h, **server_kw)
            self.servers[h] = srv
            self.attn_impl = srv.attn_impl
        self._order = list(self.servers)
        self._rr = 0
        self.handles: List[Handle] = []

    @property
    def n_hosts(self) -> int:
        return len(self.servers)

    # ----------------------------------------------------------- public API
    def submit(self, request: Request) -> Handle:
        """Round-robin a request onto the next host's admission queue."""
        h = self._order[self._rr % len(self._order)]
        self._rr += 1
        handle = self.servers[h].submit(request)
        handle.host = h  # fleet-side tag (per-host Handles count rids alone)
        self.handles.append(handle)
        return handle

    def poll(self) -> List[Handle]:
        """One fleet tick: every host admits + decodes one lockstep step.

        Hosts that decoded this tick feed their wall time to the fleet
        straggler monitor as one ``record_step`` call with real per-host
        entries."""
        finished: List[Handle] = []
        times: Dict[int, float] = {}
        for h, srv in self.servers.items():
            ticks0 = srv.decode_ticks
            t0 = clock()
            finished.extend(srv.poll())
            if srv.decode_ticks > ticks0:  # it really ran a decode step
                times[h] = clock() - t0
        if times:
            self.fleet.observe_step_times(times)
        return finished

    def drain(self) -> List[Handle]:
        """Serve everything everywhere; returns handles in submit order."""
        while any(srv.queued or any(srv.active)
                  for srv in self.servers.values()):
            self.poll()
        return list(self.handles)

    # ------------------------------------------------------------ telemetry
    def slos(self) -> Dict:
        """Fleet SLO trio off the merged (exact) registry view."""
        return serving_slos(self.fleet.merged_registry(),
                            attn_impl=self.attn_impl, n_hosts=self.n_hosts)

    def total_decode_s(self) -> float:
        return sum(srv.decode_s for srv in self.servers.values())
