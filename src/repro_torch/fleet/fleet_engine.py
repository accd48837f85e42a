"""FleetEngine + FleetTrainLoop: the Engine/loop stack on every host (port
of ``repro/fleet/fleet_engine.py``).

:class:`FleetEngine` owns one :class:`repro_torch.launch.engine.Engine` per
host the coordinator drives — each on its host's device, with its own step
cache, CUDA graphs and telemetry :class:`Registry` — plus ONE fleet-level
:class:`StragglerMonitor` fed with real per-host step times.
:meth:`FleetEngine.merged_registry` is the controller's one fleet telemetry
view (exact histogram merge; see :mod:`repro_torch.fleet.telemetry_merge`).
:meth:`FleetEngine.total_traces` and :meth:`FleetEngine.traces_by_host`
count each Engine's step builds and graph captures (bindings on the CPU):
the port's recapture detector, where the reference counts jit traces.

:class:`FleetTrainLoop` composes the existing pieces instead of re-inventing
them:

  * the inner loop IS
    :class:`repro_torch.runtime.fault_tolerance.FaultTolerantLoop` —
    checkpoint cadence, resume-from-latest, telemetry — with its
    ``host_times_fn`` supplying the per-host wall times the fleet step just
    measured and ``on_straggler`` escalating newly flagged hosts;
  * the escalation path is
    :func:`repro_torch.runtime.elastic.shrink_after_failure` — the flagged
    host's devices leave the plan (whole-host units, per-replica batch
    preserved), the monitor forgets the host
    (:meth:`StragglerMonitor.replace_host`), and the supervisor re-enters
    ``FaultTolerantLoop.run``, which resumes from the latest committed
    checkpoint.  Surviving hosts keep their step caches, so the resumed
    steps build nothing new.

A host's first step is its warm-up and is not fed to the monitor: the
hosts share one process, whose one-time costs (library handles, the
allocator's growth) all land on the first host to step, where the
reference's hosts each pay their own compile.

Each host steps its own state replica on its own device.  A replica is the
state moved to the host's device once (``Tensor.to``): the train step is
functional (it returns new tensors and writes none of its inputs), so hosts
on one device read the same tensors, as the reference's hosts read one
uncommitted host array.  Checkpoints store the controller's replica, so any
surviving host can re-fan-out from a restore.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.fleet.coordinator import Coordinator, LocalCoordinator
from repro_torch.fleet.telemetry_merge import merge_registries, tagged_snapshot
from repro_torch.launch.engine import Engine
from repro_torch.runtime.elastic import MeshPlan, shrink_after_failure
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor
from repro_torch.telemetry import Registry, clock
from repro_torch.tree import tree_map

__all__ = ["FleetEngine", "FleetTrainLoop", "HostStragglerError"]


class HostStragglerError(RuntimeError):
    """Raised out of the inner loop when the monitor flags hosts; carries
    the host indices so the supervisor can shrink around them."""

    def __init__(self, hosts: List[int]):
        super().__init__(f"straggling hosts flagged for removal: {hosts}")
        self.hosts = list(hosts)


class FleetEngine:
    """One Engine per driven host, one fleet monitor, one merged telemetry
    view.

    ``noise_seed`` is shared across hosts on purpose: in the replicated
    control-plane model every host mixes the same seed stream, so per-host
    outputs stay bit-identical (the fleet-vs-single-host tests rely on it).
    An Engine that cannot build or capture raises; nothing falls back.
    """

    def __init__(self, coordinator: Coordinator, *, noise_seed: int = 0,
                 straggler_cfg: Optional[StragglerConfig] = None):
        self.coordinator = coordinator
        self.monitor = StragglerMonitor(
            cfg=straggler_cfg or StragglerConfig())
        self.engines: Dict[int, Engine] = {
            h.index: Engine(device=h.device, noise_seed=noise_seed,
                            registry=Registry())
            for h in coordinator.hosts()}
        self._hosts = {h.index: h for h in coordinator.hosts()}
        self._active = sorted(self.engines)
        self.removed: List[int] = []

    # ------------------------------------------------------------ topology
    def active_hosts(self) -> List[int]:
        return list(self._active)

    @property
    def controller(self) -> int:
        """The controller host (host 0, or its successor after a shrink)."""
        c = self.coordinator.controller
        return c if c in self._active else self._active[0]

    def host(self, index: int):
        return self._hosts[index]

    def engine(self, index: int) -> Engine:
        return self.engines[index]

    def remove_host(self, index: int) -> None:
        """Shrink path: the host leaves the fleet (its Engine is retired,
        its monitor entry + EWMA gauge are dropped).  Its Registry is kept —
        history already recorded still merges into the fleet view."""
        self._active.remove(index)
        self.removed.append(index)
        self.monitor.replace_host(index)
        if isinstance(self.coordinator, LocalCoordinator):
            self.coordinator.drop_host(index)

    # ----------------------------------------------------------- telemetry
    def observe_step_times(self, times: Dict[int, float]) -> List[int]:
        """Feed ONE step's per-host wall times; returns newly flagged hosts.

        Call once per fleet step with the full dict — feeding hosts one at a
        time would multiply the monitor's strike cadence by the fleet size.
        """
        return self.monitor.record_step(times)

    def snapshots(self) -> Dict[int, Dict]:
        """Per-host tagged snapshots (driven hosts only; gather for all)."""
        return {h: tagged_snapshot(self.engines[h].registry, h)
                for h in sorted(self.engines)}

    def merged_registry(self) -> Registry:
        """The fleet telemetry view (exact merge across per-host feeds)."""
        return merge_registries(
            {h: e.registry for h, e in self.engines.items()},
            self.coordinator)

    # --------------------------------------------------------------- stats
    def total_traces(self) -> int:
        """Step builds and graph captures over every host's Engine."""
        return sum(self.traces_by_host().values())

    def traces_by_host(self) -> Dict[int, int]:
        return {h: e.stats.compiles + e.stats.captures
                for h, e in self.engines.items()}


@dataclass
class FleetTrainLoop:
    """Run the fault-tolerant train loop on every host of a fleet.

    ``make_step(engine, host) -> (state, batch, step) -> state`` builds the
    per-host step callable once; it must return only once its step is done
    on the device (the trainer's reads its metrics back), so the host's
    wall time is device-complete.  ``delay(host, step) -> extra_s`` injects
    synthetic per-host skew into the *observed* times — chaos drills flag a
    straggler without sleeping through real seconds.  Each host's measured
    step times (without the skew) land in its registry's ``fleet.step_s``.
    """

    fleet: FleetEngine
    ckpt_root: str
    make_step: Callable[[Engine, int], Callable[[Any, Any, int], Any]]
    batch_fn: Callable[[int], Any]
    plan: MeshPlan
    model_parallel: int = 2
    ckpt_every: int = 2
    delay: Optional[Callable[[int, int], float]] = None
    shrinks: List[MeshPlan] = field(default_factory=list)

    def __post_init__(self):
        self._steps = {h: self.make_step(self.fleet.engine(h), h)
                       for h in self.fleet.active_hosts()}
        self._replicas: Dict[int, Any] = {}
        self._last_times: Dict[int, float] = {}
        self._warm: set = set()  # hosts past their first (warm-up) step

    # ------------------------------------------------------------ plumbing
    def _fan_out(self, state, host: int):
        """``state`` on ``host``'s device (the same tensors when it is
        there already)."""
        dev = self.fleet.host(host).device
        return tree_map(lambda x: x.to(dev), state)

    def _fleet_step(self, state, batch, step):
        times: Dict[int, float] = {}
        for h in self.fleet.active_hosts():
            rep = self._replicas.get(h)
            if rep is None:
                rep = self._fan_out(state, h)
            t0 = clock()
            rep = self._steps[h](rep, batch, step)
            dt = clock() - t0
            self.fleet.engine(h).registry.histogram("fleet.step_s").observe(dt)
            if self.delay is not None:
                dt += self.delay(h, step)
            times[h] = dt
            self._replicas[h] = rep
        self._last_times = {h: t for h, t in times.items() if h in self._warm}
        self._warm.update(times)
        return self._replicas[self.fleet.controller]

    def _handle_stragglers(self, hosts: List[int]):
        lost = sum(self.fleet.host(h).n_devices for h in hosts)
        self.plan = shrink_after_failure(self.plan, lost,
                                         model_parallel=self.model_parallel)
        self.shrinks.append(self.plan)
        for h in hosts:
            self.fleet.remove_host(h)
            self._steps.pop(h, None)
        # every replica re-fans-out from the restored checkpoint: survivors
        # replay the post-checkpoint steps bit-identically to a fleet that
        # never contained the straggler
        self._replicas.clear()

    # ----------------------------------------------------------------- run
    def run(self, init_state, n_steps: int):
        """Train to ``n_steps``; flagged hosts shrink the plan and the loop
        resumes from the latest committed checkpoint.  Returns the
        controller replica's final state."""

        def escalate(flagged):
            raise HostStragglerError(flagged)

        while True:
            loop = FaultTolerantLoop(
                self.ckpt_root, self._fleet_step, self.batch_fn,
                ckpt_every=self.ckpt_every, monitor=self.fleet.monitor,
                host_times_fn=lambda dt: dict(self._last_times),
                on_straggler=escalate)
            try:
                return loop.run(init_state, n_steps)
            except HostStragglerError as e:
                if len(self.fleet.active_hosts()) <= len(e.hosts):
                    raise  # nothing left to shrink onto
                self._handle_stragglers(e.hosts)
                self.fleet.coordinator.barrier("fleet.shrink")
