"""Fault-tolerant step loop: checkpoint/restart with failure injection (port
of ``repro/runtime/fault_tolerance.py``).

Wraps any (state, batch, step) -> state step function with:
  * periodic async checkpointing (atomic publish via
    :mod:`repro_torch.checkpoint.checkpoint`),
  * automatic resume from the latest committed step after a crash,
  * a failure-injection hook (tests and chaos drills) that raises at chosen
    steps to prove recovery restores bit-exact state and data cursor,
  * straggler monitor integration — by default the loop feeds its own wall
    time as host 0; a fleet loop overrides ``host_times_fn`` so the monitor
    sees REAL per-host entries, and ``on_straggler`` escalates newly flagged
    hosts to the supervisor (the fleet loop raises there, shrinks the plan,
    and re-enters ``run`` — which resumes from the latest checkpoint),
  * telemetry: ``fault.failures`` / ``fault.resumes`` counters and a
    ``fault.step_s`` histogram in the global registry.

:class:`InjectedFailure` is also what :class:`~repro_torch.launch.server
.Server` raises at its ``fail_at`` ticks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import clock, get_registry


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FaultTolerantLoop:
    ckpt_root: str
    step_fn: Callable[[Any, Any, int], Any]  # (state, batch, step) -> state
    batch_fn: Callable[[int], Any]  # step -> batch (random-access pipeline)
    ckpt_every: int = 50
    keep_last: int = 3
    fail_at: Optional[set] = None  # steps at which to inject a crash
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    # dt -> {host: wall_s}: what the monitor is fed each step.  None keeps
    # the single-controller default ({0: dt}); fleet loops supply the real
    # per-host times their step just measured ({} feeds nothing).
    host_times_fn: Optional[Callable[[float], Dict[int, float]]] = None
    # called with hosts the monitor NEWLY flagged this step (checkpoints are
    # flushed first, so the callback may raise to force a resume-from-ckpt)
    on_straggler: Optional[Callable[[List[int]], None]] = None

    def __post_init__(self):
        self._ckpt = AsyncCheckpointer(self.ckpt_root,
                                       keep_last=self.keep_last)
        self._failed_once: set = set()

    def resume_or_init(self, init_state):
        step = latest_step(self.ckpt_root)
        if step is None:
            return init_state, 0
        state, step = restore(self.ckpt_root, init_state)
        get_registry().counter("fault.resumes").inc()
        return state, step + 1  # a checkpoint stores the post-step state

    def run(self, init_state, n_steps: int):
        """Run to ``n_steps`` total; crashes are re-raised after a checkpoint
        flush so an external supervisor (or the test) can restart us."""
        reg = get_registry()
        state, start = self.resume_or_init(init_state)
        for step in range(start, n_steps):
            if self.fail_at and step in self.fail_at \
                    and step not in self._failed_once:
                self._failed_once.add(step)
                self._ckpt.wait()
                reg.counter("fault.failures").inc()
                raise InjectedFailure(f"injected failure at step {step}")
            t0 = clock()
            batch = self.batch_fn(step)
            # the global step rides along so per-step noise seeds (and hence
            # resumed runs) are independent of where the loop restarted
            state = self.step_fn(state, batch, step)
            dt = clock() - t0
            reg.histogram("fault.step_s").observe(dt)
            times = self.host_times_fn(dt) if self.host_times_fn else {0: dt}
            flagged = self.monitor.record_step(times) if times else []
            if flagged and self.on_straggler:
                self._ckpt.wait()  # flush so the callback can safely resume
                self.on_straggler(flagged)
            if (step + 1) % self.ckpt_every == 0 or step == n_steps - 1:
                self._ckpt.save_async(step, state)
        self._ckpt.wait()
        return state
