"""Fault-tolerant step loop: checkpoint/restart with failure injection (port
of ``repro/runtime/fault_tolerance.py``).

Wraps any (state, batch, step) -> state step function with:
  * periodic async checkpointing (atomic publish via
    :mod:`repro_torch.checkpoint.checkpoint`),
  * automatic resume from the latest committed step after a crash,
  * a failure-injection hook (tests and chaos drills) that raises at chosen
    steps to prove recovery restores bit-exact state and data cursor,
  * the straggler monitor, fed the loop's own wall time as host 0 (the
    reference's per-host ``host_times_fn`` and ``on_straggler`` hooks and
    its ``metrics_cb`` serve its virtual fleet and come with the fleet's
    port),
  * telemetry: ``fault.failures`` / ``fault.resumes`` counters and a
    ``fault.step_s`` histogram in the global registry.

:class:`InjectedFailure` is also what :class:`~repro_torch.launch.server
.Server` raises at its ``fail_at`` ticks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

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
            self.monitor.record_step({0: dt})
            if (step + 1) % self.ckpt_every == 0 or step == n_steps - 1:
                self._ckpt.save_async(step, state)
        self._ckpt.wait()
        return state
