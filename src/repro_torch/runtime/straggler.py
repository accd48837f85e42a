"""Straggler detection and mitigation policy (port of
``repro/runtime/straggler.py``).

At fleet scale, slow hosts (thermal throttling, failing memory, noisy
neighbours) stretch every synchronous step.  The monitor keeps an EWMA of
per-host step times and flags hosts exceeding ``threshold`` x the fleet
median for ``patience`` consecutive steps; the policy layer then requests a
hot-spare swap.  Host-side logic only, no device code, so the port keeps the
reference's own: :class:`~repro_torch.launch.engine.Engine` feeds it each
decode step's device-complete wall time.

Telemetry, in :func:`repro_torch.telemetry.get_registry`'s registry:
``straggler.ewma_s.host<h>`` (gauge per host) and ``straggler.swaps``
(counter of hosts flagged).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.telemetry import get_registry


def _median(values: List[float]) -> float:
    """True median: the midpoint of the two central elements for even counts
    (the upper-middle element would raise the swap threshold exactly when
    the upper half is slow, and let stragglers hide)."""
    s = sorted(values)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


@dataclass
class StragglerConfig:
    threshold: float = 1.5  # x median step time
    patience: int = 3
    ewma: float = 0.7


@dataclass
class HostStats:
    ewma_time: float = 0.0
    strikes: int = 0
    flagged: bool = False


@dataclass
class StragglerMonitor:
    cfg: StragglerConfig = field(default_factory=StragglerConfig)
    hosts: Dict[int, HostStats] = field(default_factory=dict)
    swaps: List[int] = field(default_factory=list)

    def record_step(self, times: Dict[int, float]) -> List[int]:
        """Feed per-host wall times for one step; returns hosts to replace."""
        reg = get_registry()
        for h, t in times.items():
            st = self.hosts.setdefault(h, HostStats(ewma_time=t))
            st.ewma_time = self.cfg.ewma * st.ewma_time + (1 - self.cfg.ewma) * t
            reg.gauge(f"straggler.ewma_s.host{h}").set(st.ewma_time)
        med = _median([s.ewma_time for s in self.hosts.values()])
        to_swap = []
        for h, st in self.hosts.items():
            if st.ewma_time > self.cfg.threshold * med:
                st.strikes += 1
                if st.strikes >= self.cfg.patience and not st.flagged:
                    st.flagged = True
                    to_swap.append(h)
            else:
                st.strikes = 0
        if to_swap:
            reg.counter("straggler.swaps").inc(len(to_swap))
        self.swaps.extend(to_swap)
        return to_swap

    def replace_host(self, host: int):
        """Hot-spare swap completed (or the host left the fleet): forget the
        slot's stats entirely.

        The entry is dropped, not zeroed: a zeroed EWMA would bias the fleet
        median low until it warms back up, and make the swapped-in host's
        EWMA climb from 0 instead of its first real sample.  With the entry
        gone, :meth:`record_step` re-seeds it from the first post-swap
        sample, as a new host enters.  The host's gauge is zeroed too.
        """
        self.hosts.pop(host, None)
        get_registry().gauge(f"straggler.ewma_s.host{host}").set(0.0)
