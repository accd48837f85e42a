"""Named metrics: Counter / Gauge / Histogram behind a process-global Registry.

The source paper's headline claims are *measurements* (0.7 ns latency,
56.56 fJ/bit, 15.8 M ops/s); this module is how the serving stack measures its
own analogues — step times, TTFT/TPOT, cache hit rates, block-pool occupancy —
without printf scatter or per-class ad-hoc counters.

Design constraints (they shape everything below):

  * **host-side only** — metrics record plain Python floats the caller already
    has.  Nothing here touches a device tensor, so recording can never add a
    host<->device sync to a decode step.
  * **cheap enough for decode loops** — the record path is one attribute load,
    one branch, and a few float ops.  With the registry disabled it is the
    branch alone: ``if not enabled: return`` allocates nothing and touches no
    metric state, so telemetry can stay compiled into hot loops.
  * **fixed log-spaced buckets** — histograms never store samples.  Bucket
    edges are ``10**(i / per_decade)`` spanning ``lo..hi``, so memory is
    constant, merging is addition, and p50/p95/p99 come from bucket
    interpolation with bounded relative error (~``10**(1/per_decade) - 1``).
  * **process-global registry** — one :func:`get_registry` instance by
    default, so the Engine, Server, and runtime loops all land in one
    snapshot; components still accept an explicit :class:`Registry` for
    isolation (benchmarks time separate runs, tests avoid cross-talk).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "set_enabled"]


class Counter:
    """Monotonic count (events, tokens, cache hits)."""

    __slots__ = ("name", "_reg", "value")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if not self._reg.enabled:
            return
        self.value += n

    def zero(self) -> None:
        self.value = 0

    def summary(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins level (queue depth, pool occupancy) + high-water mark."""

    __slots__ = ("name", "_reg", "value", "hwm")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self.value = 0.0
        self.hwm = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.value = v
        if v > self.hwm:
            self.hwm = v

    def zero(self) -> None:
        self.value = 0.0
        self.hwm = 0.0

    def summary(self) -> Dict[str, float]:
        return {"value": self.value, "hwm": self.hwm}


class Histogram:
    """Fixed log-spaced buckets over ``[lo, hi]`` + count/sum/min/max.

    Built for durations in seconds: the default span 1 µs .. 1000 s at 9
    buckets/decade (81 buckets) estimates percentiles within ~15% relative
    error, which is plenty to tell a 0.9 ms decode step from a 1.3 ms one.
    Values outside the span clamp into the edge buckets (min/max stay exact).
    """

    __slots__ = ("name", "_reg", "lo", "per_decade", "_log_lo", "_nbuckets",
                 "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str, reg: "Registry", *, lo: float = 1e-6,
                 hi: float = 1e3, per_decade: int = 9,
                 nbuckets: Optional[int] = None):
        if lo <= 0 or (nbuckets is None and hi <= lo):
            raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
        self.name = name
        self._reg = reg
        self.lo = lo
        self.per_decade = per_decade
        self._log_lo = math.log10(lo)
        if nbuckets is None:  # explicit count: exact reconstruction on merge
            decades = math.log10(hi) - self._log_lo
            nbuckets = max(1, math.ceil(decades * per_decade))
        self._nbuckets = nbuckets
        self.zero()

    def zero(self) -> None:
        self.buckets = [0] * self._nbuckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.lo:
            i = 0
        else:
            i = int((math.log10(v) - self._log_lo) * self.per_decade)
            if i >= self._nbuckets:
                i = self._nbuckets - 1
        self.buckets[i] += 1

    def _edges(self, i: int):
        lo = 10.0 ** (self._log_lo + i / self.per_decade)
        hi = 10.0 ** (self._log_lo + (i + 1) / self.per_decade)
        return lo, hi

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; linear interpolation inside the covering bucket,
        clamped to the exact observed min/max (tight for small samples)."""
        if self.count == 0:
            return None
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            cum += c
            if cum >= target:
                lo, hi = self._edges(i)
                lo, hi = max(lo, self.min), min(hi, self.max)
                frac = (target - (cum - c)) / c
                return lo + frac * (hi - lo)
        return self.max

    def summary(self) -> Dict[str, Optional[float]]:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                # bucket state rides along (sparse, JSON-keyed) so fleet
                # merges are EXACT: addition of bucket counts loses nothing.
                "lo": self.lo, "per_decade": self.per_decade,
                "nbuckets": self._nbuckets,
                "buckets": {str(i): c for i, c in enumerate(self.buckets)
                            if c}}


class Registry:
    """Named metric store.  ``enabled=False`` turns every record into a no-op
    branch; creation/lookup still works, so instrumented code needs no guards.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, self, **kw)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    # ------------------------------------------------------------- control
    @contextlib.contextmanager
    def disabled(self):
        prev, self.enabled = self.enabled, False
        try:
            yield self
        finally:
            self.enabled = prev

    def reset(self) -> None:
        """Zero every metric IN PLACE (benchmark waves, test isolation).

        Identity-preserving on purpose: instrumented components cache their
        metric handles at construction, so resetting must not orphan them
        from the snapshot.
        """
        with self._lock:
            for m in self._metrics.values():
                m.zero()

    # --------------------------------------------------------------- merge
    @classmethod
    def merge(cls, *snapshots: Dict) -> "Registry":
        """Rebuild ONE registry from many :meth:`snapshot` dicts (fleet view).

        Merge semantics, chosen so a merged registry reads as-if every host
        had fed a single registry:

          * counters — sum (events are events on every host).
          * gauges   — ``value`` sums (levels add across hosts: queue depths,
            tokens/s), ``hwm`` takes the max (the worst single-host pressure;
            a fleet-wide summed high-water would pin moments that never
            co-occurred).
          * histograms — **exact** bucket addition: every snapshot carries
            its sparse bucket counts plus (lo, per_decade, nbuckets), so the
            merged percentiles equal the percentiles of a single histogram
            fed the concatenated samples.  Mismatched bucket layouts under
            one name raise instead of silently blending.

        Identity holds: ``Registry.merge(snap)`` snapshots back to ``snap``.
        """
        reg = cls()
        for snap in snapshots:
            for name, v in snap.get("counters", {}).items():
                reg.counter(name).value += v
            for name, g in snap.get("gauges", {}).items():
                gauge = reg.gauge(name)
                gauge.value += g["value"]
                gauge.hwm = max(gauge.hwm, g["hwm"])
            for name, h in snap.get("histograms", {}).items():
                if not h.get("count"):
                    reg.histogram(name)
                    continue
                hist = reg._get(name, Histogram, lo=h["lo"],
                                per_decade=h["per_decade"],
                                nbuckets=h["nbuckets"])
                layout = (h["lo"], h["per_decade"], h["nbuckets"])
                if hist.count == 0 and \
                        (hist.lo, hist.per_decade, hist._nbuckets) != layout:
                    # an earlier empty snapshot pinned the default layout;
                    # the first populated one is authoritative
                    hist = reg._metrics[name] = Histogram(
                        name, reg, lo=h["lo"], per_decade=h["per_decade"],
                        nbuckets=h["nbuckets"])
                if (hist.lo, hist.per_decade, hist._nbuckets) != layout:
                    raise ValueError(
                        f"histogram {name!r}: bucket layout mismatch across "
                        f"snapshots — cannot merge exactly")
                for i, c in h["buckets"].items():
                    hist.buckets[int(i)] += c
                hist.count += h["count"]
                hist.sum += h["sum"]
                hist.min = min(hist.min, h["min"])
                hist.max = max(hist.max, h["max"])
        return reg

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Dict]:
        """Explicit, pull-based export: {counters, gauges, histograms}.

        Recording never serializes anything; this is the one place metric
        state is read out, so the hot path stays write-only.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms"}[type(m)]
            out[kind][name] = m.summary()
        return out


_GLOBAL = Registry()


def get_registry() -> Registry:
    """The process-global registry (the default feed for every component)."""
    return _GLOBAL


def set_enabled(flag: bool) -> None:
    """Flip the global registry's record path on/off."""
    _GLOBAL.enabled = flag
