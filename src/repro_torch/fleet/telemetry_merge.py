"""Fleet telemetry: per-host Registry snapshots -> one merged fleet view
(port of ``repro/fleet/telemetry_merge.py``).

Each host records into its OWN :class:`repro_torch.telemetry.Registry`
(recording stays host-side and lock-free across the fleet); the controller
pulls snapshots — tagged with the producing host's index — through the
coordinator's ``all_gather`` and merges them with
:meth:`repro_torch.telemetry.Registry.merge`:

  * counters sum, gauge values sum, gauge high-waters take the max,
  * histogram **bucket counts add exactly** (snapshots carry their sparse
    bucket state), so fleet p50/p95/p99 are *as-if-one-registry* — not an
    average of per-host percentiles, which is a different (and wrong)
    statistic.

``serving_slos(merged_registry, n_hosts=...)`` consumes the merged view; the
raw tagged snapshots stay available for per-host drill-down (the straggler
gauges ``straggler.ewma_s.host*`` are already per-host named, so they survive
the merge unaliased).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.telemetry import Registry, serving_slos, snapshot

__all__ = ["tagged_snapshot", "merge_tagged", "merge_registries",
           "fleet_slos"]


def tagged_snapshot(registry: Registry, process_index: int) -> Dict:
    """One host's snapshot, stamped with who produced it."""
    snap = snapshot(registry)
    snap["process_index"] = process_index
    return snap


def merge_tagged(snaps: Iterable[Dict]) -> Tuple[Registry, Dict[int, Dict]]:
    """Merge tagged snapshots -> (merged Registry, {process_index: snap}).

    Order-insensitive: snapshots are merged in process-index order so the
    controller's merged view is deterministic regardless of gather order.
    Untagged snapshots (single-host callers) merge under index -1.
    """
    by_host = {s.get("process_index", -1): s for s in snaps}
    ordered = [by_host[i] for i in sorted(by_host)]
    merged = Registry.merge(*[
        {k: v for k, v in s.items() if k != "process_index"}
        for s in ordered])
    return merged, by_host


def merge_registries(per_host: Dict[int, Registry],
                     coordinator=None) -> Registry:
    """Snapshot + tag every host registry, gather, and merge.

    ``coordinator=None`` merges locally (virtual fleet / tests); with a
    coordinator the tagged snapshots travel through ``all_gather`` so every
    process — controller included — ends up with the same fleet view.
    """
    tagged = {h: tagged_snapshot(reg, h) for h, reg in per_host.items()}
    if coordinator is not None:
        tagged = coordinator.all_gather(tagged)
    merged, _ = merge_tagged(tagged.values())
    return merged


def fleet_slos(per_host: Dict[int, Registry], *, attn_impl: Optional[str]
               = None, coordinator=None) -> Dict:
    """Serving SLOs over the merged fleet view, tagged with ``n_hosts``."""
    merged = merge_registries(per_host, coordinator)
    return serving_slos(merged, attn_impl=attn_impl,
                        n_hosts=len(per_host))
