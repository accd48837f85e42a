"""Snapshot exporters: JSON dicts, markdown tables, and bench-record merge
(port of ``repro/telemetry/export.py``; pure Python, the same output byte for
byte).

Snapshots are explicit and pull-based — nothing here runs unless called, so
the record path (see :mod:`repro_torch.telemetry.registry`) stays
write-only.  Three consumers:

  * ``snapshot()``      — the raw {counters, gauges, histograms} dict
                          (JSON-serializable as-is).
  * ``to_markdown()``   — human-readable tables for job summaries / logs.
  * ``merge_into_bench()`` — attach the snapshot to a bench record, so serve
                          rows carry their TTFT/TPOT/occupancy alongside
                          tokens/s and two runs can be diffed.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.telemetry.registry import Registry, get_registry

__all__ = ["snapshot", "to_markdown", "merge_into_bench", "write_json",
           "serving_slos"]


def snapshot(registry: Optional[Registry] = None) -> Dict:
    """JSON-serializable state of every metric in ``registry`` (global
    default)."""
    return (registry or get_registry()).snapshot()


def write_json(path: str, registry: Optional[Registry] = None) -> str:
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1)
    return path


def _fmt(v, scale: float = 1.0) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v * scale:.4g}"
    return str(v)


def to_markdown(snap: Optional[Dict] = None,
                registry: Optional[Registry] = None) -> str:
    """Markdown tables (counters+gauges, then histogram percentiles in ms)."""
    snap = snap or snapshot(registry)
    lines = []
    if snap.get("counters") or snap.get("gauges"):
        lines += ["| metric | value |", "|---|---|"]
        for name, v in snap.get("counters", {}).items():
            lines.append(f"| {name} | {_fmt(v)} |")
        for name, g in snap.get("gauges", {}).items():
            lines.append(f"| {name} | {_fmt(g['value'])} "
                         f"(hwm {_fmt(g['hwm'])}) |")
    if snap.get("histograms"):
        lines += ["", "| histogram | count | p50 ms | p95 ms | p99 ms | "
                  "max ms |", "|---|---|---|---|---|---|"]
        for name, h in snap["histograms"].items():
            if not h.get("count"):
                lines.append(f"| {name} | 0 | — | — | — | — |")
                continue
            lines.append(
                f"| {name} | {h['count']} | {_fmt(h['p50'], 1e3)} | "
                f"{_fmt(h['p95'], 1e3)} | {_fmt(h['p99'], 1e3)} | "
                f"{_fmt(h['max'], 1e3)} |")
    return "\n".join(lines)


def serving_slos(registry: Optional[Registry] = None,
                 attn_impl: Optional[str] = None,
                 n_hosts: Optional[int] = None) -> Dict:
    """The serving SLO trio as flat row fields (ms units, JSON-friendly).

    Pulled from the Server's canonical metric names; absent metrics yield
    ``None`` so rows stay diffable across configurations that never served
    (e.g. train-only runs).

    ``attn_impl`` tags which decode-attention engine produced the numbers
    (pass :attr:`Server.attn_impl`), so SLOs of the plain path are never
    diffed against the kernel path's silently.  ``n_hosts`` does the same
    for fleet runs: pass the host count when ``registry`` is a merged fleet
    view (:meth:`repro_torch.telemetry.Registry.merge`), so single-host SLOs
    are never compared against fleet SLOs under one key.
    """
    snap = snapshot(registry)
    hists, gauges = snap["histograms"], snap["gauges"]

    def p50(name):
        h = hists.get(name, {})
        return round(h["p50"] * 1e3, 3) if h.get("count") else None

    occ = gauges.get("server.block_occupancy", {})
    slos = {"ttft_ms": p50("server.ttft_s"),
            "tpot_ms": p50("server.tpot_s"),
            "occupancy_peak": round(occ["hwm"], 3) if occ else None}
    if attn_impl is not None:
        slos["attn_impl"] = attn_impl
    if n_hosts is not None:
        slos["n_hosts"] = n_hosts
    return slos


def merge_into_bench(record: Dict, registry: Optional[Registry] = None
                     ) -> Dict:
    """Attach the telemetry snapshot to a bench record (in place; returned
    for chaining)."""
    record["telemetry"] = snapshot(registry)
    return record
