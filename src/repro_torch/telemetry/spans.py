"""Monotonic-clock span tracing, exported as Chrome trace-event JSON.

``clock()`` is the ONE wall-clock source for the whole runtime
(``time.perf_counter``: monotonic, high-resolution, immune to NTP steps —
``time.time`` is neither).  Every timing site in the Engine/Server/runtime
loops goes through it, so durations are comparable across modules.

Spans are host-side begin/end pairs around interesting regions (AOT lower /
compile, prefill, decode ticks).  They nest naturally — the recorder emits
Chrome "complete" (``ph="X"``) events whose containment on a thread's
timeline encodes the hierarchy — and the JSON loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

    with span("server.prefill", rid=0, bucket=16):
        logits, cache = prefill(params, batch, cfg)
    export_chrome_trace("trace.json")

Like metrics, spans obey the owning :class:`~repro_torch.telemetry.registry
.Registry`'s ``enabled`` flag: disabled, ``span()`` yields without recording
(one branch, no allocation), so hot decode loops can keep their spans.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

from repro_torch.telemetry.registry import Registry, get_registry

__all__ = ["clock", "SpanRecorder", "get_recorder", "span",
           "export_chrome_trace"]

clock = time.perf_counter


class SpanRecorder:
    """Collects complete-span events; one recorder per registry by default."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or get_registry()
        self.events: List[Dict] = []
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        if not self.registry.enabled:
            yield
            return
        self._tls.depth = self._depth() + 1
        t0 = clock()
        try:
            yield
        finally:
            dur = clock() - t0
            self._tls.depth -= 1
            ev = {"name": name, "ph": "X", "cat": "repro",
                  "ts": t0 * 1e6, "dur": dur * 1e6,
                  "pid": 0, "tid": threading.get_ident()}
            if args:
                ev["args"] = {k: str(v) for k, v in args.items()}
            self.events.append(ev)

    def clear(self) -> None:
        self.events.clear()

    def chrome_trace(self) -> Dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": sorted(self.events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_GLOBAL = SpanRecorder()


def get_recorder() -> SpanRecorder:
    """The process-global recorder (paired with the global registry)."""
    return _GLOBAL


def span(name: str, **args):
    """Span on the global recorder: ``with span("server.prefill", bucket=16)``."""
    return _GLOBAL.span(name, **args)


def export_chrome_trace(path: str, recorder: Optional[SpanRecorder] = None
                        ) -> str:
    """Write the recorded spans as Chrome trace-event JSON; returns ``path``."""
    return (recorder or _GLOBAL).export(path)
