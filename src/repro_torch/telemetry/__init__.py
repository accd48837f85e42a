"""Zero-dependency observability (a copy of ``repro.telemetry``'s registry
and spans): named Counter/Gauge/Histogram metrics and Chrome-trace spans,
recorded host-side only."""
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            Registry, get_registry,
                                            set_enabled)
from repro_torch.telemetry.spans import (SpanRecorder, clock,
                                         export_chrome_trace, get_recorder,
                                         span)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "set_enabled", "SpanRecorder", "clock", "export_chrome_trace",
    "get_recorder", "span",
]
