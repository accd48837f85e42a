"""Zero-dependency observability (a copy of ``repro.telemetry``): named
Counter/Gauge/Histogram metrics, Chrome-trace spans and the snapshot
exporters, recorded host-side only.

  registry — named metrics behind a process-global Registry.
  spans    — ``clock()`` and nested spans exported as Chrome trace JSON.
  export   — explicit JSON / markdown snapshots, the serving SLO trio and
             the bench-record merge.
"""
from repro_torch.telemetry.export import (merge_into_bench, serving_slos,
                                          snapshot, to_markdown, write_json)
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            Registry, get_registry,
                                            set_enabled)
from repro_torch.telemetry.spans import (SpanRecorder, clock,
                                         export_chrome_trace, get_recorder,
                                         span)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "set_enabled", "SpanRecorder", "clock", "export_chrome_trace",
    "get_recorder", "span", "merge_into_bench", "serving_slos", "snapshot",
    "to_markdown", "write_json",
]
