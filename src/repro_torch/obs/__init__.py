"""Observability for the port: span tracing on one monotonic clock, a
typed metrics registry the stats dataclasses emit into, and
Chrome-trace/JSONL/CSV export with its validator (copies of
``repro.obs.trace``, ``repro.obs.metrics`` and ``repro.obs.export``;
stdlib only).

    from repro_torch.obs import Tracer, span, use_tracer
    tracer = Tracer()
    with use_tracer(tracer):
        with span("train.step", rows=64):
            ...
    write_chrome_trace(tracer, "trace.json")
"""
from repro_torch.obs.export import (TraceValidationError, chrome_trace,
                                    summarize, validate_chrome_trace,
                                    write_chrome_trace, write_csv_summary,
                                    write_jsonl)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsMixin)
from repro_torch.obs.trace import (Span, Tracer, active_tracer, now, span,
                                   use_tracer)

__all__ = [
    "Span", "Tracer", "span", "use_tracer", "active_tracer", "now",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsMixin",
    "chrome_trace", "write_chrome_trace", "write_jsonl",
    "write_csv_summary", "summarize", "validate_chrome_trace",
    "TraceValidationError",
]
