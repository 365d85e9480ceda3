"""Observability for the port: span tracing on one monotonic clock and
a typed metrics registry the stats dataclasses emit into (copies of
``repro.obs.trace`` and ``repro.obs.metrics``; stdlib only)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsMixin)
from repro_torch.obs.trace import (Span, Tracer, active_tracer, now, span,
                                   use_tracer)

__all__ = [
    "Span", "Tracer", "span", "use_tracer", "active_tracer", "now",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsMixin",
]
