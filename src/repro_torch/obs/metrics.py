"""Typed counter/gauge/histogram registry + the shared stats mixin
(DESIGN.md §10).

The registry is the single numeric sink the existing public stats
dataclasses (``EngineStats``, ``ServeStats``, ``MPSIStats``, the
``PipelineReport`` wall timers) emit into: the dataclasses stay the
public API, while the registry snapshot is what the contract gate and
the benchmark CSVs read — one flat ``{name: value}`` namespace instead
of per-engine hand-plumbed field lists.

Three metric types, all thread-safe through the owning registry's lock:

- ``Counter``   — monotonically increasing int/float (``inc``)
- ``Gauge``     — last-write-wins scalar (``set``)
- ``Histogram`` — raw-sample distribution (``observe``) with exact
  percentiles (no bucketing: sample counts here are per-dispatch /
  per-epoch scale, thousands at most, so storing the samples beats
  choosing bucket boundaries)

``MetricsRegistry.merge`` combines registries (counters add, gauges
last-write-wins, histograms concatenate), which is how per-thread or
per-stage registries fold into one snapshot.

``StatsMixin`` gives the stats dataclasses a uniform surface:
``to_dict()`` (scalar fields only), ``as_row(fields)`` (CSV row dicts —
the dedup of the hand-copied field lists the benchmarks used to carry),
and ``emit(registry, prefix)`` (ints → counters, floats → gauges).  The
``CONTRACT_FIELDS`` class attribute, where a dataclass defines it,
names the fields the CI perf contract pins — declared next to the
fields themselves so the gate and the benchmarks can never drift apart.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "StatsMixin"]

Number = Union[int, float]


class Counter:
    """Monotonic counter.  ``inc`` with a negative value is rejected —
    that is what gauges are for."""
    __slots__ = ("name", "value", "_lock")
    kind = "counter"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self.value: Number = 0
        self._lock = lock or threading.Lock()

    def inc(self, v: Number = 1) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative inc {v}")
        with self._lock:
            self.value += v

    def snapshot(self) -> Number:
        return self.value


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("name", "value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self.value: Number = 0
        self._lock = lock or threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self.value = v

    def snapshot(self) -> Number:
        return self.value


def _nearest_rank(sorted_data: List[float], q: float) -> float:
    """Nearest-rank percentile of pre-sorted data: the
    ceil(q/100 · n)-th sample, clamped to [1, n]; 0.0 when empty."""
    n = len(sorted_data)
    if not n:
        return 0.0
    rank = min(max(1, math.ceil(q * n / 100.0)), n)
    return sorted_data[rank - 1]


class Histogram:
    """Raw-sample histogram with exact percentiles.

    Percentiles use the nearest-rank method (ceil(q/100 * n)-th sorted
    sample) — deterministic, no interpolation, and defined for n = 1 —
    so pinned values can never drift with a numpy version.
    """
    __slots__ = ("name", "samples", "_lock")
    kind = "histogram"

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self.samples: List[float] = []
        self._lock = lock or threading.Lock()

    def observe(self, v: Number) -> None:
        with self._lock:
            self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile; 0.0 on an empty histogram."""
        with self._lock:
            data = sorted(self.samples)
        return _nearest_rank(data, q)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self.samples)
        if not data:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        return {"count": len(data), "sum": float(sum(data)),
                "min": data[0], "max": data[-1],
                "p50": _nearest_rank(data, 50),
                "p99": _nearest_rank(data, 99)}


Metric = Union[Counter, Gauge, Histogram]
_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Names are flat dotted strings (``"train.dispatches"``,
    ``"serve.dispatch_wall_s"``).  Re-requesting a name with a different
    type is an error — the registry is typed, not stringly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind: str) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = _KINDS[kind](name, self._lock)
            elif m.kind != kind:
                raise TypeError(f"metric {name!r} is a {m.kind}, "
                                f"requested {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Union[Number, Dict[str, float]]]:
        """Flat ``{name: value}`` — counters/gauges to their scalar,
        histograms to their summary dict.  This is the single source
        the contract gate and the benchmark CSV rows read."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters add, gauges take
        the other's value, histograms concatenate samples.  Safe for
        per-thread registries folding into a shared one."""
        with other._lock:
            items = list(other._metrics.items())
        for name, m in items:
            mine = self._get(name, m.kind)
            if m.kind == "counter":
                with self._lock:
                    mine.value += m.value
            elif m.kind == "gauge":
                with self._lock:
                    mine.value = m.value
            else:
                with self._lock:
                    mine.samples.extend(m.samples)


# ------------------------------------------------------------ stats mixin


def _scalar_fields(obj) -> List[Tuple[str, Number]]:
    """The dataclass fields that are plain numbers/bools (the emittable
    surface — arrays, lists and nested objects are skipped)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out.append((f.name, v))
    return out


class StatsMixin:
    """Shared surface for the stats dataclasses (``EngineStats``,
    ``ServeStats``, ``MPSIStats``): dict/CSV-row conversion and registry
    emission, replacing the per-benchmark hand-copied field lists.

    Subclasses may set ``CONTRACT_FIELDS`` (tuple of field names) to
    declare which counters the CI perf contract pins.
    """
    CONTRACT_FIELDS: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Union[Number, str]]:
        """Every scalar (number/bool/str) field, in declaration order."""
        out: Dict[str, Union[Number, str]] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (bool, int, float, str)):
                out[f.name] = int(v) if isinstance(v, bool) else v
        return out

    def as_row(self, fields: Optional[Sequence[str]] = None,
               prefix: str = "") -> Dict[str, Union[Number, str]]:
        """CSV-ready row dict: ``fields`` selects/reorders (default: all
        scalar fields), ``prefix`` namespaces the keys."""
        d = self.to_dict()
        names = list(fields) if fields is not None else list(d)
        return {prefix + k: d[k] for k in names}

    def emit(self, registry: MetricsRegistry, prefix: str = "") -> None:
        """Write the scalar fields into ``registry``: ints/bools become
        counters (incremented — repeated emits of per-run stats
        accumulate), floats become gauges."""
        for name, v in _scalar_fields(self):
            key = prefix + name
            if isinstance(v, bool):
                registry.counter(key).inc(int(v))
            elif isinstance(v, int):
                registry.counter(key).inc(v)
            else:
                registry.gauge(key).set(v)
