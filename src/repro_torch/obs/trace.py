"""Span tracing on one shared monotonic clock (DESIGN.md §10).

The tracing substrate every stage of the pipeline reports into: a
``Tracer`` collects finished ``Span`` records — name, start/end on the
shared ``now()`` clock, nesting (parent ids via per-thread open-span
stacks), and free-form scalar attributes (comm_bytes, dispatches,
rows).  ``repro_torch.obs`` is dependency-free by design: stdlib only,
so the protocol/host layers can always afford to import it.

Usage::

    tracer = Tracer()
    with use_tracer(tracer):
        with span("train.epoch", epoch=i) as sp:
            ...
            sp.set(comm_bytes=nbytes)

Cost model (the zero-overhead contract of the engine tests):

- **Disabled** (no active tracer — the default): ``span()`` returns a
  shared no-op singleton.  No clock read, no allocation, no lock — one
  global load and an ``is None`` check.  Instrumented hot paths
  therefore cost nothing measurable when nobody is tracing, and
  tracing itself NEVER adds device dispatches or host syncs: spans
  only bracket existing host code.
- **Enabled**: two ``time.perf_counter()`` reads plus one append under
  the tracer lock per span — host-side microseconds, far below any
  dispatch this repo brackets.

Threading: the active tracer is process-global (the serve scheduler
and its driver threads all report into one timeline), while the
open-span *stack* is thread-local, so spans nest per thread and a
concurrent thread can never corrupt another thread's parentage.
Finished spans append under a lock.  Chrome-trace export keys lanes by
``Span.tid``, which is exactly this per-thread nesting.

This is the port's copy of ``repro.obs.trace``; the reference's
opt-in ``jax.profiler`` bridge is left out.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "span", "use_tracer", "active_tracer", "now"]

#: the shared monotonic clock every span (and every stage wall-time in
#: ``PipelineReport``) is measured on
now = time.perf_counter


@dataclasses.dataclass
class Span:
    """One finished (or open) span on the tracer's clock."""
    name: str
    t0: float                      # ``now()`` at enter
    t1: float = 0.0                # ``now()`` at exit (0 while open)
    sid: int = 0                   # unique per tracer
    parent: int = -1               # sid of the enclosing span (-1 = root)
    depth: int = 0                 # nesting depth on this thread
    tid: int = 0                   # thread ident (export lane)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes mid-span (e.g. counts known only
        at exit)."""
        self.attrs.update(attrs)


class _SpanHandle:
    """Context manager binding one open ``Span`` to its tracer."""
    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", sp: Span):
        self._tracer = tracer
        self.span = sp

    def set(self, **attrs) -> None:
        self.span.set(**attrs)

    @property
    def duration(self) -> float:
        return self.span.duration

    def __enter__(self) -> "_SpanHandle":
        self._tracer._enter(self.span)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._exit(self.span)


class _NullSpan:
    """Shared no-op handle returned while tracing is disabled: no clock
    read, no allocation.  ``set`` swallows attributes; ``duration`` is
    0.0 (callers that need a wall time regardless of tracing read the
    ``now()`` clock directly — see ``PipelineReport``)."""
    __slots__ = ()
    duration = 0.0

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans from every thread onto one monotonic timeline.

    ``epoch`` is the tracer's time zero (set at construction): exported
    timestamps are relative to it, so a timeline starts near 0 no
    matter when in the process's life the tracer was created.
    """

    def __init__(self):
        self.epoch = now()
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._tls = threading.local()

    # ------------------------------------------------------------ state

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, **attrs) -> _SpanHandle:
        """A new (not yet entered) span handle bound to this tracer."""
        sp = Span(name=name, t0=0.0, attrs=dict(attrs))
        return _SpanHandle(self, sp)

    def _enter(self, sp: Span) -> None:
        st = self._stack()
        sp.sid = next(self._ids)
        sp.tid = threading.get_ident()
        sp.parent = st[-1].sid if st else -1
        sp.depth = len(st)
        st.append(sp)
        sp.t0 = now()        # last: exclude setup from the measured span

    def _exit(self, sp: Span) -> None:
        sp.t1 = now()        # first: exclude teardown from the span
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        else:                # tolerate mispaired exits rather than corrupt
            try:
                st.remove(sp)
            except ValueError:
                pass
        with self._lock:
            self.spans.append(sp)

    # ---------------------------------------------------------- queries

    def finished(self) -> List[Span]:
        """Snapshot of the finished spans, sorted by start time."""
        with self._lock:
            spans = list(self.spans)
        return sorted(spans, key=lambda s: (s.t0, s.sid))

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.finished() if s.name == name]

    def total_seconds(self, name: str) -> float:
        return sum(s.duration for s in self.by_name(name))


# --------------------------------------------------- process-global state

_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def active_tracer() -> Optional[Tracer]:
    return _active


class _UseTracer:
    """Activate a tracer for the dynamic extent of a ``with`` block.

    Process-global on purpose (module docstring): one pipeline run's
    stages — including worker threads the serve scheduler may spawn —
    all land on one timeline.  Nested activations restore the previous
    tracer on exit.  ``use_tracer(None)`` is a no-op pass-through, so
    call sites can write ``with use_tracer(maybe_tracer):`` without
    branching.
    """
    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer: Optional[Tracer]):
        self._tracer = tracer
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Optional[Tracer]:
        global _active
        if self._tracer is not None:
            with _active_lock:
                self._prev = _active
                _active = self._tracer
        return self._tracer

    def __exit__(self, *exc) -> None:
        global _active
        if self._tracer is not None:
            with _active_lock:
                _active = self._prev


def use_tracer(tracer: Optional[Tracer]) -> _UseTracer:
    return _UseTracer(tracer)


def span(name: str, **attrs):
    """A span on the active tracer — or the shared no-op handle when
    tracing is disabled (one global load + ``is None`` check; see the
    module docstring's cost model)."""
    t = _active
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)
