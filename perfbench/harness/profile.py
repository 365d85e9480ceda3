"""A ``torch.profiler`` window over whole jobs or dispatch rounds.

``DeviceWindow`` profiles what runs inside it and keeps, from the
profiler's trace, every device operation (kernels, copies, sets) with
its start and end on the host's ``perf_counter`` clock: a
``record_function`` mark entered at a known ``perf_counter`` time ties
the profiler's clock to it.  From those it works out the seconds in
which an operation ran on the device (the union of their intervals),
the idle gaps between them, labelled by the innermost obs span the host
was in at the gap's middle, and the device time by operation name.

The profiler now and then records no device event, or drops some, in
a session; the caller compares the launches of a kernel it knows the
count of (``launches``) and profiles again where they differ, so no
share is worked out from a partial trace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "perfbench.window"


@dataclasses.dataclass
class DeviceTrace:
    ops: List[Tuple[str, float, float]]      # (name, start, end), perf clock
    t0: float                                # the window, perf clock
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def launches(self, symbol: str) -> int:
        return sum(symbol in name for name, _, _ in self.ops)

    def device_seconds(self, symbol: str) -> float:
        return sum(e - s for name, s, e in self.ops if symbol in name)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to
        the window."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.t0]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.t1)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def top_ops(self, n: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for name, s, e in self.ops:
            per[name] = per.get(name, 0.0) + (e - s)
        return [[k[:200], v] for k, v in sorted(per.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans: Sequence, n: int = 10) -> List[list]:
        """Idle seconds summed by the innermost span (``name``, ``t0``,
        ``t1`` on the perf clock) that holds each gap's middle; "host"
        where none does."""
        per: Dict[str, float] = {}
        for s, e in self.gaps():
            mid = (s + e) / 2
            inner = [sp for sp in spans if sp.t0 <= mid <= sp.t1]
            label = (min(inner, key=lambda sp: sp.t1 - sp.t0).name
                     if inner else "host")
            per[label] = per.get(label, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]


def warm_profiler(device: torch.device) -> None:
    """One short profiler session, so that the profiler's own start-up
    (CUPTI) is paid in set-up and not inside the window."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).sum().item()


class DeviceWindow:
    """``with DeviceWindow(device) as w: ...`` profiles the block; after
    it, ``w.trace`` is the ``DeviceTrace`` (its ops empty where the
    profiler saw no device event)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.trace: Optional[DeviceTrace] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "DeviceWindow":
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._t0 = time.perf_counter()
        self._mark.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        events = self._prof.events()
        mark = next((ev for ev in events if ev.name == MARK), None)
        offset = (self._t0 - mark.time_range.start / 1e6
                  if mark is not None else None)
        ops = []
        if offset is not None:
            for ev in events:
                # the mark itself shows on the device's timeline as a
                # user annotation over the whole window: not an operation
                if (ev.device_type == torch.autograd.DeviceType.CUDA
                        and ev.name != MARK):
                    ops.append((ev.name, ev.time_range.start / 1e6 + offset,
                                ev.time_range.end / 1e6 + offset))
        self.trace = DeviceTrace(ops=ops, t0=self._t0, t1=t1)
