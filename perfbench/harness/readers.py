"""Arithmetic the per-layer readers share: span means over the jobs
that ran outside the profiler, a kernel's share of its roofline, the
device's idle share, MFU.  A reader returns None where it finds
nothing to read, and the harness leaves its metric out."""
from __future__ import annotations

from typing import Optional

from perfbench.harness import peaks


def unprofiled(t) -> list:
    """The jobs that ran outside the profiler (all of them where every
    job was profiled)."""
    return [j for j in t.jobs if not j.profiled] or list(t.jobs)


def mean_span_ms(t, name: str) -> Optional[float]:
    """The mean, over the jobs outside the profiler, of a job's summed
    ``name`` spans, in ms."""
    per = [sum(s.duration for s in j.spans if s.name == name)
           for j in unprofiled(t) if any(s.name == name for s in j.spans)]
    return 1e3 * sum(per) / len(per) if per else None


def roofline_share(t, roofline, peak: Optional[dict]) -> Optional[float]:
    """The launches' bounds summed (``roofline.bound_seconds`` of each
    expected launch) over their device time in the trace, in %; None
    without a complete trace or a known card."""
    if t.device is None or peak is None or not t.launches:
        return None
    device_s = t.device.device_seconds(roofline.SYMBOL)
    if device_s <= 0:
        return None
    bound = sum(n * roofline.bound_seconds(peak=peak, **kw)
                for n, kw in t.launches)
    return 100.0 * bound / device_s


def idle_share(t) -> Optional[float]:
    """The share of the profiled window in which no device operation
    ran, in %."""
    if t.device is None or t.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.device.busy_s() / t.device.window_s)


def card_peak() -> Optional[dict]:
    import torch
    if not torch.cuda.is_available():
        return None
    return peaks.peak(torch.cuda.get_device_name(0))
