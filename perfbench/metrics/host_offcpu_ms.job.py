"""``host_offcpu_ms.job``: the mean time a job's thread spent off its
CPU, blocked or waiting for one: each job's ``pipeline.run`` span less
its ``cpu_s`` (``time.thread_time`` over the span), over the jobs
outside the profiler, in ms."""
from perfbench.harness.readers import unprofiled


def read(t):
    off = [s.duration - s.attrs["cpu_s"] for j in unprofiled(t)
           for s in j.spans
           if s.name == "pipeline.run" and "cpu_s" in s.attrs]
    return 1e3 * sum(off) / len(off) if off else None
