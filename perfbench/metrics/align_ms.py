"""``align_ms``: the mean wall time of a job's alignment, the
``pipeline.align`` span (MPSI over the id lists, ``core/mpsi``,
``core/tpsi``, ``psi/engine``), over the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "pipeline.align")
