"""``align_canon_ms``: the mean wall time of a job's canonical id lists,
the ``align.canon`` span (``core/mpsi.canonical_ids`` of the clients,
inside ``align.mpsi``), over the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "align.canon")
