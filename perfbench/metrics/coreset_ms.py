"""``coreset_ms``: the mean wall time of a job's Cluster-Coreset, the
``pipeline.coreset`` span (``core/coreset``, ``core/kmeans``), over the
jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "pipeline.coreset")
