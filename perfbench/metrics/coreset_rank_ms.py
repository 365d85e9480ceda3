"""``coreset_rank_ms``: the mean wall time of a job's rank weights, the
``coreset.rank`` spans (``core/coreset.rank_weights`` of every client,
inside ``coreset.fit``), over the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "coreset.rank")
