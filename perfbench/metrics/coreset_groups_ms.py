"""``coreset_groups_ms``: the mean wall time of a job's coreset
grouping, the ``coreset.groups`` span (``core/coreset.select_coreset``:
the key stacking, the label bins and ``np.unique`` over the (N, M+1)
keys, inside ``coreset.select``), over the jobs outside the
profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "coreset.groups")
