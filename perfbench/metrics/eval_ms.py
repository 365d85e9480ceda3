"""``eval_ms``: the mean wall time of a job's evaluation on the test
split, the ``pipeline.serve`` span (``serve/vfl.score_partition``), over
the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "pipeline.serve")
