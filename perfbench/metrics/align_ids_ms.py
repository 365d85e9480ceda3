"""``align_ids_ms``: the mean wall time of a job's id lists, the
``align.ids`` span (``data/synthetic.make_id_universe``, inside
``pipeline.align``), over the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "align.ids")
