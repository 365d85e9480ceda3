"""``align_he_ms``: the mean wall time of a job's HE relay sample, the
``align.he`` spans (``core/mpsi._broadcast_result``: the key, then the
sampled encryptions and decryptions, inside ``align.broadcast``), over
the jobs outside the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "align.he")
