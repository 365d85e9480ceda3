"""``coreset_kmeans_ms``: the mean wall time of a job's k-means fit, the
``coreset.kmeans`` spans (``core/coreset``: the clients' fit through its
copies back to the host, inside ``coreset.fit``), over the jobs outside
the profiler."""
from perfbench.harness.readers import mean_span_ms


def read(t):
    return mean_span_ms(t, "coreset.kmeans")
