"""``score_p95_ms``: the 95th percentile of the latency of every
request of the window, from its submission to its return to its client,
on the host clock."""
import numpy as np


def read(t):
    lat = np.asarray(t.latencies, np.float64)
    lat = lat[~np.isnan(lat)]
    return 1e3 * float(np.percentile(lat, 95)) if lat.size else None
