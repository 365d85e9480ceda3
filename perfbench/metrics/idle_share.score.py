"""``idle_share.score``: the share of the profiled dispatch rounds, from the
synchronise before its first operation to the synchronise after its
last, in which no kernel, copy or set ran on the device (the union of
the profiler's device operations)."""
from perfbench.harness.readers import idle_share


def read(t):
    return idle_share(t)
