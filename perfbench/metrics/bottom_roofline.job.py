"""``bottom_roofline.job``: the bottom kernel's share of its roofline
in the profiled job: K2 in every training step, K1 in every evaluation
block. The bound of each launch (``rooflines/bottom_kernel``: bytes at
the HBM bandwidth or operations at the f32 rate, the larger) summed,
over those launches' device time in the profiler's trace. Read only from
a trace that holds every launch the program counted."""
from perfbench.harness.readers import card_peak, roofline_share
from perfbench.rooflines import bottom_kernel


def read(t, peak=None):
    return roofline_share(t, bottom_kernel, peak or card_peak())
