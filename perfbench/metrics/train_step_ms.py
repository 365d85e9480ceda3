"""``train_step_ms``: training's wall time a step, the ``train.epoch``
spans (``train/vfl.train_scan``: each brackets an epoch's steps and its
one host sync) summed over the jobs outside the profiler, over their
steps (``TrainReport.steps``)."""
from perfbench.harness.readers import unprofiled


def read(t):
    jobs = unprofiled(t)
    steps = sum(j.steps for j in jobs)
    if not steps:
        return None
    secs = sum(s.duration for j in jobs for s in j.spans
               if s.name == "train.epoch")
    return 1e3 * secs / steps
