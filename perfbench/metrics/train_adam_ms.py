"""``train_adam_ms``: a training step's Adam update, the ``train.adam``
spans (``train/optimizer.adam_update``, inside ``train.epoch``) summed
over the jobs outside the profiler, over their steps
(``TrainReport.steps``)."""
from perfbench.harness.readers import unprofiled


def read(t):
    jobs = unprofiled(t)
    spans = [s for j in jobs for s in j.spans if s.name == "train.adam"]
    steps = sum(j.steps for j in jobs)
    if not spans or not steps:
        return None
    return 1e3 * sum(s.duration for s in spans) / steps
