"""``train_mfu``: the SplitNN's forward and backward FLOPs of every
training row of the jobs outside the profiler (epochs × coreset rows,
``harness/flops.train_flops``), over their ``pipeline.train`` time, as a
share of the card's f32 peak (the path runs f32 with TF32 off)."""
from perfbench.harness import flops
from perfbench.harness.readers import card_peak, unprofiled
from perfbench.reference.vfl import n_out


def read(t, peak=None):
    peak = peak or card_peak()
    jobs = unprofiled(t)
    secs = sum(s.duration for j in jobs for s in j.spans
               if s.name == "pipeline.train")
    if peak is None or secs <= 0:
        return None
    mdl = t.model
    o = int(mdl["bottom_dim"]) if mdl["model"] == "mlp" else n_out(mdl)
    per_row = flops.train_flops(mdl["model"], t.dims, o,
                                int(mdl["hidden_dim"]), n_out(mdl))
    rows = sum(j.epochs * j.n_train for j in jobs)
    return 100.0 * per_row * rows / secs / peak["f32_flops"]
