"""``score_mfu``: the SplitNN's forward FLOPs of the rows scored and
returned in the window (``harness/flops.forward_flops``), over the
window, as a share of the card's f32 peak."""
from perfbench.harness import flops
from perfbench.harness.readers import card_peak
from perfbench.reference.vfl import n_out


def read(t, peak=None):
    peak = peak or card_peak()
    if peak is None or t.window_s <= 0:
        return None
    mdl = t.model
    o = int(mdl["bottom_dim"]) if mdl["model"] == "mlp" else n_out(mdl)
    per_row = flops.forward_flops(mdl["model"], t.dims, o,
                                  int(mdl["hidden_dim"]), n_out(mdl))
    return 100.0 * per_row * t.rows_done / t.window_s / peak["f32_flops"]
