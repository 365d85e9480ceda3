"""``score_dispatch_ms``: the mean wall time of one scoring-engine
dispatch, the ``serve.dispatch`` span (``serve/vfl.VFLScoringEngine``:
the slab's copy to the card, K1 and the top model, the copy back)."""


def read(t):
    d = [s.duration for s in t.spans if s.name == "serve.dispatch"]
    return 1e3 * sum(d) / len(d) if d else None
