"""The serving slice: ``score_partition``/``predict`` and the
continuous-batching ``VFLScoringEngine`` of the port (its plain bottom
layer on the CPU) against the reference's (its Pallas kernel in
interpret mode), with the reference's params carried across exactly.

Outputs agree within the K1 tolerance, 1e-6 + 1e-5 · (the magnitudes of
the terms each output adds, propagated through the top layers); the
scheduler's counters, completion order and virtual-clock latencies are
pure functions of the trace and must be equal."""
import numpy as np
import pytest

from conftest import make_cls_partition
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import init_splitnn as jax_init
from repro.core.splitnn import predict as jax_predict
from repro.serve import vfl as jax_serve
from repro_torch.core.splitnn import SplitNNConfig, predict
from repro_torch.data.vertical import VerticalPartition
from repro_torch.interop import params_from_jax
from repro_torch.serve import vfl

MODELS = [("lr", 2), ("lr", 3), ("mlp", 4), ("linreg", 0)]


def _setup(model, n_classes, n=150, seed=1):
    part = make_cls_partition(n=n, d=11, classes=max(n_classes, 2),
                              seed=seed)
    kw = dict(model=model, n_classes=n_classes, seed=seed)
    jp = jax_init(JaxConfig(**kw), [f.shape[1] for f in
                                    part.client_features])
    return (part, VerticalPartition(part.client_features, part.labels,
                                    part.feature_slices),
            JaxConfig(**kw), SplitNNConfig(**kw), jp,
            params_from_jax(jp, "cpu"))


def _term_scale(params, cfg, feats):
    """Per output, the summed magnitudes of every term it adds,
    propagated layer by layer (|x|·|w| + |b|)."""
    p = {"bottoms": [{k: np.abs(np.asarray(v, np.float64))
                      for k, v in bp.items()} for bp in params["bottoms"]],
         "top": {k: np.abs(np.asarray(v, np.float64))
                 for k, v in params["top"].items()}}
    acts = [np.abs(f) @ bp["w"] + bp.get("b", 0.0)
            for f, bp in zip(feats, p["bottoms"])]
    if cfg.model in ("lr", "linreg"):
        return sum(acts) + p["top"]["b"]
    h = np.concatenate(acts, 1) @ p["top"]["w1"] + p["top"]["b1"]
    return h @ p["top"]["w2"] + p["top"]["b2"]


def _check(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 + 1e-5 * scale).all()


@pytest.mark.parametrize("model,n_classes", MODELS)
def test_score_partition_and_predict_match_reference(model, n_classes):
    """Full blocks and the zero-padded remainder (150 rows, blocks of
    64); predictions equal except where the decision is within 1e-4."""
    part, ppart, jcfg, cfg, jp, tp = _setup(model, n_classes)
    want = jax_serve.score_partition(jp, jcfg, part, block_b=64,
                                     bottom_impl="pallas")
    got = vfl.score_partition(tp, cfg, ppart, block_b=64)
    assert got.shape == want.shape and got.dtype == np.float32
    _check(got, want, _term_scale(jp, cfg, part.client_features))
    pw = jax_predict(jp, jcfg, part, block_b=64, bottom_impl="pallas")
    pg = predict(tp, cfg, ppart, block_b=64)
    if n_classes == 0:
        _check(pg, pw, _term_scale(jp, cfg, part.client_features)[:, 0])
        return
    if want.shape[1] == 1:
        margin = np.abs(want[:, 0])
    else:
        top2 = np.sort(want, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
    decided = margin > 1e-4
    assert np.array_equal(pg[decided], pw[decided])


def _trace(part, seed=4, n_requests=36):
    """Seeded requests of 1-11 rows, with oversized ones (> 16 slots)
    and ones that must wait for room (deferred, then split)."""
    g = np.random.default_rng(seed)
    t, out = 0.0, []
    for rid in range(n_requests):
        t += float(g.exponential(0.003))
        rows = int(g.integers(1, 12)) if rid % 9 else int(g.integers(17, 30))
        idx = g.integers(0, part.n_samples, size=rows)
        out.append((rid, t, [f[idx] for f in part.client_features]))
    return out


def _drive(engine, trace):
    for rid, _, feats in trace:
        engine.submit(rid, feats)
    order, results = [], {}
    while engine.has_work:
        for rid, out in engine.step():
            order.append(rid)
            results[rid] = out
    return order, results


@pytest.mark.parametrize("model,n_classes", [("mlp", 4), ("lr", 2)])
def test_engine_trace_matches_reference(model, n_classes):
    part, ppart, jcfg, cfg, jp, tp = _setup(model, n_classes, n=90)
    trace = _trace(part)
    ref = jax_serve.VFLScoringEngine(jp, jcfg, slots=16, max_defer=1,
                                     bottom_impl="pallas")
    eng = vfl.VFLScoringEngine(tp, cfg, slots=16, max_defer=1)
    want_order, want = _drive(ref, trace)
    got_order, got = _drive(eng, trace)
    assert got_order == want_order
    for f in vfl.ServeStats.CONTRACT_FIELDS:
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.stats.forced_splits > 0 and eng.stats.padded_slots > 0
    assert eng.stats.bottom_impl == "ref"
    for rid, _, feats in trace:
        _check(got[rid], want[rid], _term_scale(jp, cfg, feats))


def test_simulate_trace_matches_reference():
    part, ppart, jcfg, cfg, jp, tp = _setup("mlp", 2, n=60)
    reqs = [(rid, t, f) for rid, t, f in _trace(part, seed=7)]
    for policy in ("continuous", "blocking"):
        sims = []
        for mod, params, c in ((jax_serve, jp, jcfg), (vfl, tp, cfg)):
            kw = {"bottom_impl": "pallas"} if mod is jax_serve else {}
            eng = mod.VFLScoringEngine(params, c, slots=8, **kw)
            trace = [mod.ScoreRequest(rid=r, arrival=t, features=f)
                     for r, t, f in reqs]
            sims.append(mod.simulate_trace(eng, trace, policy=policy,
                                           service_seconds=2e-3))
        want, got = sims
        for f in vfl.ServeStats.CONTRACT_FIELDS:
            assert getattr(got.stats, f) == getattr(want.stats, f), f
        assert got.latencies == want.latencies
        assert got.makespan == want.makespan
        assert got.service_hist.samples == want.service_hist.samples


def test_outputs_independent_of_occupancy():
    """An occupied slot's output is the same bits whether the batch is
    nearly empty or full."""
    _, ppart, _, cfg, _, tp = _setup("mlp", 4, n=40)
    feats = ppart.client_features
    alone = vfl.VFLScoringEngine(tp, cfg, slots=16)
    alone.submit(0, [f[:3] for f in feats])
    (_, out_alone), = alone.step()
    full = vfl.VFLScoringEngine(tp, cfg, slots=16)
    full.submit(0, [f[:3] for f in feats])
    full.submit(1, [f[3:16] for f in feats])
    done = dict(full.step())
    assert full.stats.occupancy_sum == 16
    assert np.array_equal(done[0], out_alone)


def test_engine_validates_and_rejects_ineligible_rows():
    _, ppart, _, cfg, _, tp = _setup("lr", 2, n=20)
    feats = ppart.client_features
    eng = vfl.VFLScoringEngine(tp, cfg, slots=4)
    with pytest.raises(ValueError):
        eng.submit(0, [feats[0][:2]])
    with pytest.raises(ValueError):
        eng.submit(0, [f[:2, :1] for f in feats])
    eng.set_eligible([10, 11])
    assert eng.submit(0, [f[:3] for f in feats], row_ids=[10, 12, 13]) == 1
    eng.apply_aligned_delta(added=[12], removed=[10])
    assert eng.submit(1, [f[:2] for f in feats], row_ids=[10, 12]) == 1
    assert eng.stats.rejected_rows == 3 and eng.stats.eligible_updates == 2
    assert set(eng.score_requests([])) == {0, 1}
