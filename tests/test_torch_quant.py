"""The quant slice: the int8/fp8 activation wire of the port against the
reference's (``repro.quant``, the int8 ``splitnn_bottom`` twins, the
quantized training, serving and pipeline paths), on the same seeded
inputs.  The reference's bottom layer runs its Pallas kernels in
interpret mode or its jnp oracle (``impl="ref"``); the port's runs its
plain versions.

Tolerances and why:

- Quantizers, the int8 bottom pass and the wire rounding: bitwise.  The
  scales are exact powers of two and the int8 accumulator is exact, so
  every step rounds once, the same way, on both sides.  The reference's
  ``exp2`` is exact only for |e| <= 12 on XLA's CPU (``exp2(13.0)`` is
  8192.004), so the bitwise tests keep their data at the magnitudes of
  real activations and weights, |e| <= 12; ``pow2_exponent`` itself is
  held bitwise over 2^-140 ... 2^120, its subnormal flush included
  (ROADMAP.md N6).
- f32 GEMMs (the top model, the backward, fp8's f32 bottom pass) sum in
  other orders on the two sides (R2), so their outputs take the f32
  term tolerance 1e-6 + 1e-5 · (the magnitudes each output adds).  Where
  an f32 difference of an ulp can move a value across a wire rounding
  boundary (fp8's f32 bottom pass, or the wire blocks of two batch
  layouts, R3), outputs are held within one wire step, carried through
  the top layers, plus that tolerance.
- Training: params part by f32 ulps after the first step (the top
  model and the backward are f32 GEMMs), and a later wire rounding could
  flip one step.  The epoch losses over 3 epochs are held within rtol
  1e-4 and the params within 1e-4 + 1e-3·|p|, as the f32 engine tests
  hold theirs; one flipped step would show as ~1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cls_partition
from repro import quant as Q
from repro.config import AlignOptions as JaxAlign
from repro.config import EngineOptions as JaxEngine
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import init_splitnn as jax_init
from repro.core.treecss import run_pipeline as jax_run_pipeline
from repro.data.synthetic import DATASETS, make_dataset
from repro.data.vertical import partition_features
from repro.kernels.splitnn_bottom.ops import splitnn_bottom as jax_bottom
from repro.serve import vfl as jax_serve
from repro.train import vfl as jax_vfl
from repro_torch import quant as P
from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core import splitnn as models
from repro_torch.core.splitnn import SplitNNConfig, train_splitnn
from repro_torch.core.treecss import run_pipeline
from repro_torch.data.vertical import VerticalPartition
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels.splitnn_bottom.ops import int8_rows, splitnn_bottom
from repro_torch.serve import vfl
from repro_torch.train import vfl as port_vfl

QUANTS = ["int8", "fp8"]


def _bits(q) -> np.ndarray:
    """A wire tensor (torch or jax, int8 or fp8) as its int8 bit pattern."""
    if isinstance(q, torch.Tensor):
        return (q if q.dtype == torch.int8 else q.view(torch.int8)).numpy()
    return np.asarray(q).view(np.int8)


def _port_part(part):
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


@pytest.fixture
def same_init(monkeypatch):
    """Start the port from the reference's initial params, carried
    across exactly."""
    monkeypatch.setattr(models, "init_splitnn", lambda cfg, fd, device=None:
                        params_from_jax(jax_init(cfg, list(fd)), device))


# ------------------------------------------------------------ quantizers

def test_resolve_and_supported_quants():
    for alias in (None, "", "none", "f32", "fp32"):
        assert P.resolve_quant(alias) is None
    assert P.resolve_quant("int8") == "int8"
    assert P.resolve_quant("fp8") == "fp8"
    with pytest.raises(ValueError):
        P.resolve_quant("int4")
    assert P.supported_quants() == Q.supported_quants() == ("int8", "fp8")
    assert P.QUANT_BLOCK_ROWS == Q.QUANT_BLOCK_ROWS
    for quant in (None, "int8", "fp8"):
        assert P.wire_bytes(quant) == Q.wire_bytes(quant)
        for rows in (1, 7, 8, 700):
            assert P.payload_bytes(8, rows, 3, quant) == Q.payload_bytes(
                8, rows, 3, quant)
            assert P.scale_bytes_per_step(rows, 3, quant) == (
                Q.scale_bytes_per_step(rows, 3, quant))


@pytest.mark.parametrize("quant", QUANTS)
def test_pow2_exponent_matches_reference(quant):
    """``test_quant.py``'s exact cases, qmax·2^k and its float
    neighbours for every k, and seeded magnitudes over 2^-140 ... 2^120:
    bitwise, the reference's flush of subnormal amax/qmax included."""
    qmax = 127.0 if quant == "int8" else 448.0
    k = np.arange(-150, 120, dtype=np.float64)
    edge = (qmax * np.exp2(k)).astype(np.float32)
    g = np.random.default_rng(11)
    amax = np.concatenate([
        # ... and 3.0279161e-05, whose /127 rounds to 2^-22 if taken as a
        # multiply by fl(1/127), as CUDA divides by a host scalar
        np.float32([0.0, 127.0, 254.0, 1.0, 2.0 ** -10, 1e-37,
                    3.027916136488784e-05]),
        edge, np.nextafter(edge, np.float32(0)),
        np.nextafter(edge, np.float32(np.inf)),
        np.exp2(g.uniform(-140, 120, 100_000)).astype(np.float32)])
    want = np.asarray(Q.pow2_exponent(jnp.asarray(amax), quant))
    got = P.pow2_exponent(torch.from_numpy(amax), quant)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    # every scale 2^e is a normal f32, so dequantizing stays exact
    assert got.min() >= -126 and got.max() <= 122
    scale = P.pow2(got).double()
    assert bool((scale == torch.exp2(got.double())).all())
    nz = torch.from_numpy(amax).double() / qmax >= 2.0 ** -126
    assert bool((torch.from_numpy(amax).double()[nz] <= qmax * scale[nz]).all())


@pytest.mark.parametrize("quant", QUANTS)
def test_subnormal_block_flushes_to_zero(quant):
    """N6: a block with amax = 1e-37 has amax/qmax below the smallest
    normal f32; the reference's XLA flushes it, so its exponent is 0 and
    it quantizes to exact zero, in the port too."""
    acts = np.zeros((2, 16, 3), np.float32)
    acts[0, :8] = np.float32(1e-37)
    acts[0, 3, 1] = -np.float32(1e-37)
    acts[1, 8:] = np.random.default_rng(0).normal(size=(8, 3))
    jq, je = Q.quantize_row_blocks(jnp.asarray(acts), quant)
    tq, te = P.quantize_row_blocks(torch.from_numpy(acts), quant)
    assert int(te[0, 0]) == 0 and not tq[0, :8].float().any()  # ±0
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(_bits(tq), _bits(jq))
    deq = P.dequantize_row_blocks(tq, te)
    assert not deq[0, :8].any()
    assert np.array_equal(deq.numpy(),
                          np.asarray(Q.dequantize_row_blocks(jq, je)))


def _acts(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_rows_and_columns_match_reference(quant):
    x = _acts((3, 700, 11), 1)
    w = _acts((3, 11, 8), 2, 0.3)
    for qfn, pfn, a in ((Q.quantize_rows, P.quantize_rows, x),
                        (Q.quantize_columns, P.quantize_columns, w)):
        jq, je = qfn(jnp.asarray(a), quant)
        tq, te = pfn(torch.from_numpy(a), quant)
        assert tq.dtype == (torch.int8 if quant == "int8" else P.FP8_DTYPE)
        assert np.array_equal(_bits(tq), _bits(jq))
        assert np.array_equal(te.numpy(), np.asarray(je))
        bshape = (*te.shape, 1) if pfn is P.quantize_rows else (
            te.shape[0], 1, te.shape[1])
        assert np.array_equal(
            P.dequantize(tq, te.reshape(bshape)).numpy(),
            np.asarray(Q.dequantize(jq, je.reshape(bshape))))


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_row_blocks_match_reference(quant):
    """B = 700: 87 full blocks of 8 rows and a ragged tail of 4."""
    acts = _acts((3, 700, 8), 3)
    jq, je = Q.quantize_row_blocks(jnp.asarray(acts), quant)
    tq, te = P.quantize_row_blocks(torch.from_numpy(acts), quant)
    assert te.shape == (3, 88) and tq.shape == acts.shape
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(_bits(tq), _bits(jq))
    deq = P.dequantize_row_blocks(tq, te)
    assert np.array_equal(deq.numpy(),
                          np.asarray(Q.dequantize_row_blocks(jq, je)))
    # half an LSB of the pow2 step for int8; fp8's 3-bit mantissa: 1/16
    step = np.repeat(np.exp2(te.numpy().astype(np.float64)), 8, 1)[:, :700]
    err = np.abs(deq.numpy() - acts).max(-1)
    rel = 0.5 if quant == "int8" else 0.0625 * 448
    assert (err <= rel * step).all()


@pytest.mark.parametrize("quant", QUANTS)
def test_pack_unpack_payload_round_trip(quant):
    acts = _acts((3, 700, 1), 4)
    jq, je = Q.quantize_row_blocks(jnp.asarray(acts), quant)
    tq, te = P.quantize_row_blocks(torch.from_numpy(acts), quant)
    payload = P.pack_payload(tq, te)
    assert payload.dtype == torch.int8 and payload.shape == (3, 700 + 88)
    assert np.array_equal(payload.numpy(),
                          np.asarray(Q.pack_payload(jq, je)))
    q2, e2 = P.unpack_payload(payload, 700, 1, quant)
    assert q2.dtype == tq.dtype
    assert np.array_equal(_bits(q2), _bits(tq))
    assert torch.equal(e2, te)
    # <= 0.3x the f32 payload at width 1 (lr), exponents included
    assert payload.numel() <= 0.3 * acts.size * 4


@pytest.mark.parametrize("quant", QUANTS)
def test_fake_quantize_forward_bitwise_backward_identity(quant):
    acts = _acts((3, 45, 8), 5)
    want = np.asarray(Q.fake_quantize(jnp.asarray(acts), quant))
    x = torch.from_numpy(acts).requires_grad_()
    out = P.fake_quantize(x, quant)
    assert np.array_equal(out.detach().numpy(), want)
    g = torch.from_numpy(_acts((3, 45, 8), 6))
    out.backward(g)
    assert torch.equal(x.grad, g)


@pytest.mark.parametrize("quant", QUANTS)
def test_exact_zeros_for_zero_rows_and_dummy_clients(quant):
    acts = _acts((4, 24, 4), 7)
    acts[3] = 0.0                 # a dummy client
    acts[:, 20:] = 0.0            # zero-padded tail rows
    q, e = P.quantize_row_blocks(torch.from_numpy(acts), quant)
    deq = P.dequantize_row_blocks(q, e)
    assert not deq[3].any() and not deq[:, 20:].any()
    assert not e[3].any()
    assert np.array_equal(deq.numpy(), np.asarray(Q.dequantize_row_blocks(
        *Q.quantize_row_blocks(jnp.asarray(acts), quant))))


# --------------------------------------------------- the int8 bottom pass

SHAPES = [(3, 70, 5, 8), (2, 130, 17, 1), (3, 700, 11, 8)]
IDX_MODES = [None, "dup"]


def _bottom_inputs(shape, idx_mode, seed=0):
    m, n, d, o = shape
    g = np.random.default_rng(seed)
    x = g.normal(size=(m, n, d)).astype(np.float32)
    w = (g.normal(size=(m, d, o)) * d ** -0.5).astype(np.float32)
    b = (g.normal(size=(m, o)) * 0.1).astype(np.float32)
    idx = None
    if idx_mode == "dup":      # a step with repeated rows, not a tile multiple
        idx = g.integers(0, n, size=n // 2 + 3).astype(np.int32)
        idx[1::7] = idx[0]
    gct = g.normal(size=(m, n if idx is None else len(idx), o)
                   ).astype(np.float32)
    return x, w, b, idx, gct


def _port_bottom(x, w, b, idx, relu, quant, grad=False):
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_(grad)
    bt = torch.from_numpy(b).requires_grad_(grad)
    it = None if idx is None else torch.from_numpy(idx)
    return wt, bt, splitnn_bottom(xt, wt, bt, relu, "ref", it, quant)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("idx_mode", IDX_MODES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_bottom_bitwise_matches_reference(shape, relu, idx_mode, impl):
    """The port's int8 op returns the wire value: the reference's int8
    pass followed by its wire rounding."""
    x, w, b, idx, _ = _bottom_inputs(shape, idx_mode)
    want = np.asarray(Q.fake_quantize(jax_bottom(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu, impl, 64,
        None if idx is None else jnp.asarray(idx), "int8"), "int8"))
    _, _, got = _port_bottom(x, w, b, idx, relu, "int8")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("idx_mode", IDX_MODES)
@pytest.mark.parametrize("relu", [True, False])
def test_int8_bottom_grads_match_reference(relu, idx_mode):
    """The straight-through f32 backward, with the ReLU mask of the
    quantized forward before its wire rounding (whose own backward is
    the identity): within the f32 term tolerance (R2)."""
    x, w, b, idx, gct = _bottom_inputs(SHAPES[0], idx_mode, seed=2)
    jidx = None if idx is None else jnp.asarray(idx)
    out, vjp = jax.vjp(lambda w_, b_: jax_bottom(
        jnp.asarray(x), w_, b_, relu, "pallas", 64, jidx, "int8"),
        jnp.asarray(w), jnp.asarray(b))
    jdw, jdb = [np.asarray(a) for a in vjp(jnp.asarray(gct))]
    wt, bt, got = _port_bottom(x, w, b, idx, relu, "int8", grad=True)
    assert np.array_equal(got.detach().numpy(),
                          np.asarray(Q.fake_quantize(out, "int8")))
    got.backward(torch.from_numpy(gct))
    xg = x if idx is None else x[:, idx]
    dpre = np.where(np.asarray(out) > 0, gct, 0) if relu else gct
    lim = 1e-6 + 1e-5 * np.einsum("mbk,mbo->mko", np.abs(xg), np.abs(dpre))
    assert (np.abs(wt.grad.numpy() - jdw) <= lim).all()
    assert (np.abs(bt.grad.numpy() - jdb)
            <= 1e-6 + 1e-5 * np.abs(dpre).sum(1)).all()


@pytest.mark.parametrize("idx_mode", IDX_MODES)
def test_fp8_bottom_is_the_f32_pass_and_bad_quant_raises(idx_mode):
    """fp8 is comm-only: the op's output is the f32 pass with the wire
    rounding applied (``fake_quantize``, now inside the op), and its
    gradients are the f32 pass's (the mask reads the output before the
    rounding, whose own backward is the identity)."""
    x, w, b, idx, gct = _bottom_inputs(SHAPES[1], idx_mode, seed=3)
    wf, bf, f32 = _port_bottom(x, w, b, idx, True, None, grad=True)
    w8, b8, fp8 = _port_bottom(x, w, b, idx, True, "fp8", grad=True)
    assert torch.equal(fp8, P.fake_quantize(f32, "fp8"))
    assert not torch.equal(fp8, f32)
    f32.backward(torch.from_numpy(gct))
    fp8.backward(torch.from_numpy(gct))
    assert torch.equal(w8.grad, wf.grad) and torch.equal(b8.grad, bf.grad)
    with pytest.raises(ValueError, match="quant"):
        _port_bottom(x, w, b, idx, True, "int4")


def test_int8_rows_precomputed_equals_per_call():
    """A caller's ``int8_rows(slab)`` (quantized once per run) gives the
    bits the op computes per call; rows of another shape raise."""
    x, w, b, idx, _ = _bottom_inputs(SHAPES[2], "dup", seed=4)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    it = torch.from_numpy(idx)
    rows = int8_rows(xt)
    assert rows[0].dtype == torch.int8 and rows[1].shape == x.shape[:2]
    once = splitnn_bottom(xt, wt, bt, True, "ref", it, "int8", x_int8=rows)
    assert torch.equal(once, splitnn_bottom(xt, wt, bt, True, "ref", it,
                                            "int8"))
    with pytest.raises(ValueError, match="x_int8"):
        splitnn_bottom(xt[:, :10], wt, bt, True, "ref", None, "int8",
                       x_int8=rows)


def test_int8_kernel_refuses_cpu_tensors():
    x, w, b, idx, _ = _bottom_inputs(SHAPES[0], "dup")
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom(xt, wt, bt, True, "kernel", None, "int8")
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom(xt, wt, bt, True, "kernel", torch.from_numpy(idx),
                       "int8")


# -------------------------------------------------------------- training

_REF = {}


def _cfgs(model, n_classes, **kw):
    kw = {**dict(model=model, n_classes=n_classes, lr=0.02, batch_size=64,
                 max_epochs=3), **kw}
    return JaxConfig(**kw), SplitNNConfig(**kw)


def _ref_scan(model, n_classes, quant, fuse):
    key = (model, n_classes, quant, fuse)
    if key not in _REF:
        part = make_cls_partition(n=230, d=11, classes=max(n_classes, 2),
                                  seed=1)
        jcfg, _ = _cfgs(model, n_classes)
        _REF[key] = (part, jax_vfl.train_scan(part, jcfg, options=JaxEngine(
            bottom_impl="pallas", fuse_gather=fuse, quant=quant)))
    return _REF[key]


TRAIN_CASES = [("lr", 2, "int8", True), ("mlp", 4, "int8", True),
               ("mlp", 4, "int8", False), ("lr", 2, "fp8", True),
               ("mlp", 4, "fp8", True)]


@pytest.mark.parametrize("model,n_classes,quant,fuse", TRAIN_CASES)
def test_train_scan_quant_matches_reference(same_init, model, n_classes,
                                            quant, fuse):
    """230 rows in batches of 64 (a 38-row remainder step whose filler
    rows stay in the bottom pass and the wire blocks), 3 epochs."""
    part, want = _ref_scan(model, n_classes, quant, fuse)
    _, cfg = _cfgs(model, n_classes)
    got = port_vfl.train_scan(_port_part(part), cfg, options=EngineOptions(
        device="cpu", fuse_gather=fuse, quant=quant))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    gp, wp = _flat(params_to_numpy(got.params)), _flat(want.params)
    assert (np.abs(gp - wp) <= 1e-4 + 1e-3 * np.abs(wp)).all()
    assert (got.epochs, got.steps, got.comm_bytes) == (
        want.epochs, want.steps, want.comm_bytes)
    for f in ("dispatches", "host_syncs", "steps_per_epoch",
              "padded_batch", "gather_payload_bytes", "quant"):
        assert getattr(got.engine_stats, f) == getattr(want.engine_stats, f)
    assert got.engine_stats.quant == quant


@pytest.mark.parametrize("model,n_classes", [("lr", 2), ("mlp", 4)])
def test_first_step_bottom_output_bitwise(model, n_classes):
    """The first step's int8 bottom pass and wire rounding (the port's
    int8 op, the reference's op then ``fake_quantize``), from the same
    params on the same schedule rows: bitwise."""
    part = make_cls_partition(n=230, d=11, classes=max(n_classes, 2), seed=1)
    jcfg, _ = _cfgs(model, n_classes)
    fd = [f.shape[1] for f in part.client_features]
    jp = jax_vfl.pack_slab_params(jax_init(jcfg, fd), max(fd))
    tp = port_vfl.pack_slab_params(params_from_jax(jax_init(jcfg, fd),
                                                   "cpu"), max(fd))
    slab = jax_vfl.pack_slab(part.client_features)
    order = np.random.default_rng(jcfg.seed).permutation(230)
    idx, _ = jax_vfl.epoch_schedule(order, 230, 64, 4, 64)
    m, o = len(fd), jp["bw"].shape[2]
    relu = model == "mlp"
    jb = jp.get("bb", jnp.zeros((m, o), jnp.float32))
    tb = tp.get("bb", torch.zeros((m, o)))
    want = Q.fake_quantize(jax_bottom(
        jnp.asarray(slab), jp["bw"], jb, relu, "pallas", 512,
        jnp.asarray(idx[0]), "int8"), "int8")
    ts = torch.from_numpy(slab)
    got = splitnn_bottom(ts, tp["bw"], tb, relu, "ref",
                         torch.from_numpy(idx[0]), "int8",
                         x_int8=int8_rows(ts))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))


def test_quant_payload_and_loop_engines_refuse():
    """The int8 wire's payload is <= 0.3x the f32 one; the per-step loop
    engine and the per-client bottom oracle communicate f32 only."""
    part, want = _ref_scan("lr", 2, "int8", True)
    _, cfg = _cfgs("lr", 2, max_epochs=1)
    pp = _port_part(part)
    f32 = train_splitnn(pp, cfg, options=EngineOptions(device="cpu"))
    q = train_splitnn(pp, cfg, options=EngineOptions(device="cpu",
                                                     quant="int8"))
    assert (q.engine_stats.gather_payload_bytes
            <= 0.3 * f32.engine_stats.gather_payload_bytes)
    assert q.comm_bytes < f32.comm_bytes
    with pytest.raises(ValueError, match="f32 only"):
        train_splitnn(pp, cfg, options=EngineOptions(
            device="cpu", train_engine="loop", quant="int8"))
    with pytest.raises(ValueError, match="slab"):
        train_splitnn(pp, cfg, options=EngineOptions(
            device="cpu", bottom_impl="loop", quant="fp8"))


# --------------------------------------------------------------- serving

def _setup(model, n_classes, n=150, seed=1):
    part = make_cls_partition(n=n, d=11, classes=max(n_classes, 2),
                              seed=seed)
    kw = dict(model=model, n_classes=n_classes, seed=seed)
    jp = jax_init(JaxConfig(**kw), [f.shape[1] for f in
                                    part.client_features])
    return (part, _port_part(part), JaxConfig(**kw), SplitNNConfig(**kw),
            jp, params_from_jax(jp, "cpu"))


def _abs_params(params):
    return {"bottoms": [{k: np.abs(np.asarray(v, np.float64))
                         for k, v in bp.items()} for bp in params["bottoms"]],
            "top": {k: np.abs(np.asarray(v, np.float64))
                    for k, v in params["top"].items()}}


def _top(p, cfg, acts):
    """Carry per-client, per-row magnitudes (M, B, o) through the top
    layers' absolute values."""
    if cfg.model in ("lr", "linreg"):
        return acts.sum(0)
    h = np.concatenate(list(acts), 1) @ p["top"]["w1"]
    return h @ p["top"]["w2"]


def _term_scale(params, cfg, feats):
    """Per output, the summed magnitudes of every term it adds."""
    p = _abs_params(params)
    acts = np.stack([np.abs(f) @ bp["w"] + bp.get("b", 0.0)
                     for f, bp in zip(feats, p["bottoms"])])
    if cfg.model in ("lr", "linreg"):
        return acts.sum(0) + p["top"]["b"]
    h = np.concatenate(list(acts), 1) @ p["top"]["w1"] + p["top"]["b1"]
    return h @ p["top"]["w2"] + p["top"]["b2"]


def _wire_step(params, cfg, feats, quant):
    """One wire step per activation, carried through the top layers: the
    step of the coarsest exponent any block of a client can get (that of
    the client's largest activation over ``feats`` and the zero rows'
    ``relu(b)``); for fp8, the step at the top of its mantissa range."""
    p = _abs_params(params)
    a = [np.abs(f) @ bp["w"] + bp.get("b", 0.0)
         for f, bp in zip(feats, p["bottoms"])]
    amax = torch.tensor([float(max(x.max(), bp.get("b", np.zeros(1)).max()))
                         for x, bp in zip(a, p["bottoms"])])
    step = P.pow2(P.pow2_exponent(amax, quant)).double().numpy()
    if quant == "fp8":
        step = step * 32.0            # e4m3's step at [256, 448]
    acts = np.stack([np.full(x.shape, s) for x, s in zip(a, step)])
    return _top(p, cfg, acts)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("model,n_classes", [("lr", 2), ("mlp", 4)])
def test_score_step_matches_reference(model, n_classes, quant):
    """``make_score_step``/``forward_slab_eval`` under a quant on the
    same packed params: int8 lr is bitwise (exact bottom, exact wire,
    the client sum unrolled in the same order); mlp's top is an f32 GEMM;
    fp8's bottom pass is f32, so a wire value may round to its
    neighbour."""
    part, ppart, jcfg, cfg, jp, tp = _setup(model, n_classes)
    fd = [f.shape[1] for f in part.client_features]
    jpk, jstep = jax_vfl.make_score_step(jp, jcfg, fd, bottom_impl="pallas",
                                         block_b=150, quant=quant)
    tpk, tstep = port_vfl.make_score_step(tp, cfg, fd, quant=quant)
    assert tstep.quant == quant and tstep.bottom_impl == "ref"
    slab = jax_vfl.pack_slab(part.client_features)
    want = np.asarray(jstep(jpk, jnp.asarray(slab)))
    got = tstep(tpk, torch.from_numpy(slab)).numpy()
    direct = port_vfl.forward_slab_eval(tpk, cfg, len(fd),
                                        torch.from_numpy(slab), quant=quant)
    assert torch.equal(direct.detach(), torch.from_numpy(got))
    feats = part.client_features
    if model == "lr" and quant == "int8":
        assert np.array_equal(got, want)
        return
    lim = 1e-6 + 1e-5 * _term_scale(jp, cfg, feats)
    if quant == "fp8":
        lim = lim + _wire_step(jp, cfg, feats, quant)
    assert (np.abs(got - want) <= lim).all()


def _trace(part, seed=4, n_requests=36):
    g = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        rows = int(g.integers(1, 12)) if rid % 9 else int(g.integers(17, 30))
        idx = g.integers(0, part.n_samples, size=rows)
        out.append((rid, [f[idx] for f in part.client_features]))
    return out


def _drive(engine, trace):
    for rid, feats in trace:
        engine.submit(rid, feats)
    results = {}
    while engine.has_work:
        for rid, out in engine.step():
            results[rid] = out
    return results


@pytest.mark.parametrize("model,n_classes", [("mlp", 4), ("lr", 2)])
def test_engine_int8_matches_reference_engine(model, n_classes):
    """The same trace through both engines puts the same rows in the
    same slots, so the wire blocks match: lr bitwise, mlp within the f32
    term tolerance; ``ServeStats`` equal."""
    part, ppart, jcfg, cfg, jp, tp = _setup(model, n_classes, n=90)
    trace = _trace(part)
    ref = jax_serve.VFLScoringEngine(jp, jcfg, slots=16, max_defer=1,
                                     bottom_impl="pallas", quant="int8")
    eng = vfl.VFLScoringEngine(tp, cfg, slots=16, max_defer=1, quant="int8")
    want, got = _drive(ref, trace), _drive(eng, trace)
    for f in vfl.ServeStats.CONTRACT_FIELDS + ("quant", "slots"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.stats.quant == "int8"
    for rid, feats in trace:
        if model == "lr":
            assert np.array_equal(got[rid], want[rid])
        else:
            lim = 1e-6 + 1e-5 * _term_scale(jp, cfg, feats)
            assert (np.abs(got[rid] - want[rid]) <= lim).all()


@pytest.mark.parametrize("quant", QUANTS)
def test_engine_vs_score_partition_within_one_wire_step(quant):
    """R3: quantized rows are not independent.  The engine's slots and
    score_partition's blocks group other rows into each wire block, so
    their outputs agree within one wire step (carried through the top),
    not bitwise."""
    part, ppart, jcfg, cfg, jp, tp = _setup("mlp", 4, n=120)
    feats = ppart.client_features
    want = vfl.score_partition(tp, cfg, ppart, block_b=64, quant=quant)
    eng = vfl.VFLScoringEngine(tp, cfg, slots=16, quant=quant)
    trace = [(rid, [f[s:s + 7] for f in feats])
             for rid, s in enumerate(range(0, 120, 7))]
    got = _drive(eng, trace)
    got = np.concatenate([got[rid] for rid, _ in trace])
    lim = (1e-6 + 1e-5 * _term_scale(jp, cfg, feats)
           + _wire_step(jp, cfg, feats, quant))
    assert (np.abs(got - want) <= lim).all()


# ------------------------------------------------------------ the slice

N, K, SEED = 900, 14, 0


def _hi_partitions():
    x, y = make_dataset(DATASETS["HI"], seed=SEED, n_override=N)
    order = np.random.default_rng(SEED + 1).permutation(N)
    n_tr = int(N * 0.7)
    return (partition_features(x[order[:n_tr]], y[order[:n_tr]], 3),
            partition_features(x[order[n_tr:]], y[order[n_tr:]], 3))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("model", ["lr", "mlp"])
def test_pipeline_quant_matches_reference(same_init, model, quant):
    """``run_pipeline`` treecss on the paper's HI spec cut to 900 rows
    (as ``test_torch_pipeline.py``), 5 epochs of batches of 64: the
    alignment, coreset and training counters exactly, the epoch losses
    within rtol 1e-4 and the accuracy within one test row."""
    tr, te = _hi_partitions()
    kw = dict(model=model, n_classes=2, lr=0.05, batch_size=64,
              max_epochs=5)
    want = jax_run_pipeline(
        tr, te, JaxConfig(**kw), variant="treecss", clusters_per_client=K,
        kmeans_impl="pallas", seed=SEED,
        options=JaxEngine(bottom_impl="pallas", quant=quant),
        align=JaxAlign(protocol="oprf", psi_backend="device",
                       impl="pallas"))
    got = run_pipeline(
        _port_part(tr), _port_part(te), SplitNNConfig(**kw),
        variant="treecss", clusters_per_client=K, seed=SEED,
        options=EngineOptions(device="cpu", quant=quant),
        align=AlignOptions(protocol="oprf", psi_backend="device"))
    assert np.array_equal(got.mpsi.intersection, want.mpsi.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        assert getattr(got.mpsi, f) == getattr(want.mpsi, f), f
    assert np.array_equal(got.coreset.indices, want.coreset.indices)
    assert np.array_equal(got.coreset.weights, want.coreset.weights)
    assert got.n_train == want.n_train
    for f in ("epochs", "steps", "comm_bytes"):
        assert getattr(got.train, f) == getattr(want.train, f), f
    for f in ("gather_payload_bytes", "quant", "steps_per_epoch"):
        assert (getattr(got.train.engine_stats, f)
                == getattr(want.train.engine_stats, f)), f
    np.testing.assert_allclose(got.train.losses, want.train.losses,
                               rtol=1e-4)
    assert abs(got.metric - want.metric) <= 1 / te.n_samples + 1e-12
