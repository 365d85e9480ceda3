"""The int8 and fp8 wires fused into the bottom pass:
``splitnn_bottom(..., quant="int8")`` and its plain composition
``ref.splitnn_bottom_int8_wire`` against the reference's
``_int8_operands`` → int8 ``splitnn_bottom`` (its jnp oracle and its
Pallas kernels in interpret mode) → ``repro.quant.fake_quantize``;
``splitnn_bottom(..., quant="fp8")`` and its plain composition
``ref.splitnn_bottom_fp8_wire`` against the reference's f32
``splitnn_bottom(..., quant="fp8")`` → ``fake_quantize(·, "fp8")``; all on
the same seeded inputs.  Then the straight-through backward with the
ReLU mask read before the wire rounding, under both wires; the kernels'
tile geometry and shared memory; and the wire kernels refusing CPU
tensors.

Tolerances: the int8 forward is bitwise (exact pow2 scales, an exact
int32 accumulator, one rounding a step on both sides; data kept at
|e| <= 12, where XLA's CPU ``exp2`` is exact).  fp8's pass is an f32
GEMM summed in other orders on the two sides (R2/N4): its output before
the rounding within 1e-6 + 1e-5 · (Σ_k |x_k w_k| + |b|); the fp8 wire
rounding bitwise the reference's when applied to the reference's own
pass; the wire values within that tolerance plus one fp8 step of their
block (32·2^e, e4m3's step at [256, 448], of the coarser of the two
sides' exponents: an ulp can move a value across a rounding boundary or
a block's |max| across a power of two).  Gradients are f32 GEMMs summed
in other orders on the two sides (R2): within 1e-6 + 1e-5 · (the
magnitudes each output adds), as ``test_torch_quant.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as Q
from repro.kernels.splitnn_bottom.ops import splitnn_bottom as jax_bottom
from repro_torch import quant as P
from repro_torch.kernels.splitnn_bottom import ref
from repro_torch.kernels.splitnn_bottom.kernel import (
    SMEM_CAP, THREADS, f32_smem_bytes, int8_smem_bytes,
    rows_per_cta, splitnn_bottom_fp8_cuda, splitnn_bottom_fp8_gather_cuda,
    splitnn_bottom_int8_wire_cuda, splitnn_bottom_int8_wire_gather_cuda)
from repro_torch.kernels.splitnn_bottom.ops import int8_rows, splitnn_bottom

# (name, (M, N, d, o), relu, B gathered with duplicates or None)
CASES = [("eval_block", (3, 512, 11, 8), True, None),
         ("lr", (3, 512, 11, 1), False, None),
         ("serving_dispatch", (3, 64, 11, 8), True, None),
         ("ragged_o3", (3, 509, 11, 3), True, None),
         ("train_step", (3, 2000, 11, 8), True, 700)]


def _inputs(shape, bsz, seed=0):
    m, n, d, o = shape
    g = np.random.default_rng(seed)
    x = g.normal(size=(m, n, d)).astype(np.float32)
    w = (g.normal(size=(m, d, o)) * d ** -0.5).astype(np.float32)
    b = (g.normal(size=(m, o)) * 0.1).astype(np.float32)
    idx = None
    if bsz is not None:         # a step with repeated rows, ragged tail
        idx = g.integers(0, n, size=bsz).astype(np.int32)
        idx[1::50] = idx[0]
    return x, w, b, idx


def _jax_wire(x, w, b, relu, idx, impl):
    """The reference's composition: its int8 pass, then the wire."""
    jidx = None if idx is None else jnp.asarray(idx)
    pre = jax_bottom(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu,
                     impl, 64, jidx, "int8")
    return np.asarray(Q.fake_quantize(pre, "int8")), np.asarray(pre)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("name,shape,relu,bsz", CASES,
                         ids=[c[0] for c in CASES])
def test_wire_composition_bitwise_matches_reference(name, shape, relu, bsz,
                                                    impl):
    x, w, b, idx = _inputs(shape, bsz)
    want, want_pre = _jax_wire(x, w, b, relu, idx, impl)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    it = None if idx is None else torch.from_numpy(idx)
    wire, pre = ref.splitnn_bottom_int8_wire(*int8_rows(xt), wt, bt, relu,
                                             it)
    assert np.array_equal(wire.numpy(), want)
    assert np.array_equal(pre.numpy(), want_pre)
    op = splitnn_bottom(xt, wt, bt, relu, "ref", it, "int8")
    assert np.array_equal(op.numpy(), want)
    if bsz is not None:
        assert bsz % P.QUANT_BLOCK_ROWS     # a ragged tail block


def _scale(x, w, b, idx):
    """Σ_k |x_k w_k| + |b| per output: the f32 pass's term magnitudes."""
    xg = np.abs(x if idx is None else x[:, idx]).astype(np.float64)
    return xg @ np.abs(w) + np.abs(b)[:, None, :]


def _fp8_steps(*pres):
    """Per output, one fp8 step of its wire block, 32·2^e, at the coarser
    of the exponents the given passes' blocks get."""
    e = torch.stack([P.quantize_row_blocks(torch.as_tensor(p), "fp8")[1]
                     for p in pres]).amax(0)
    step = P.pow2(e).double() * 32.0                     # (M, nb)
    b = pres[0].shape[1]
    return step.repeat_interleave(P.QUANT_BLOCK_ROWS, 1)[:, :b, None].numpy()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("name,shape,relu,bsz", CASES,
                         ids=[c[0] for c in CASES])
def test_fp8_wire_composition_matches_reference(name, shape, relu, bsz,
                                                impl):
    """The fp8 wire's plain composition and the op against the
    reference's f32 pass followed by its fp8 ``fake_quantize``: the pass
    within the f32 tolerance, the rounding bitwise on the reference's own
    pass, the wire within the tolerance plus one fp8 step."""
    x, w, b, idx = _inputs(shape, bsz)
    jidx = None if idx is None else jnp.asarray(idx)
    jpre = jax_bottom(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu,
                      impl, 64, jidx, "fp8")
    want, want_pre = np.asarray(Q.fake_quantize(jpre, "fp8")), np.array(
        jpre)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    it = None if idx is None else torch.from_numpy(idx)
    wire, pre = ref.splitnn_bottom_fp8_wire(xt, wt, bt, relu, it)
    tol = 1e-6 + 1e-5 * _scale(x, w, b, idx)
    assert (np.abs(pre.numpy() - want_pre) <= tol).all()
    rounded = P.dequantize_row_blocks(*P.quantize_row_blocks(
        torch.from_numpy(want_pre), "fp8"))
    assert np.array_equal(rounded.numpy(), want)
    assert torch.equal(wire, P.fake_quantize(pre, "fp8"))
    step = _fp8_steps(pre.numpy(), want_pre)
    assert (np.abs(wire.numpy() - want) <= tol + step).all()
    op = splitnn_bottom(xt, wt, bt, relu, "ref", it, "fp8")
    assert torch.equal(op, wire)
    assert not torch.equal(wire, pre)          # the rounding did something


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_wire_relu_mask_keeps_gradient_of_zeroed_activation(quant, impl,
                                                            gather):
    """One large row puts its block's wire step above the other rows'
    activations, so positive activations go to 0 on the wire (fp8 keeps
    2^-9 of its range, so its row is larger).  Their gradient still flows
    (the mask reads the output before the rounding), as ``jax.grad`` of
    the reference composition gives it; also through the gather, the
    large row twice."""
    x, w, b, _ = _inputs((2, 24, 3, 2), None, seed=5)
    w[0] = np.abs(w[0])
    x[0, 0] = np.abs(x[0, 0]) * (1000.0 if quant == "int8" else 1e7)
    idx = (np.array([0, 3, 3, 5, 1, 2, 7, 8, 0, 11, 12, 13], np.int32)
           if gather else None)
    xg = x if idx is None else x[:, idx]
    g = np.random.default_rng(6).normal(
        size=(2, xg.shape[1], 2)).astype(np.float32)
    jidx = None if idx is None else jnp.asarray(idx)

    def loss(w_, b_):
        pre = jax_bottom(jnp.asarray(x), w_, b_, True, impl, 64, jidx,
                         quant)
        return jnp.sum(Q.fake_quantize(pre, quant) * jnp.asarray(g))

    jdw, jdb = [np.asarray(a) for a in jax.grad(loss, (0, 1))(
        jnp.asarray(w), jnp.asarray(b))]
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    it = None if idx is None else torch.from_numpy(idx)
    out = splitnn_bottom(torch.from_numpy(x), wt, bt, True, "ref", it,
                         quant)
    if quant == "int8":
        _, pre = ref.splitnn_bottom_int8_wire(
            *int8_rows(torch.from_numpy(x)), wt.detach(), bt.detach(), True,
            it)
    else:
        _, pre = ref.splitnn_bottom_fp8_wire(
            torch.from_numpy(x), wt.detach(), bt.detach(), True, it)
    zeroed = (pre > 0) & (out == 0)
    assert int(zeroed.sum()) >= 4
    (out * torch.from_numpy(g)).sum().backward()
    dpre = np.where(pre.numpy() > 0, g, 0)
    lim_w = 1e-6 + 1e-5 * np.einsum("mbk,mbo->mko", np.abs(xg),
                                    np.abs(dpre))
    lim_b = 1e-6 + 1e-5 * np.abs(dpre).sum(1)
    assert (np.abs(wt.grad.numpy() - jdw) <= lim_w).all()
    assert (np.abs(bt.grad.numpy() - jdb) <= lim_b).all()
    # a mask read after the rounding would drop the zeroed rows' terms
    wrong = np.where(out.detach().numpy() > 0, g, 0).sum(1)
    assert (np.abs(wrong - jdb) > lim_b).any()


def test_rows_per_cta_holds_whole_wire_blocks():
    """Every o in 1..256: a multiple of the wire block, at least one, at
    most max(8, THREADS / o), one thread an output and one trip of the
    quantizers where 8 rows fit; the HI and YP shapes' CTAs fit shared
    memory in every form."""
    for o in range(1, 257):
        rows = rows_per_cta(o)
        assert rows % P.QUANT_BLOCK_ROWS == 0 and rows >= 8
        assert rows <= max(8, THREADS / o)
        if o <= THREADS // 8:
            assert rows * o <= THREADS and rows + o <= THREADS
    assert [rows_per_cta(o) for o in (1, 2, 3, 8)] == [128, 128, 80, 32]
    for d, o in ((11, 1), (11, 3), (11, 8), (30, 1)):
        for gather in (False, True):
            for wire in (False, True):
                assert int8_smem_bytes(d, o, rows_per_cta(o), gather,
                                       wire) <= SMEM_CAP


def test_f32_forms_fit_shared_memory():
    """K1/K2's CTAs, f32 and fp8 wire form, take ``rows_per_cta(o)``
    rows; the HI and YP shapes' CTAs fit shared memory in every form, a
    layer as wide as o = 300 too, and a wire form's maxima and held
    outputs are counted."""
    for d, o in ((11, 1), (11, 3), (11, 8), (30, 1), (11, 300)):
        for gather in (False, True):
            for wire in (False, True):
                assert f32_smem_bytes(d, o, rows_per_cta(o), gather,
                                      wire) <= SMEM_CAP
    assert (f32_smem_bytes(11, 8, 32, False, True)
            - f32_smem_bytes(11, 8, 32, False, False)) == 4 * (4 + 32 * 8)


def test_fp8_wire_kernels_refuse_cpu_tensors():
    x, w, b, idx = _inputs((3, 70, 5, 8), 40)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    it = torch.from_numpy(idx)
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom_fp8_cuda(xt, wt, bt, True)
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom_fp8_gather_cuda(it, xt, wt, bt, True, True)
    for i in (None, it):
        with pytest.raises(ValueError, match="CUDA"):
            splitnn_bottom(xt, wt, bt, True, "kernel", i, "fp8")


def test_wire_kernels_refuse_cpu_tensors():
    x, w, b, idx = _inputs((3, 70, 5, 8), 40)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    it = torch.from_numpy(idx)
    xq, sx = int8_rows(xt)
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom_int8_wire_cuda(xt, wt, bt, True)
    with pytest.raises(ValueError, match="CUDA"):
        splitnn_bottom_int8_wire_gather_cuda(it, xq, sx, wt, bt, True)
    for i in (None, it):
        with pytest.raises(ValueError, match="CUDA"):
            splitnn_bottom(xt, wt, bt, True, "kernel", i, "int8")
