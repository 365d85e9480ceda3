"""The int8 wire fused into the bottom pass: ``splitnn_bottom(...,
quant="int8")`` and its plain composition
``ref.splitnn_bottom_int8_wire`` against the reference's
``_int8_operands`` → int8 ``splitnn_bottom`` (its jnp oracle and its
Pallas kernels in interpret mode) → ``repro.quant.fake_quantize``, on the
same seeded inputs; the straight-through backward with the ReLU mask
read before the wire rounding; the int8 kernels' tile geometry; and the
wire kernels refusing CPU tensors.

Tolerances: the forward is bitwise (exact pow2 scales, an exact int32
accumulator, one rounding a step on both sides; data kept at |e| <= 12,
where XLA's CPU ``exp2`` is exact).  Gradients are f32 GEMMs summed in
other orders on the two sides (R2): within 1e-6 + 1e-5 · (the magnitudes
each output adds), as ``test_torch_quant.py`` holds them.
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
    SMEM_CAP, THREADS, int8_smem_bytes, rows_per_cta,
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


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_wire_relu_mask_keeps_gradient_of_zeroed_activation(impl, gather):
    """One large row puts its block's wire step above the other rows'
    activations, so positive activations go to 0 on the wire.  Their
    gradient still flows (the mask reads the output before the
    rounding), as ``jax.grad`` of the reference composition gives it;
    also through the gather, the large row twice."""
    x, w, b, _ = _inputs((2, 24, 3, 2), None, seed=5)
    w[0] = np.abs(w[0])
    x[0, 0] = np.abs(x[0, 0]) * 1000.0
    idx = (np.array([0, 3, 3, 5, 1, 2, 7, 8, 0, 11, 12, 13], np.int32)
           if gather else None)
    xg = x if idx is None else x[:, idx]
    g = np.random.default_rng(6).normal(
        size=(2, xg.shape[1], 2)).astype(np.float32)
    jidx = None if idx is None else jnp.asarray(idx)

    def loss(w_, b_):
        pre = jax_bottom(jnp.asarray(x), w_, b_, True, impl, 64, jidx,
                         "int8")
        return jnp.sum(Q.fake_quantize(pre, "int8") * jnp.asarray(g))

    jdw, jdb = [np.asarray(a) for a in jax.grad(loss, (0, 1))(
        jnp.asarray(w), jnp.asarray(b))]
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    it = None if idx is None else torch.from_numpy(idx)
    out = splitnn_bottom(torch.from_numpy(x), wt, bt, True, "ref", it,
                         "int8")
    _, pre = ref.splitnn_bottom_int8_wire(*int8_rows(torch.from_numpy(x)),
                                          wt.detach(), bt.detach(), True, it)
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
