"""K1/K2, the block-diagonal SplitNN bottom layer: the port's op (its
plain PyTorch version on the CPU) against the reference's
``splitnn_bottom(impl="pallas")`` in interpret mode, forward and
backward, on the same seeded inputs.

Tolerance: 1e-6 + 1e-5 · (the sum of the magnitudes of the terms each
output adds), e.g. Σ_k |x_k w_k| + |b| for a forward output.  Both sides
compute in f32 but sum in different orders (ROADMAP.md R2: no f32 GEMM
path is compared bitwise across backends); an order changes a sum by at
most a few ulps of those magnitudes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.splitnn_bottom.ops import splitnn_bottom as jax_bottom
from repro_torch.kernels.splitnn_bottom.ops import splitnn_bottom

SHAPES = [(3, 70, 5, 8), (2, 130, 17, 1)]
IDX_MODES = [None, "dup", "rem"]


def _inputs(shape, idx_mode, seed=0):
    m, n, d, o = shape
    g = np.random.default_rng(seed)
    x = g.normal(size=(m, n, d)).astype(np.float32)
    w = g.normal(size=(m, d, o)).astype(np.float32)
    b = g.normal(size=(m, o)).astype(np.float32)
    idx = None
    if idx_mode == "dup":      # a full step with repeated rows
        idx = g.integers(0, n, size=n).astype(np.int32)
        idx[1::7] = idx[0]
    elif idx_mode == "rem":    # a ragged step: not a tile multiple
        idx = g.integers(0, n, size=n // 2 + 3).astype(np.int32)
        idx[-1] = idx[0]
    gct = g.normal(size=(m, n if idx is None else len(idx), o)
                   ).astype(np.float32)
    return x, w, b, idx, gct


def _check(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    lim = 1e-6 + 1e-5 * scale
    assert (err <= lim).all(), float((err - lim).max())


def _port(x, w, b, idx, relu, grad_x=False):
    t = lambda a: torch.from_numpy(np.array(a))
    xt, wt, bt = t(x), t(w).requires_grad_(), t(b).requires_grad_()
    xt.requires_grad_(grad_x)
    it = None if idx is None else t(idx)
    return xt, wt, bt, splitnn_bottom(xt, wt, bt, relu, "ref", it)


def _jax_vjp(x, w, b, idx, relu, gct):
    jidx = None if idx is None else jnp.asarray(idx)
    out, vjp = jax.vjp(lambda x_, w_, b_: jax_bottom(
        x_, w_, b_, relu, "pallas", 64, jidx), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b))
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(gct))]


@pytest.mark.parametrize("idx_mode", IDX_MODES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_grads_match_reference(shape, relu, idx_mode):
    x, w, b, idx, gct = _inputs(shape, idx_mode)
    want, (jdx, jdw, jdb) = _jax_vjp(x, w, b, idx, relu, gct)
    xt, wt, bt, out = _port(x, w, b, idx, relu, grad_x=True)
    xg = x if idx is None else x[:, idx]
    scale = np.einsum("mbk,mko->mbo", np.abs(xg), np.abs(w)) + np.abs(
        b)[:, None]
    _check(out.detach().numpy(), want, scale)

    out.backward(torch.from_numpy(gct))
    dpre = np.where(want > 0, gct, 0) if relu else gct
    _check(wt.grad.numpy(), jdw,
           np.einsum("mbk,mbo->mko", np.abs(xg), np.abs(dpre)))
    _check(bt.grad.numpy(), jdb, np.abs(dpre).sum(1))
    dx_scale = np.einsum("mbo,mko->mbk", np.abs(dpre), np.abs(w))
    if idx is not None:          # scatter-add over duplicate slots
        full = np.zeros_like(x, dtype=np.float64)
        np.add.at(full, (slice(None), idx), dx_scale)
        dx_scale = full
    _check(xt.grad.numpy(), jdx, dx_scale)


@pytest.mark.parametrize("relu", [True, False])
def test_fused_gather_equals_gather_first_bitwise(relu):
    """With ``idx`` the op gathers inside the pass; on the CPU its plain
    version must equal gathering first, bit for bit, forward and
    backward (on the card K2 equals K1 on the gathered rows, checked by
    chip_smoke.py)."""
    x, w, b, idx, gct = _inputs(SHAPES[0], "dup", seed=3)
    _, wf, bf, fused = _port(x, w, b, idx, relu)
    _, wu, bu, unfused = _port(x[:, idx], w, b, None, relu)
    assert torch.equal(fused, unfused)
    fused.backward(torch.from_numpy(gct))
    unfused.backward(torch.from_numpy(gct))
    assert torch.equal(wf.grad, wu.grad) and torch.equal(bf.grad, bu.grad)


def test_backward_skips_input_grad_for_data():
    """The slab is data in training: no dx (and no slab-sized scatter)
    is computed for it."""
    x, w, b, idx, gct = _inputs(SHAPES[1], "rem")
    xt, wt, _, out = _port(x, w, b, idx, True)
    out.backward(torch.from_numpy(gct))
    assert xt.grad is None and wt.grad is not None
