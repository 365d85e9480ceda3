"""K11 (flash attention): the port's plain version against the JAX
package's oracle (``repro/kernels/flash_attention/ref.py``) and its Pallas
kernel in interpret mode (``ops.py``), on the same seeded inputs.

Tolerance: <= 1e-5 abs in f32 (the reference's own kernel-vs-oracle gap is
7.2e-7 at these shapes); in bf16 the port and the reference's kernel both
compute in f32 and round once, so they agree within one bf16 ulp
(2^-7·|out|).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against this plain version); here its wrapper
must refuse a CPU tensor, also under grad, where the op's autograd
``Function`` reaches it, while the plain version's gradients match
``jax.grad`` of the reference's oracle within 1e-5·(1 + max|grad|).

K11's backward (``csrc/flash_attention_bwd.cu``, no TPU counterpart)
has a plain version, ``ref.flash_attention_bwd``: held against autograd
of the plain forward and ``jax.grad`` of the reference's
``full_attention`` over the mask grid (causal, window, prefix, softcap,
G = 1, 2, 5, 7, Sq ≠ Sk, Dh = 32, 64, 160) within 1e-5·(1 + max|grad|);
a torch mirror of the kernel's tile schedule (its tiles, the skip test,
the online row statistics, the two passes) against it, within the same
bound; and the autograd ``Function``'s plumbing, with the CUDA launches
replaced by their plain versions on the CPU.

The bf16 kernel's arithmetic (bf16 q·k products summed in f32, then
``* scale``; p split into three bf16 pieces, each times bf16 v summed in
f32; the online softmax a key tile at a time) is emulated here in torch
and held to the reference's interpret-mode kernel within the card's bf16
check, 2^-7·|ref| + 1e-6; p rounded to bf16 in one piece fails that check
on outputs that come from cancellation.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_ref
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.models import attention

ATOL = 1e-5

# tests/test_kernels.py's cases, then Sq < Sk (suffix-aligned queries)
CASES = [
    (2, 256, 256, 4, 2, 64, {}),
    (1, 384, 384, 4, 4, 64, dict(causal=True)),
    (1, 256, 256, 8, 2, 128, dict(window=64)),
    (1, 256, 256, 4, 2, 64, dict(window=64, prefix=16)),
    (1, 256, 256, 4, 2, 64, dict(logit_cap=50.0)),
    (2, 200, 200, 4, 2, 48, {}),
    (1, 512, 512, 2, 1, 64, dict(window=128)),
    (1, 128, 128, 4, 2, 64, dict(causal=False)),
    (1, 160, 160, 6, 3, 32, dict(window=32, logit_cap=30.0)),
    (2, 64, 200, 8, 2, 64, dict(window=48, prefix=8)),
]


def _inputs(b, sq, sk, h, kv, dh, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,kw", CASES)
def test_plain_matches_reference(b, sq, sk, h, kv, dh, kw):
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, dh)
    for want in (ref_ref.flash_attention(*map(jnp.asarray, (q, k, v)), **kw),
                 ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= ATOL, err


def test_plain_bf16_matches_reference_kernel():
    q, k, v = _inputs(1, 128, 128, 4, 2, 64)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    want = ref_ops.flash_attention(*(jnp.asarray(t.float().numpy(),
                                                 jnp.bfloat16)
                                     for t in (qt, kt, vt)))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("impl", [None, "full", "chunked", "flash"])
def test_attend_impls_agree(impl):
    """``attend``'s algorithms (None on the CPU: the reference's
    full/chunked rule) agree with the reference's full attention;
    ``chunked`` at small blocks runs several q and k blocks."""
    b, s, h, kv, dh = 2, 96, 4, 2, 32
    q, k, v = _inputs(b, s, s, h, kv, dh, seed=3)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(causal=True, window=40, prefix=4, logit_cap=20.0)
    want = np.asarray(ref_attn.full_attention(
        *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
        k_pos=jnp.asarray(pos), **kw))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    if impl == "chunked":
        got = attention.chunked_attention(*args, q_pos=tpos, k_pos=tpos,
                                          q_block=32, k_block=16, **kw)
        ref_chunked = np.asarray(ref_attn.chunked_attention(
            *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
            k_pos=jnp.asarray(pos), q_block=32, k_block=16, **kw))
        assert np.abs(got.numpy() - ref_chunked).max() <= ATOL
    else:
        got = attention.attend(*args, q_pos=tpos, k_pos=tpos, impl=impl,
                               **kw)
    assert np.abs(got.numpy() - want).max() <= ATOL


def test_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="kernel")


def test_plain_version_is_full_attention_in_f32():
    """The plain version computes in f32 whatever q's dtype, as the
    kernel does, and returns q's dtype."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 32, 32, 2, 1, 32))
    got = ref.flash_attention(q, k, v, window=8)
    pos = torch.arange(32, dtype=torch.int32)
    want = attention.full_attention(q.float(), k.float(), v.float(),
                                    q_pos=pos, k_pos=pos, window=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("which", range(3))
def test_kernel_refuses_operands_that_require_grad(which):
    """K11 has a backward now: under grad mode the ``impl="kernel"``
    dispatch takes q, k or v that requires grad into the autograd
    ``Function`` (``ops.FlashAttention.forward``), whose launch refuses
    the CPU operand for its device, not for want of a backward; so does
    the same call under ``no_grad``.  The raw forward launch, which
    records no graph, still refuses such an operand under grad mode."""
    args = [torch.from_numpy(a).requires_grad_(i == which)
            for i, a in enumerate(_inputs(1, 16, 16, 2, 1, 32))]
    with pytest.raises(ValueError, match="CUDA") as err:
        ops.flash_attention(*args, impl="kernel")
    assert "backward" not in str(err.value)
    assert any(entry.name == "forward" and "ops.py" in str(entry.path)
               for entry in err.traceback)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*args, impl="kernel")
    with pytest.raises(RuntimeError, match="records no graph"):
        flash_attention_cuda(*args)


def test_plain_version_gradients_match_reference():
    """Training takes the plain version: its gradients into q, k and v
    under a window, prefix and softcap equal ``jax.grad`` of the
    reference's oracle within 1e-5·(1 + max|grad|) (measured 1.7e-6 at
    max|grad| 6.5)."""
    q, k, v = _inputs(1, 48, 48, 4, 2, 32, seed=5)
    w = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=20, prefix=4, logit_cap=30.0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, impl="ref", **kw)
    (out * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *a: (ref_ref.flash_attention(*a, **kw) * w).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for leaf, g in zip(leaves, want):
        g = np.asarray(g)
        assert np.abs(leaf.grad.numpy() - g).max() <= 1e-5 * (
            1 + np.abs(g).max())


def _emulate_bf16_kernel(q, k, v, *, causal=True, window=0, prefix=0,
                         logit_cap=0.0, pieces=3, block_k=64):
    """The arithmetic of the bf16 CUDA kernel, in torch on bf16 q/k/v
    (B,Sq,H,Dh)/(B,Sk,KV,Dh) -> (out bf16, Σ_j p_j|v_j| / l f32): scores
    are bf16 products summed in f32, then ``* scale``, softcapped and
    masked to -1e30; a tile of ``block_k`` keys at a time, the running
    max, ``corr = exp(m - m_new)`` and ``l``; p split into ``pieces``
    bf16 pieces, each times bf16 v summed in f32 (smallest piece first)
    into the tile's sum, added to the rescaled output; out / max(l,
    1e-30) rounded once to bf16.  The second output is the size of the
    terms each output sums, to tell cancellation."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, dh)
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(dh)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, kvh, g, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, dh))
    mag = torch.zeros_like(acc)
    for k0 in range(0, sk, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kt) * scale
        if logit_cap:
            s = torch.tanh(s / logit_cap) * logit_cap
        col = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            ok &= col <= qpos
        if window > 0:
            ok &= ((qpos - col) < window) | (col < prefix)
        s = s.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        parts, rest = [], p
        for _ in range(pieces):
            parts.append(rest.to(torch.bfloat16).float())
            rest = rest - parts[-1]
        pv = torch.zeros_like(acc)
        for part in reversed(parts):
            pv = pv + torch.einsum("bkgqs,bskd->bkgqd", part, vt)
        acc = acc * corr[..., None] + pv
        mag = mag * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vt.abs())
        m = m_new
    den = torch.clamp(l, min=1e-30)[..., None]
    fold = lambda t: t.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return fold(acc / den).to(torch.bfloat16), fold(mag / den)


def _bf16_case(b, sq, sk, h, kv, dh, kw, seed=11):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(b, sq, sk, h, kv, dh, seed=seed))
    want = ref_ops.flash_attention(*(jnp.asarray(t.float().numpy(),
                                                 jnp.bfloat16)
                                     for t in (q, k, v)), **kw)
    return (q, k, v), np.asarray(want.astype(jnp.float32))


def _bf16_check(got, want):
    """The card's bf16 check: |got - want| <= 2^-7·|want| + 1e-6."""
    return np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6


EMULATED = [(1, 160, 160, 4, 2, dict(causal=True)),
            (1, 160, 160, 4, 2, dict(causal=True, window=48, prefix=8)),
            (1, 160, 160, 4, 2, dict(causal=True, logit_cap=30.0)),
            (2, 40, 200, 6, 3, dict(causal=True, window=64, prefix=16))]


@pytest.mark.parametrize("dh", [32, 64, 160])
@pytest.mark.parametrize("b,sq,sk,h,kv,kw", EMULATED,
                         ids=["causal", "window+prefix", "softcap", "Sq<Sk"])
def test_kernel_arithmetic_matches_reference(b, sq, sk, h, kv, kw, dh):
    """The bf16 kernel's numerics (three pieces of p, tiles of 64 keys,
    Sk not a multiple of the tile) against the reference's interpret-mode
    kernel on the same bf16 inputs, within the card's bf16 check."""
    args, want = _bf16_case(b, sq, sk, h, kv, dh, kw)
    got, _ = _emulate_bf16_kernel(*args, **kw)
    assert got.dtype == torch.bfloat16
    assert _bf16_check(got.float().numpy(), want).all()


def test_one_piece_p_fails_on_cancellation():
    """Why three pieces: with p rounded to bf16 (8 bits), the same tiles
    miss the check on outputs that cancel (|out| under a tenth of
    Σ p|v| / l), while three pieces pass every output."""
    kw = dict(causal=True)
    args, want = _bf16_case(1, 160, 160, 4, 2, 64, kw)
    three, mag = _emulate_bf16_kernel(*args, **kw)
    one, _ = _emulate_bf16_kernel(*args, pieces=1, **kw)
    assert _bf16_check(three.float().numpy(), want).all()
    miss = ~_bf16_check(one.float().numpy(), want)
    cancelled = np.abs(want) < 0.1 * mag.numpy()
    assert (miss & cancelled).any()


# ------------------------------------------------------- K11's backward

# (b, sq, sk, h, kv, dh, mask): causal, window, prefix, softcap, no causal
# mask, G = 1, 2, 5, 7, Sq < Sk (whisper's cross-attention: Sq ≠ Sk, no
# causal mask), Dh = 32, 64, 160
BWD_CASES = [
    (2, 40, 40, 4, 2, 32, dict(causal=True)),
    (1, 48, 48, 5, 1, 64, dict(causal=True, window=12, prefix=4)),
    (1, 33, 33, 7, 1, 32, dict(causal=True)),
    (2, 24, 24, 2, 2, 64, dict(causal=False)),
    (1, 36, 36, 4, 2, 160, dict(causal=True, window=9, logit_cap=5.0)),
    (2, 7, 50, 4, 4, 32, dict(causal=False)),
    (1, 20, 45, 6, 3, 64, dict(causal=True, window=16, prefix=5)),
    (1, 30, 30, 2, 1, 32, dict(causal=True, logit_cap=2.0)),
]


def _bwd_inputs(b, sq, sk, h, kv, dh, seed=13):
    q, k, v = _inputs(b, sq, sk, h, kv, dh, seed=seed)
    do = np.random.default_rng(seed + 1).normal(
        size=(b, sq, h, dh)).astype(np.float32)
    return q, k, v, do


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= ATOL * (1 + np.abs(want).max())


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,kw", BWD_CASES)
def test_backward_plain_version_matches_autograd_and_jax(b, sq, sk, h, kv,
                                                         dh, kw):
    q, k, v, do = _bwd_inputs(b, sq, sk, h, kv, dh)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ref.flash_attention(*leaves, **kw)
    out.backward(torch.from_numpy(do))
    got = ref.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  out.detach(), torch.from_numpy(do), **kw)
    assert [t.dtype for t in got] == [torch.float32] * 3
    q_pos = jnp.arange(sq, dtype=jnp.int32) + (sk - sq)
    k_pos = jnp.arange(sk, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b_, c: ref_attn.full_attention(
        a, b_, c, q_pos=q_pos, k_pos=k_pos, **kw),
        *map(jnp.asarray, (q, k, v)))
    jax_grads = vjp(jnp.asarray(do))
    for g, leaf, jg in zip(got, leaves, jax_grads):
        _grad_close(g, leaf.grad)
        _grad_close(g, jg)


def test_backward_plain_version_in_bf16_rounds_once():
    """bf16 operands: f32 math, each gradient rounded once to bf16."""
    q, k, v, do = _bwd_inputs(1, 32, 32, 4, 2, 32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    o = ref.flash_attention(*bf[:3], window=10)
    got = ref.flash_attention_bwd(*bf[:3], o, bf[3], window=10)
    want = ref.flash_attention_bwd(*(t.float() for t in bf[:3]), o.float(),
                                   bf[3].float(), window=10)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def _tiles(dh):
    """The backward kernel's (DP, BM, BN) for a head dim
    (``flash_attention_bwd.cu``, ``Tiles``)."""
    dp = next(d for d in (32, 64, 128, 160, 256) if dh <= d)
    return dp, 64 if dp <= 160 else 32, 64 if dp <= 128 else 32


def _skipped(c0, c1, rlo, rhi, sk, causal, window, prefix):
    return (c0 >= sk or (causal and c0 > rhi)
            or (window > 0 and rlo - c1 >= window and c0 >= prefix))


def _mirror_bwd(q, k, v, o, do, *, causal=True, window=0, prefix=0,
                logit_cap=0.0):
    """A float64 torch mirror of ``flash_attention_bwd.cu``'s schedule:
    the dq pass over (batch, head, query tile) with the row statistics
    updated a visited key tile at a time, then dk/dv over (batch, kv head,
    key tile), heads then query tiles; tiles the skip test drops are not
    visited.  Returns (dq, dk, dv)."""
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    _, bm, bn = _tiles(dh)
    scale = dh ** -0.5
    mask = dict(causal=causal, window=window, prefix=prefix)

    def tile(qt, kt, r0, c0):
        """Scores, visibility and softcap slope of a (query, key) tile."""
        s = qt @ kt.T * scale
        slope = torch.ones_like(s)
        if logit_cap:
            t = torch.tanh(s / logit_cap)
            s, slope = t * logit_cap, 1 - t * t
        pos = torch.arange(r0, r0 + qt.shape[0])[:, None] + (sk - sq)
        col = torch.arange(c0, c0 + kt.shape[0])[None, :]
        vis = torch.ones_like(s, dtype=torch.bool) if not causal else \
            col <= pos
        if window:
            vis &= ((pos - col) < window) | (col < prefix)
        return s, vis, slope

    stats = torch.zeros((b, h, sq, 3), dtype=torch.float64)
    dq = torch.zeros_like(q)
    for bi in range(b):
        for hd in range(h):
            kv = hd // g
            for r0 in range(0, sq, bm):
                rlo = sk - sq + r0
                qt, dot = q[bi, r0:r0 + bm, hd], do[bi, r0:r0 + bm, hd]
                d_row = (dot * o[bi, r0:r0 + bm, hd]).sum(-1)
                m = torch.full((qt.shape[0],), -1e30, dtype=torch.float64)
                l = torch.zeros_like(m)
                visits = [c0 for c0 in range(0, sk, bn) if not _skipped(
                    c0, c0 + bn - 1, rlo, rlo + bm - 1, sk, **mask)]
                for c0 in visits:
                    s, vis, _ = tile(qt, k[bi, c0:c0 + bn, kv], r0, c0)
                    s = torch.where(vis, s, -1e30)
                    m_new = torch.maximum(m, s.amax(-1))
                    e = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
                    l = l * torch.exp(m - m_new) + e.sum(-1)
                    m = m_new
                stats[bi, hd, r0:r0 + bm] = torch.stack([m, l, d_row], -1)
                for c0 in visits:
                    kt, vt = k[bi, c0:c0 + bn, kv], v[bi, c0:c0 + bn, kv]
                    s, vis, slope = tile(qt, kt, r0, c0)
                    p = torch.where(vis, torch.exp(s - m[:, None]) /
                                    l[:, None], 0.0)
                    ds = p * (dot @ vt.T - d_row[:, None]) * slope
                    dq[bi, r0:r0 + bm, hd] += ds @ kt * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kv in range(kvh):
            for c0 in range(0, sk, bn):
                kt, vt = k[bi, c0:c0 + bn, kv], v[bi, c0:c0 + bn, kv]
                for hd in range(kv * g, (kv + 1) * g):
                    for r0 in range(0, sq, bm):
                        rlo = sk - sq + r0
                        if _skipped(c0, c0 + bn - 1, rlo, rlo + bm - 1, sk,
                                    **mask):
                            continue
                        qt, dot = q[bi, r0:r0 + bm, hd], do[bi, r0:r0 + bm,
                                                              hd]
                        m, l, d_row = stats[bi, hd, r0:r0 + bm].unbind(-1)
                        s, vis, slope = tile(qt, kt, r0, c0)
                        p = torch.where(vis, torch.exp(s - m[:, None]) /
                                        l[:, None], 0.0)
                        ds = p * (dot @ vt.T - d_row[:, None]) * slope
                        dv[bi, c0:c0 + bn, kv] += p.T @ dot
                        dk[bi, c0:c0 + bn, kv] += ds.T @ qt * scale
    return dq, dk, dv


# the CPU-sized cases plus tiles the schedule cuts: several query and key
# tiles, a window that skips whole tiles, Sq < Sk, a ragged last tile
MIRROR_CASES = BWD_CASES + [
    (1, 200, 200, 2, 1, 32, dict(causal=True, window=50, prefix=8)),
    (1, 70, 300, 2, 2, 64, dict(causal=True, window=90)),
    (1, 130, 130, 4, 1, 160, dict(causal=False, logit_cap=3.0)),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,kw", MIRROR_CASES)
def test_backward_kernel_schedule_mirror(b, sq, sk, h, kv, dh, kw):
    """The kernel's tiles, skip test and two passes compute the plain
    version's gradients: the tiles the skip test drops hold no visible
    pair, and the online statistics over the visited tiles are the row's
    own."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(b, sq, sk, h,
                                                             kv, dh))
    o = ref.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
    got = _mirror_bwd(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        _grad_close(g, w)


def test_autograd_function_runs_the_backward_launch(monkeypatch):
    """``ops.FlashAttention``'s plumbing on the CPU: with the two CUDA
    launches replaced by their plain versions (counted), q, k and v get
    the plain forward's autograd gradients, the forward launch runs once
    and the backward launch once, with the forward's output and the
    mask."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    calls = []

    def fwd(q, k, v, **kw):
        calls.append(("fwd", kw))
        return ref.flash_attention(q, k, v, **kw)

    def bwd(q, k, v, o, do, **kw):
        calls.append(("bwd", kw))
        return ref.flash_attention_bwd(q, k, v, o, do, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_cuda", bwd)
    kw = dict(causal=True, window=10, prefix=2, logit_cap=4.0)
    q, k, v, do = _bwd_inputs(1, 24, 24, 4, 2, 32)
    mine = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa_ops.flash_attention(*mine, impl="kernel", **kw)
    out.backward(torch.from_numpy(do))
    ref.flash_attention(*plain, **kw).backward(torch.from_numpy(do))
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    assert calls[0][1] == calls[1][1] == kw
    for a, p in zip(mine, plain):
        _grad_close(a.grad, p.grad)


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 16, 16, 2, 1,
                                                             32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, q, do)
