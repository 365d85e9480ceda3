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
a float64 torch mirror of the kernel's tile schedule (its tiles, the
skip tests of CTAs and warps, p from the forward's LSE, D, heads before
query tiles in dk/dv) against it, within the same bound; and the
autograd ``Function``'s plumbing (the forward's LSE saved and handed to
the backward launch), with the CUDA launches replaced by their plain
versions on the CPU.  The plain forward's ``return_lse`` is held to
``jax.nn.logsumexp`` of the reference's masked scores.

The bf16 kernel's arithmetic (bf16 q·k products summed in f32, then
``* scale``; p split into three bf16 pieces, each times bf16 v summed in
f32; the online softmax a key tile at a time) is emulated here in torch
and held to the reference's interpret-mode kernel within the card's bf16
check, 2^-7·|ref| + 1e-6; p rounded to bf16 in one piece fails that check
on outputs that come from cancellation.  So is the bf16 backward's (bf16
products summed in f32 a tile at a time; p = exp(s - lse) with the
emulated forward's LSE; p and ds in three bf16 pieces, smallest first),
held to ``jax.grad`` of the reference's ``full_attention`` in f32 on the
same bf16 values within the card's backward check, 2^-7·|want| +
1e-4·max|want|; with ds and p in one piece it misses that check.
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
    BWD_CTAS, bwd_heads_a_cta, bwd_tiles, flash_attention_bwd_cuda,
    flash_attention_cuda)
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


def _reference_lse(q, k, sq, sk, kw):
    """``jax.nn.logsumexp`` of the reference's masked f32 scores, (B,H,Sq)."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    scores = ref_attn._gqa_scores(
        jnp.asarray(q).reshape(b, sq, kvh, h // kvh, dh), jnp.asarray(k),
        dh ** -0.5, kw.get("logit_cap", 0.0))
    mask = ref_attn._mask(jnp.arange(sq, dtype=jnp.int32) + (sk - sq),
                          jnp.arange(sk, dtype=jnp.int32),
                          causal=kw.get("causal", True),
                          window=kw.get("window", 0),
                          prefix=kw.get("prefix", 0))
    scores = jnp.where(mask[None, None, None], scores, ref_attn.NEG_INF)
    return np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, sq)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,kw", CASES)
def test_plain_lse_matches_reference(b, sq, sk, h, kv, dh, kw):
    """The plain forward's ``return_lse``: the output bitwise as without
    it, and the (B,H,Sq) f32 row log-sum-exp within 1e-5·(1 + max|lse|)
    of ``jax.nn.logsumexp`` over the reference's masked scores."""
    q, k, v = _inputs(b, sq, sk, h, kv, dh)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = ref.flash_attention(*args, return_lse=True, **kw)
    assert torch.equal(out, ref.flash_attention(*args, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    want = _reference_lse(q, k, sq, sk, kw)
    assert np.abs(lse.numpy() - want).max() <= ATOL * (1 + np.abs(want).max())


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
                         logit_cap=0.0, pieces=3, block_k=64,
                         return_lse=False):
    """The arithmetic of the bf16 CUDA kernel, in torch on bf16 q/k/v
    (B,Sq,H,Dh)/(B,Sk,KV,Dh) -> (out bf16, Σ_j p_j|v_j| / l f32): scores
    are bf16 products summed in f32, then ``* scale``, softcapped and
    masked to -1e30; a tile of ``block_k`` keys at a time, the running
    max, ``corr = exp(m - m_new)`` and ``l``; p split into ``pieces``
    bf16 pieces, each times bf16 v summed in f32 (smallest piece first)
    into the tile's sum, added to the rescaled output; out / max(l,
    1e-30) rounded once to bf16.  The second output is the size of the
    terms each output sums, to tell cancellation; with ``return_lse`` a
    third, the row log-sum-exp m + log(max(l, 1e-30)) (B,H,Sq) that the
    kernel writes for its backward."""
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
    out = fold(acc / den).to(torch.bfloat16), fold(mag / den)
    if return_lse:
        return out + ((m + torch.log(den[..., 0])).reshape(b, h, sq),)
    return out


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


def _visible(rows, cols, sq, sk, *, causal=True, window=0, prefix=0):
    """The kernels' visibility of query rows ``rows`` against keys ``cols``
    (index vectors), positions suffix-aligned: (len(rows), len(cols))."""
    pos = rows[:, None] + (sk - sq)
    col = cols[None, :]
    ok = col < sk
    if causal:
        ok = ok & (col <= pos)
    if window > 0:
        ok = ok & (((pos - col) < window) | (col < prefix))
    return ok


def _pieces(x, n):
    """f32 ``x`` as ``n`` bf16 pieces (as f32), largest first."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16).float())
        rest = rest - parts[-1]
    return parts


def _emulate_bf16_bwd(q, k, v, o, do, lse, *, causal=True, window=0,
                      prefix=0, logit_cap=0.0, pieces=3):
    """The arithmetic of the bf16 backward kernel, in torch on bf16
    q/k/v/o/do and the forward's f32 LSE (B,H,Sq): scores and dp are bf16
    products summed in f32, s then ``* scale``, softcapped and masked to
    -1e30; p = exp(s - lse), D = rowsum(do·o) in f32, ds = p∘(dp -
    D)·slope; dq summed a key tile of ``bwd_tiles(dh).bk`` at a time, dk
    and dv a query tile of ``.bm`` rows at a time, each tile's products
    with p or ds in ``pieces`` bf16 pieces (smallest first) summed in f32;
    dq and dk ``* scale`` after the sums; each rounded once to bf16."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tiles = bwd_tiles(dh)
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, sq, kvh, g, dh)
    dof = do.float().reshape(b, sq, kvh, g, dh)
    kf, vf = k.float(), v.float()
    lse = lse.reshape(b, kvh, g, sq)
    d_row = (do.float() * o.float()).sum(-1).reshape(b, sq, kvh, g).permute(
        0, 2, 3, 1)
    mask = dict(causal=causal, window=window, prefix=prefix)

    def p_ds(rows, cols):
        qt, dot = qf[:, rows], dof[:, rows]
        s = torch.einsum("bqkgd,bskd->bkgqs", qt, kf[:, cols]) * scale
        slope = 1.0
        if logit_cap:
            t = torch.tanh(s / logit_cap)
            s, slope = t * logit_cap, 1 - t * t
        s = s.masked_fill(~_visible(rows, cols, sq, sk, **mask), -1e30)
        p = torch.exp(s - lse[..., rows, None])
        dp = torch.einsum("bqkgd,bskd->bkgqs", dot, vf[:, cols])
        return p, p * (dp - d_row[..., rows, None]) * slope

    def summed(x, eq, other):
        acc = 0
        for part in reversed(_pieces(x, pieces)):
            acc = acc + torch.einsum(eq, part, other)
        return acc

    rows_all, cols_all = torch.arange(sq), torch.arange(sk)
    dq = torch.zeros_like(qf)
    for c0 in range(0, sk, tiles.bk):
        cols = torch.arange(c0, min(c0 + tiles.bk, sk))
        _, ds = p_ds(rows_all, cols)
        dq = dq + summed(ds, "bkgqs,bskd->bqkgd", kf[:, cols])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, sq, tiles.bm):
        rows = torch.arange(r0, min(r0 + tiles.bm, sq))
        p, ds = p_ds(rows, cols_all)
        dv = dv + summed(p, "bkgqs,bqkgd->bskd", dof[:, rows])
        dk = dk + summed(ds, "bkgqs,bqkgd->bskd", qf[:, rows])
    return ((dq * scale).reshape(b, sq, h, dh).to(torch.bfloat16),
            (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16))


def _bf16_bwd_case(b, sq, sk, h, kv, dh, kw, seed=17):
    """bf16 q/k/v/do, the reference's f32 output o and the emulated
    forward's LSE; ``jax.grad`` of the reference's ``full_attention`` in
    f32 at the same (bf16) values; and the emulated forward's bf16
    output.  ``jax.grad``'s D is rowsum(do·o) at the f32 o (it never
    rounds o), so the emulation is held to it with that o; the kernel
    itself reads the bf16 o the forward stored, and the card's check
    gives its plain version the same one."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _bwd_inputs(b, sq, sk, h, kv, dh, seed=seed))
    o16, _, lse = _emulate_bf16_kernel(q, k, v, return_lse=True, **kw)
    q_pos = jnp.arange(sq, dtype=jnp.int32) + (sk - sq)
    k_pos = jnp.arange(sk, dtype=jnp.int32)
    o, vjp = jax.vjp(lambda a, b_, c: ref_attn.full_attention(
        a, b_, c, q_pos=q_pos, k_pos=k_pos, **kw),
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]
    o = torch.from_numpy(np.array(o))
    return (q, k, v, o, do, lse), want, o16


def _bwd_check(got, want):
    """The card's bf16 backward check: |got - want| <= 2^-7·|want| +
    1e-4·max|want|, per gradient."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return np.abs(got - want) <= (2.0 ** -7 * np.abs(want)
                                  + 1e-4 * np.abs(want).max())


EMULATED_BWD = [(2, 100, 100, 4, 2, dict(causal=True)),
                (1, 96, 96, 5, 1, dict(causal=True, window=24, prefix=6)),
                (1, 80, 80, 4, 2, dict(causal=True, logit_cap=5.0)),
                (2, 40, 130, 6, 3, dict(causal=True, window=48, prefix=8)),
                (1, 30, 90, 4, 4, dict(causal=False))]


@pytest.mark.parametrize("dh", [32, 64, 160])
@pytest.mark.parametrize("b,sq,sk,h,kv,kw", EMULATED_BWD,
                         ids=["causal", "window+prefix", "softcap", "Sq<Sk",
                              "non-causal"])
def test_backward_kernel_arithmetic_matches_reference(b, sq, sk, h, kv, kw,
                                                      dh):
    """The bf16 backward's numerics (the forward's LSE, three pieces of p
    and ds, its tiles) against ``jax.grad`` of the reference on the same
    bf16 values, within the card's bf16 backward check; and, as the card
    compares them, against the plain backward with both given the
    forward's bf16 output."""
    (q, k, v, o, do, lse), want, o16 = _bf16_bwd_case(b, sq, sk, h, kv, dh,
                                                      kw)
    got = _emulate_bf16_bwd(q, k, v, o, do, lse, **kw)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape
        assert _bwd_check(x, w).all()
    got = _emulate_bf16_bwd(q, k, v, o16, do, lse, **kw)
    plain = ref.flash_attention_bwd(q, k, v, o16, do, **kw)
    for x, w in zip(got, plain):
        assert _bwd_check(x, w.float().numpy()).all()


def test_one_piece_p_and_ds_fail_the_backward_check():
    """Why three pieces: with p and ds rounded to bf16 (8 bits, as SDPA's
    backward does), the same tiles miss the backward check on some
    gradient, while three pieces pass every one."""
    kw = dict(causal=True)
    args, want, _ = _bf16_bwd_case(2, 100, 100, 4, 2, 64, kw)
    three = _emulate_bf16_bwd(*args, **kw)
    one = _emulate_bf16_bwd(*args, pieces=1, **kw)
    assert all(_bwd_check(x, w).all() for x, w in zip(three, want))
    assert not all(_bwd_check(x, w).all() for x, w in zip(one, want))


@pytest.mark.parametrize("dh", [32, 36, 64, 128, 160, 256])
def test_backward_tiles(dh):
    """``bwd_tiles`` (the bf16 backward's ``BwdShape``): Dh padded to a
    multiple of 16, both kernels' shared memory within the 227 KB a CTA
    may take, 16 keys a warp, a warp's head dims in whole ldmatrix pairs,
    13 passes up to Dh 128 and 15 where two warps share 16 keys."""
    t = bwd_tiles(dh)
    assert dh <= t.dp and t.dp % 16 == 0
    ld = t.dp + 8
    assert (2 * 64 + 4 * t.bk) * ld * 2 + 2 * 64 * 4 <= 232_448
    assert (2 * t.bn + 4 * t.bm) * ld * 2 + 4 * t.bm * 4 <= 232_448
    assert t.bn * t.dsplit == 64 and (t.dp // t.dsplit) % 16 == 0
    assert t.bm % 16 == 0 and t.bk % 16 == 0
    assert t.passes == (13 if t.dp <= 128 else 15)


@pytest.mark.parametrize("b,sk,kvh,g,dh,want", [
    (2, 2048, 4, 8, 64, 2),      # tinyllama's train step: 4 chunks
    (2, 2304, 2, 7, 64, 1),      # internvl2: every head a chunk
    (2, 2048, 16, 1, 128, 1),    # olmoe: G = 1
    (2, 2048, 8, 2, 256, 2),     # gemma2: 32-key CTAs, 1,024 already
    (8, 4096, 8, 4, 64, 4)])     # enough CTAs without a split
def test_backward_head_split(b, sk, kvh, g, dh, want):
    """``bwd_heads_a_cta``: the heads of a kv head split over dk/dv CTAs
    only until there are about ``BWD_CTAS`` of them."""
    hs = bwd_heads_a_cta(b, sk, kvh, g, dh)
    assert hs == want
    units = -(-sk // bwd_tiles(dh).bn) * kvh * b
    chunks = -(-g // hs)
    assert chunks == 1 or units * (chunks - 1) < BWD_CTAS


def _skipped(c0, c1, rlo, rhi, sk, causal, window, prefix):
    return (c0 >= sk or (causal and c0 > rhi)
            or (window > 0 and rlo - c1 >= window and c0 >= prefix))


def _mirror_bwd(q, k, v, o, do, lse, *, causal=True, window=0, prefix=0,
                logit_cap=0.0):
    """A float64 torch mirror of ``flash_attention_bwd.cu``'s bf16
    schedule (``bwd_tiles``): dq CTAs over (batch, kv head, chunk of GC =
    min(G, 64) heads, block of 64 / GC query rows), their 64 (row, head)
    pairs r·GC + gi in warps of 16, each warp visiting the key tiles of
    ``bk`` that the CTA's skip test and its own rows' test keep; dk/dv
    CTAs over (batch, kv head, chunk of ``bwd_heads_a_cta`` heads, ``bn``
    keys), warps of 16 keys, heads then query tiles of ``bm`` rows, the
    same two tests, the chunks' sums added in order; p = exp(s - lse) from
    the forward's LSE, D = rowsum(do·o).  Returns (dq, dk, dv)."""
    q, k, v, o, do, lse = (t.double() for t in (q, k, v, o, do, lse))
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tl = bwd_tiles(dh)
    scale = dh ** -0.5
    mask = dict(causal=causal, window=window, prefix=prefix)
    off = sk - sq
    d_row = (do * o).sum(-1)                              # (B,Sq,H)

    def p_ds(bi, rows, heads, keys, kv):
        """p and ds of (row, head) pairs against keys, and the operands."""
        qt, dot = q[bi, rows, heads], do[bi, rows, heads]
        kt, vt = k[bi, keys, kv], v[bi, keys, kv]
        s = qt @ kt.T * scale
        slope = torch.ones_like(s)
        if logit_cap:
            t = torch.tanh(s / logit_cap)
            s, slope = t * logit_cap, 1 - t * t
        s = torch.where(_visible(rows, keys, sq, sk, **mask), s, -1e30)
        p = torch.exp(s - lse[bi, heads, rows][:, None])
        ds = p * (dot @ vt.T - d_row[bi, rows, heads][:, None]) * slope
        return p, ds, qt, dot, kt

    gc = min(g, 64)
    bq = 64 // gc
    dq = torch.zeros_like(q)
    for bi in range(b):
        for kv in range(kvh):
            for h0 in range(0, g, gc):
                gcn = min(gc, g - h0)
                for q0 in range(0, sq, bq):
                    nrows = min(bq, sq - q0)
                    visits = [c0 for c0 in range(0, sk, tl.bk)
                              if not _skipped(c0, c0 + tl.bk - 1, off + q0,
                                              off + q0 + nrows - 1, sk,
                                              **mask)]
                    for w in range(4):
                        ms = [m for m in range(16 * w, 16 * w + 16)
                              if m // gc < nrows and m % gc < gcn]
                        if not ms:
                            continue
                        rows = torch.tensor([q0 + m // gc for m in ms])
                        heads = torch.tensor([kv * g + h0 + m % gc
                                              for m in ms])
                        wlo = off + q0 + (16 * w) // gc
                        whi = off + q0 + min((16 * w + 15) // gc, nrows - 1)
                        for c0 in visits:
                            if _skipped(c0, c0 + tl.bk - 1, wlo, whi, sk,
                                        **mask):
                                continue
                            keys = torch.arange(c0, min(c0 + tl.bk, sk))
                            _, ds, _, _, kt = p_ds(bi, rows, heads, keys, kv)
                            dq[bi, rows, heads] += ds @ kt
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    hs = bwd_heads_a_cta(b, sk, kvh, g, dh)
    for bi, kv, gh0 in ((bi, kv, gh0) for bi in range(b)
                        for kv in range(kvh) for gh0 in range(0, g, hs)):
        chunk_k, chunk_v = torch.zeros_like(k), torch.zeros_like(v)
        for c0 in range(0, sk, tl.bn):
            for wc0 in range(c0, min(c0 + tl.bn, sk), 16):
                keys = torch.arange(wc0, min(wc0 + 16, sk))
                for hd in range(kv * g + gh0,
                                kv * g + min(gh0 + hs, g)):
                    for r0 in range(0, sq, tl.bm):
                        rlo = off + r0
                        rhi = off + min(r0 + tl.bm, sq) - 1
                        if (_skipped(c0, c0 + tl.bn - 1, rlo, rhi, sk,
                                     **mask)
                                or _skipped(wc0, wc0 + 15, rlo, rhi, sk,
                                            **mask)):
                            continue
                        rows = torch.arange(r0, min(r0 + tl.bm, sq))
                        heads = torch.full_like(rows, hd)
                        p, ds, qt, dot, _ = p_ds(bi, rows, heads, keys,
                                                 kv)
                        chunk_v[bi, keys, kv] += p.T @ dot
                        chunk_k[bi, keys, kv] += ds.T @ qt
        dk, dv = dk + chunk_k, dv + chunk_v
    return dq * scale, dk * scale, dv


# the CPU-sized cases plus tiles the schedule cuts: several query and key
# tiles, a window that skips whole tiles, Sq < Sk, a ragged last tile
MIRROR_CASES = BWD_CASES + [
    (1, 200, 200, 2, 1, 32, dict(causal=True, window=50, prefix=8)),
    (1, 70, 300, 2, 2, 64, dict(causal=True, window=90)),
    (1, 130, 130, 4, 1, 160, dict(causal=False, logit_cap=3.0)),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,kw", MIRROR_CASES)
def test_backward_kernel_schedule_mirror(b, sq, sk, h, kv, dh, kw):
    """The kernel's tiles, skip tests and statistics compute the plain
    version's gradients: the tiles the CTA's and the warps' tests drop
    hold no visible pair, and p from the forward's LSE (the plain
    ``return_lse``) with D = rowsum(do·o) is the row's softmax."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(b, sq, sk, h,
                                                             kv, dh))
    o, lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
    got = _mirror_bwd(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        _grad_close(g, w)


def test_autograd_function_runs_the_backward_launch(monkeypatch):
    """``ops.FlashAttention``'s plumbing on the CPU: with the two CUDA
    launches replaced by their plain versions (counted), q, k and v get
    the plain forward's autograd gradients, the forward launch runs once,
    asked for the LSE, and the backward launch once, with the forward's
    output, its LSE (the same tensor) and the mask."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    calls, lses = [], []

    def fwd(q, k, v, *, return_lse=False, **kw):
        calls.append(("fwd", kw))
        assert return_lse
        out, lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
        lses.append(lse)
        return out, lse

    def bwd(q, k, v, o, do, lse, **kw):
        calls.append(("bwd", kw))
        lses.append(lse)
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
    assert len(lses) == 2 and lses[0].shape == (1, 4, 24)
    assert lses[1].data_ptr() == lses[0].data_ptr()
    assert torch.equal(lses[1], lses[0])
    for a, p in zip(mine, plain):
        _grad_close(a.grad, p.grad)


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 16, 16, 2, 1,
                                                             32))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, q, do, lse)
