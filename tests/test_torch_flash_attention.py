"""K11 (flash attention): the port's plain version against the JAX
package's oracle (``repro/kernels/flash_attention/ref.py``) and its Pallas
kernel in interpret mode (``ops.py``), on the same seeded inputs.

Tolerance: <= 1e-5 abs in f32 (the reference's own kernel-vs-oracle gap is
7.2e-7 at these shapes); in bf16 the port and the reference's kernel both
compute in f32 and round once, so they agree within one bf16 ulp
(2^-7·|out|).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against this plain version); here its wrapper
must refuse a CPU tensor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_ref
from repro.models import attention as ref_attn
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
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
