"""K12 (the Mamba2 SSD chunked scan): the port's plain version against the
JAX package's oracle (``repro/kernels/ssd_scan/ref.py``, i.e.
``repro.models.ssm.ssd_chunked``) and its Pallas kernel in interpret mode
(``ops.py``), on the same seeded inputs.

Tolerance: y within 1e-5·(1 + max|y|) and the final state within
1e-5·(1 + max|state|) (the reference's own kernel-vs-oracle gap is 9.5e-7
on y at max|y| 23).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against this plain version); here its wrapper
must refuse a CPU tensor, and an operand that requires grad (the kernel
has no backward), while the plain version's gradients match ``jax.grad``
of the reference's oracle within 1e-5·(1 + max|grad|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as ref_ops
from repro.kernels.ssd_scan import ref as ref_ref
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

RTOL = 1e-5


def _inputs(b, s, h, p, n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            np.abs(rng.normal(0.1, 0.05, size=(b, s, h))).astype(np.float32),
            (-np.abs(rng.normal(1, 0.3, size=(h,)))).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


def _check(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= RTOL * (1 + np.abs(want).max()), err


# tests/test_kernels.py's cases, then a chunk shorter than the default
# (``_mamba_core`` passes min(chunk, S): a 37-token prompt runs L = 37)
CASES = [(2, 256, 4, 64, 128, 128), (1, 128, 2, 32, 64, 32),
         (2, 100, 3, 16, 16, 32), (1, 512, 8, 64, 128, 128),
         (1, 64, 1, 8, 8, 16), (2, 37, 4, 32, 16, 37)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
def test_plain_matches_reference(b, s, h, p, n, chunk):
    args = _inputs(b, s, h, p, n)
    y, fs = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert y.shape == (b, s, h, p) and fs.shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    for want_y, want_fs in (ref_ref.ssd_scan(*jargs, chunk),
                            ref_ops.ssd_scan(*jargs, chunk=chunk)):
        _check(y, want_y)
        _check(fs, want_fs)


def test_state_continuity():
    """The final state of a scan over [first half] carried through the
    second half one token at a time (the decode recurrence) equals the
    full scan's, and so do the second half's outputs; the full scan's
    state also matches the reference's (tests/test_kernels.py:95)."""
    b, s, h, p, n, chunk = 1, 128, 2, 16, 32, 32
    x, dt, A, B, C = map(torch.from_numpy, _inputs(b, s, h, p, n))
    y_full, f_full = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    half = s // 2
    _, state = ops.ssd_scan(x[:, :half], dt[:, :half], A, B[:, :half],
                            C[:, :half], chunk=chunk)
    ys = []
    for t in range(half, s):
        da = torch.exp(dt[:, t] * A)                            # (B,H)
        state = (state * da[..., None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * B[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    _check(torch.stack(ys, 1), y_full[:, half:].numpy())
    _check(state, f_full.numpy())
    want = ref_ops.ssd_scan(*(jnp.asarray(a.numpy())
                              for a in (x, dt, A, B, C)), chunk=chunk)[1]
    _check(f_full, want)


def test_kernel_refuses_cpu_tensors():
    args = list(map(torch.from_numpy, _inputs(1, 16, 2, 8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(*args, chunk=16, impl="kernel")


@pytest.mark.parametrize("which", range(5))
def test_kernel_refuses_operands_that_require_grad(which):
    """The CUDA kernel has no backward: under grad mode the
    ``impl="kernel"`` dispatch refuses any of x, dt, A, B, C that
    requires grad before it looks at the device; under ``no_grad`` the
    same call passes that check (and is then refused for its CPU
    tensors)."""
    args = [torch.from_numpy(a).requires_grad_(i == which)
            for i, a in enumerate(_inputs(1, 32, 2, 8, 8))]
    for call in (lambda: ops.ssd_scan(*args, chunk=16, impl="kernel"),
                 lambda: ssd_scan_cuda(*args, chunk=16)):
        with pytest.raises(RuntimeError,
                           match=r"no backward.*impl='ref'"):
            call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(*args, chunk=16, impl="kernel")


def test_plain_version_gradients_match_reference():
    """Training takes the plain version: its gradients into x, dt, A, B
    and C through y and the final state equal ``jax.grad`` of the
    reference's oracle within 1e-5·(1 + max|grad|) (measured 2.3e-5 at
    max|grad| 88)."""
    args = _inputs(2, 40, 3, 8, 16, seed=5)
    rng = np.random.default_rng(6)
    wy = rng.normal(size=args[0].shape).astype(np.float32)
    ws = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = ops.ssd_scan(*leaves, chunk=16, impl="ref")
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()

    def loss(*a):
        y, st = ref_ref.ssd_scan(*a, 16)
        return (y * wy).sum() + (st * ws).sum()

    want = jax.grad(loss, argnums=range(5))(*map(jnp.asarray, args))
    for leaf, g in zip(leaves, want):
        g = np.asarray(g)
        assert np.abs(leaf.grad.numpy() - g).max() <= 1e-5 * (
            1 + np.abs(g).max())
