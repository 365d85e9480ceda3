"""Mamba2 / SSD (state-space duality) block: the chunked-parallel scan and
the O(1)-state decode step (the port of ``repro/models/ssm.py``)
[arXiv:2405.21060].

The scan's SSD block decomposition:
  intra-chunk (quadratic within chunk L): Y_diag = (C Bᵀ ∘ decay) · (dt x)
  chunk states:  S_c = Σ_j exp(cumA_end - cumA_j) dt_j B_j ⊗ x_j
  inter-chunk:   S'_c = exp(sumA_c) S'_{c-1} + S_c, in chunk order
  output:        Y = Y_diag + C · S'_{prev} ∘ exp(cumA) + D x

``ssd_chunked`` is that decomposition in plain PyTorch, the plain
version of K12; ``_mamba_core`` runs the scan through K12's op
(``kernels/ssd_scan``): the kernel on a CUDA tensor, ``ssd_chunked`` on
the CPU, or as ``impl`` says.  The reference's model calls
``ssd_chunked`` itself and reaches its Pallas kernel only through the
kernel's own op; both compute the same function.  K12 has no backward,
so the training path passes ``impl="ref"`` here (``train/steps``), as
the reference's train path runs its jnp ``ssd_chunked``.  The
reference's ``REPRO_SSD_CHUNK`` environment override of the chunk is
not ported: the chunk is ``min(ssm.chunk, S)``.

Under a mesh whose layout keeps the mixer's ``model`` shards
(``sharding.LMLayout``: a rank's block of d_inner is whole SSM heads)
the mixer runs on the rank's heads (``_mamba_core``): Megatron's pair
around it, one extra collective for the gated norm's sum of squares.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm, silu

__all__ = ["dims", "init_mamba", "ssd_chunked", "mamba_forward",
           "mamba_forward_with_state", "init_mamba_cache",
           "mamba_decode_step"]


def dims(d_model: int, ssm: SSMConfig) -> Tuple[int, int]:
    d_inner = ssm.expand * d_model
    return d_inner, d_inner // ssm.head_dim


def init_mamba(gen: torch.Generator, d_model: int, ssm: SSMConfig, dtype):
    di, nh = dims(d_model, ssm)
    n = ssm.state_dim
    dev = gen.device
    return {
        "wz": dense_init(gen, d_model, di, dtype),
        "wx": dense_init(gen, d_model, di, dtype),
        "wB": dense_init(gen, d_model, n, dtype),
        "wC": dense_init(gen, d_model, n, dtype),
        "wdt": dense_init(gen, d_model, nh, dtype),
        "conv_x": (torch.randn((ssm.conv_dim, di), generator=gen, device=dev)
                   * (1.0 / ssm.conv_dim)).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), device=dev),
        "dt_bias": torch.zeros((nh,), device=dev),
        "gate_norm": init_rmsnorm(di, device=dev),
        "out_proj": dense_init(gen, di, d_model, dtype),
    }


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. x: (B,S,C), w: (W,C)."""
    wdt = w.to(x.dtype)
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * wdt[i]
    return out


def _segsum_decay(cum: torch.Tensor) -> torch.Tensor:
    """cum: (B,nc,L,H) -> decay (B,nc,L,L,H) = exp(cum_i - cum_j) for
    i >= j, else 0 (selected before the exp)."""
    diff = cum[..., :, None, :] - cum[..., None, :, :]     # (B,nc,L,L,H)
    l = cum.shape[2]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=cum.device))
    diff = diff.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    return torch.exp(diff)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked-parallel scan.

    x: (B,S,H,P) f32, dt: (B,S,H) f32 (already softplus'ed),
    A: (H,) negative, B/C: (B,S,N).
    Returns y: (B,S,H,P), final_state: (B,H,P,N).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    s_orig = s
    if s % chunk:
        # pad to a chunk multiple; dt=0 rows are exact no-ops for the scan
        # (decay exp(0)=1, state/output contributions scale with dt).
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s += pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * A                                      # (B,nc,L,H)
    cum = torch.cumsum(dA, dim=2)                     # (B,nc,L,H)
    xdt = xc * dtc[..., None]                         # (B,nc,L,H,P)

    # --- intra-chunk (quadratic in L)
    cb = Cc @ Bc.transpose(-1, -2)                    # (B,nc,L,L)
    w = cb[..., None] * _segsum_decay(cum)            # (B,nc,L,L,H)
    y_diag = (w.permute(0, 1, 4, 2, 3)                # (B,nc,H,L,L)
              @ xdt.permute(0, 1, 3, 2, 4))           # (B,nc,H,L,P)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)            # (B,nc,L,H,P)

    # --- chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,L,H)
    xw = (decay_to_end[..., None] * xdt).permute(0, 1, 3, 4, 2)  # (B,nc,H,P,L)
    states = xw @ Bc[:, :, None]                                 # (B,nc,H,P,N)

    # --- inter-chunk scan, in chunk order
    chunk_decay = torch.exp(dA.sum(dim=2))                       # (B,nc,H)
    prev = []
    run = torch.zeros_like(states[:, 0])
    for c in range(nc):
        prev.append(run)
        run = run * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                              # (B,nc,H,P,N)

    # --- inter-chunk contribution
    y_inter = Cc[:, :, None] @ prev.transpose(-1, -2)            # (B,nc,H,L,P)
    y_inter = (y_inter.permute(0, 1, 3, 2, 4)
               * torch.exp(cum)[..., None])                      # (B,nc,L,H,P)

    y = (y_diag + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y, run


def _local_heads(params, ssm: SSMConfig, axis):
    """A tensor-parallel rank's mixer params: ``params`` holds its block
    of d_inner (``wz``/``wx`` columns, ``conv_x`` channels, ``out_proj``
    rows, ``gate_norm``), whole SSM heads.  Returns the params its heads
    read: ``wB``/``wC`` whole, ``wdt``'s columns and ``A_log``/``D``/
    ``dt_bias`` of its heads, each through ``copy_to_model`` (one
    collective for all of them in the backward), since every rank uses
    such a replicated param in part."""
    nhl = params["wz"].shape[-1] // ssm.head_dim
    h0 = axis.rank * nhl
    rep = sharding.copy_params_to_model(
        {k: params[k] for k in ("wB", "wC", "wdt", "A_log", "D", "dt_bias")},
        axis)
    out = dict(params, wB=rep["wB"], wC=rep["wC"],
               wdt=rep["wdt"][:, h0:h0 + nhl])
    for k in ("A_log", "D", "dt_bias"):
        out[k] = rep[k][h0:h0 + nhl]
    return out


def _mamba_core(params, x_in: torch.Tensor, ssm: SSMConfig,
                impl: Optional[str] = None):
    """The mixer; under tensor parallelism (``params`` holds the rank's
    block of d_inner, ``LMLayout``) on the rank's SSM heads: x_in through
    ``copy_to_model``, the conv on its channels, the scan on its heads,
    the gated norm over the whole d_inner (``rmsnorm`` over ``model``),
    ``out_proj`` row-parallel and summed over ``model``."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    di_whole, _ = dims(x_in.shape[-1], ssm)
    tp = sharding.tp_axis(params["wz"].shape[-1], di_whole)
    if tp is not None:
        x_in = sharding.copy_to_model(x_in, tp)
        params = _local_heads(params, ssm, tp)
    di = params["wz"].shape[-1]
    nh = di // ssm.head_dim
    dt_raw = x_in @ params["wdt"].to(x_in.dtype)
    z = x_in @ params["wz"].to(x_in.dtype)
    xr_raw = x_in @ params["wx"].to(x_in.dtype)
    Bm = x_in @ params["wB"].to(x_in.dtype)
    Cm = x_in @ params["wC"].to(x_in.dtype)

    xr = silu(_depthwise_conv(xr_raw, params["conv_x"]))
    b, s, _ = xr.shape
    xh = xr.reshape(b, s, nh, ssm.head_dim).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_ops.ssd_scan(xh, dt, A, Bm.float(), Cm.float(),
                                      chunk=min(ssm.chunk, s), impl=impl)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(b, s, di).to(x_in.dtype)
    y = rmsnorm(params["gate_norm"], y * silu(z), axis=tp)
    out = sharding.reduce_sum(y @ params["out_proj"].to(x_in.dtype), tp)
    return out, final_state, xr_raw


def mamba_forward(params, x_in: torch.Tensor, ssm: SSMConfig,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Full Mamba2 mixer on (B,S,D). Returns (B,S,D)."""
    out, _, _ = _mamba_core(params, x_in, ssm, impl)
    return out


def mamba_forward_with_state(params, x_in: torch.Tensor, ssm: SSMConfig,
                             impl: Optional[str] = None):
    """Prefill variant: returns (out, final_ssm_state, conv_tail).

    conv_tail is the last (conv_dim-1) *pre-conv* channel inputs, i.e. the
    conv ring state expected by mamba_decode_step.
    """
    out, final_state, xr_raw = _mamba_core(params, x_in, ssm, impl)
    w = ssm.conv_dim
    tail = xr_raw[:, -(w - 1):]
    pad = (w - 1) - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return out, final_state, tail


# ------------------------------------------------------------------- decode

def init_mamba_cache(batch: int, d_model: int, ssm: SSMConfig, dtype,
                     device=None):
    di, nh = dims(d_model, ssm)
    return {"state": torch.zeros((batch, nh, ssm.head_dim, ssm.state_dim),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, ssm.conv_dim - 1, di), dtype=dtype,
                                device=device)}


def mamba_decode_step(params, x_in: torch.Tensor, cache, ssm: SSMConfig):
    """x_in: (B,1,D) -> (B,1,D), updated cache. O(1) per token."""
    d_model = x_in.shape[-1]
    di, nh = dims(d_model, ssm)
    x1 = x_in[:, 0]                                   # (B,D)
    z = x1 @ params["wz"].to(x1.dtype)
    xr = x1 @ params["wx"].to(x1.dtype)
    Bm = (x1 @ params["wB"].to(x1.dtype)).float()
    Cm = (x1 @ params["wC"].to(x1.dtype)).float()
    dt_raw = x1 @ params["wdt"].to(x1.dtype)

    # causal depthwise conv via the conv-state ring
    conv_hist = torch.cat([cache["conv"], xr[:, None]], dim=1)
    w = params["conv_x"].to(xr.dtype)                 # (W, di)
    xr = silu(torch.einsum("bwc,wc->bc", conv_hist, w))
    new_conv = conv_hist[:, 1:]

    xh = xr.reshape(-1, nh, ssm.head_dim).float()     # (B,H,P)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    da = torch.exp(dt * A)                            # (B,H)
    state = cache["state"] * da[..., None, None]
    state = state + (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(-1, di).to(x_in.dtype)
    y = rmsnorm(params["gate_norm"], y * silu(z))
    out = (y @ params["out_proj"].to(x_in.dtype))[:, None]
    return out, {"state": state, "conv": new_conv}
