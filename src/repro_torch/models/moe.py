"""Token-choice top-k MoE with capacity-bounded per-expert gather dispatch
(the port of ``repro/models/moe.py``).

Every token picks its top-k experts by router probability; every expert
then takes its top-C tokens by gate (C = ``capacity``), runs its SwiGLU
FFN on them, batched over the expert axis, and the gate-weighted outputs
are summed back per token.  Tokens beyond an expert's capacity are
dropped.  The port takes the reference's single-device path always:
``moe_forward_ep`` (expert parallelism) waits for the multi-GPU slice
(ROADMAP.md queue 6); ``dispatch_cumsum``/``combine_cumsum``, the
dispatch that path uses, are ported as functions of their own.

Order, so that the port chooses what the reference chooses and runs
deterministically on the card:

- both top-k's (k experts a token, C tokens an expert) run on unique
  int64 keys, the order-preserving f32 bits shifted left 32 OR the
  reversed index, so the larger value and then the lower index wins, as
  with ``lax.top_k`` (CUDA's ``topk`` promises no order among equal
  values, and most gates are exactly 0);
- the combine is a fixed-order sum, not a scatter-add with float
  atomics: each token adds its selected experts' gate-weighted outputs
  one expert at a time, in ascending expert order, starting from zero
  (the order in which the reference's ``y.at[sel_idx].add`` visits a
  token's updates; a selected token with a zero gate adds nothing).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init, silu

__all__ = ["init_moe", "capacity", "top_k", "moe_forward",
           "dispatch_cumsum", "combine_cumsum"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, moe: MoEConfig,
             dtype):
    """Router (D, E) f32; expert slabs (E, D, F), (E, D, F), (E, F, D)."""
    e = moe.num_experts

    def slab(in_dim, out_dim):
        return dense_init(gen, in_dim, (e, out_dim), dtype).transpose(
            0, 1).contiguous()
    return {"router": dense_init(gen, d_model, e, torch.float32),
            "wi_gate": slab(d_model, d_ff), "wi_up": slab(d_model, d_ff),
            "wo": slab(d_ff, d_model)}


def capacity(tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return min(tokens, max(4, c))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on the last axis: the k largest values, largest
    first, equal values in ascending index order -> (values, int64
    indices)."""
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    top = torch.topk((key << 32) | rev, k, dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx


def moe_forward(params, x: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y, aux_loss): the reference's single-device path."""
    return _moe_forward_local(params, x, moe)


def _route(xf: torch.Tensor, router: torch.Tensor, e: int, k: int):
    """Routing in f32 -> (gates (T,E): the renormalized top-k probability
    where the token chose the expert, else 0; probs (T,E); top_p (T,k);
    top_i (T,k))."""
    t = xf.shape[0]
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_i = top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    gates = torch.zeros((t, e), dtype=torch.float32, device=xf.device)
    gates.scatter_(1, top_i, top_p)
    return gates, probs, top_p, top_i


def _moe_forward_local(params, x: torch.Tensor, moe: MoEConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device gather dispatch: route, each expert's top-C tokens
    by gate, the expert FFNs, the fixed-order combine."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    xf = x.reshape(t, d)
    gates, probs, _, top_i = _route(xf, params["router"], e, k)
    c = capacity(t, moe)
    sel_gate, sel_idx = top_k(gates.T, c)                        # (E,C)
    xe = xf[sel_idx.reshape(-1)].reshape(e, c, d)
    dt = x.dtype
    ye = _expert_ffn(xe, params["wi_gate"], params["wi_up"], params["wo"],
                     dt, n_chunks=1)
    ye = ye * sel_gate[..., None].to(dt)
    y = _combine_selected(ye, sel_idx, top_i)
    return y.reshape(b, s, d), _aux_loss(gates, probs, moe)


def _combine_selected(ye: torch.Tensor, sel_idx: torch.Tensor,
                      top_i: torch.Tensor) -> torch.Tensor:
    """ye (E,C,D) gate-weighted expert outputs of the tokens ``sel_idx``
    (E,C) -> y (T,D): each token's sum over the experts it chose that
    kept it, in ascending expert order, from zero, in ye's dtype."""
    e, c, d = ye.shape
    t = top_i.shape[0]
    slot = torch.full((e, t), -1, dtype=torch.int64, device=ye.device)
    slot.scatter_(1, sel_idx, torch.arange(
        c, dtype=torch.int64, device=ye.device).expand(e, c).contiguous())
    experts = torch.sort(top_i, dim=1).values                    # (T,k)
    slots = torch.gather(slot.T, 1, experts)                      # (T,k)
    y = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(experts.shape[1]):
        kept = slots[:, j] >= 0
        v = ye[experts[:, j], slots[:, j].clamp(min=0)]
        y = y + torch.where(kept[:, None], v, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))
    return y


def dispatch_cumsum(xf: torch.Tensor, top_i: torch.Tensor, c: int, e: int):
    """Switch-style dispatch: xf (T,D), top_i (T,k) distinct experts a
    token -> (xe (E,C,D), eid (T,k), pos (T,k), keep (T,k)); a token's
    slot in its expert is its order of arrival (tokens, then their k
    choices), slots at or past C drop (pos = C)."""
    t, k = top_i.shape
    d = xf.shape[1]
    flat = F.one_hot(top_i.long(), e).reshape(t * k, e)
    prior = torch.cumsum(flat, 0) - flat
    pos = (prior * flat).sum(1).reshape(t, k)
    keep = pos < c
    pos_clip = torch.where(keep, pos, c)
    xe = torch.zeros((e, c + 1, d), dtype=xf.dtype, device=xf.device)
    # kept slots are distinct; the dropped all land in the discarded slot C
    xe[top_i.reshape(-1).long(), pos_clip.reshape(-1)] = (
        xf[:, None].expand(t, k, d).reshape(t * k, d))
    return xe[:, :c], top_i, pos_clip, keep


def combine_cumsum(ye: torch.Tensor, top_p: torch.Tensor, top_i, pos_clip,
                   keep, dt) -> torch.Tensor:
    """ye (E,C,D) -> y (T,D): each token's k expert outputs, gate-weighted
    and summed (a dropped slot reads the zero row C)."""
    e, c, d = ye.shape
    t, k = top_i.shape
    ye_pad = torch.cat([ye, ye.new_zeros((e, 1, d))], 1)
    vals = ye_pad[top_i.reshape(-1).long(), pos_clip.reshape(-1)]
    w = (top_p * keep.float()).to(dt)
    return (vals.reshape(t, k, d) * w[..., None]).sum(1)


def _expert_ffn(xe: torch.Tensor, wi_gate, wi_up, wo, dt,
                n_chunks: int = 8) -> torch.Tensor:
    """xe (E,C,D) × the expert slabs -> (E,C,D) in ``dt``: the SwiGLU of
    each expert on its slots, the slot axis in ``n_chunks`` chunks one
    after another (where C divides and C >= 2·n_chunks) so that only
    C/n_chunks × F intermediates are live at once."""
    wi_gate, wi_up, wo = wi_gate.to(dt), wi_up.to(dt), wo.to(dt)

    def one(x):
        h = silu(torch.einsum("ecd,edf->ecf", x, wi_gate)) * torch.einsum(
            "ecd,edf->ecf", x, wi_up)
        return torch.einsum("ecf,efd->ecd", h, wo)
    c = xe.shape[1]
    if n_chunks > 1 and c % n_chunks == 0 and c >= 2 * n_chunks:
        return torch.cat([one(x) for x in xe.chunk(n_chunks, dim=1)], 1)
    return one(xe)


def _aux_loss(gates: torch.Tensor, probs: torch.Tensor, moe: MoEConfig
              ) -> torch.Tensor:
    """Switch-style load-balance loss (the reference's, without the
    cross-device means of the expert-parallel path)."""
    dispatch_frac = (gates > 0).float().mean(0)
    prob_frac = probs.mean(0)
    return (moe.num_experts * (dispatch_frac * prob_frac).sum()
            * moe.aux_loss_coef)
