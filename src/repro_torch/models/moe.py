"""Token-choice top-k MoE with capacity-bounded per-expert gather dispatch
(the port of ``repro/models/moe.py``).

Every token picks its top-k experts by router probability; every expert
then takes its top-C tokens by gate (C = ``capacity``), runs its SwiGLU
FFN on them, batched over the expert axis, and the gate-weighted outputs
are summed back per token.  Tokens beyond an expert's capacity are
dropped.  ``moe_forward`` takes the reference's paths on the reference's
condition: on a mesh with a ``model`` axis under the ``"2d"`` profile
whose size divides the experts, ``moe_forward_ep`` (expert parallelism,
both its schemes, on ``torch.distributed``); otherwise the single-device
path (``_moe_forward_global``), over the whole batch where a mesh shards
it: the reference's GSPMD computes that path on the global token axis,
so each expert's top-C tokens are chosen among all ranks' tokens.

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
import os
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init, silu

__all__ = ["init_moe", "capacity", "top_k", "moe_forward", "uses_ep",
           "slab_gather_axis", "moe_forward_ep", "dispatch_cumsum", "combine_cumsum"]


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


def uses_ep(mesh, moe: MoEConfig) -> bool:
    """The reference's dispatch condition for ``moe_forward_ep``: a mesh
    with a ``model`` dim, the ``"2d"`` profile, more than one device in
    all, and ``model`` dividing the experts (a ``("data", "model")``
    mesh of shape (2, 1) takes it with one model rank).  ``mesh`` may be
    a ``sharding.MeshShape``."""
    if mesh is None:
        return False
    sizes = sharding.axis_sizes(mesh)
    return ("model" in sizes and sharding.profile() == "2d"
            and math.prod(sizes.values()) > 1
            and moe.num_experts % sizes["model"] == 0)


def slab_gather_axis(mesh, moe: MoEConfig):
    """The ``data`` axis (a ``sharding.MeshAxis``) over which
    ``moe_forward_ep`` gathers the expert slabs' FSDP shards itself,
    cast to the compute dtype, its backward a reduce-scatter; None where
    the layer's gather hands it the slabs whole on ``data``
    (``REPRO_MOE_GATHER_INSIDE=0``, no EP, or ``data`` of size 1).  The
    one statement of the choice: ``sharding.LMLayout.gather_layer``
    leaves the slabs to the MoE exactly when this is not None."""
    if not uses_ep(mesh, moe) or \
            os.environ.get("REPRO_MOE_GATHER_INSIDE", "1") == "0":
        return None
    return sharding.mesh_axis(mesh, "data")


def moe_forward(params, x: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y, aux_loss).  Under an active mesh ``x`` is this
    rank's rows and ``params`` its layer's gathered params (the expert
    slabs its block of the experts where ``moe_forward_ep`` runs)."""
    mesh = sharding.active_mesh()
    if uses_ep(mesh, moe):
        return moe_forward_ep(params, x, moe, mesh)
    return _moe_forward_global(params, x, moe, _batch_axes(mesh))


def _batch_axes(mesh):
    """The batch axes of ``mesh`` with more than one rank, in order."""
    if mesh is None:
        return []
    return [a for a in (sharding.mesh_axis(mesh, n)
                        for n in sharding.dp_spec(mesh)) if a is not None]


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


def _combine_selected(ye: torch.Tensor, sel_idx: torch.Tensor,
                      top_i: torch.Tensor) -> torch.Tensor:
    """ye (E,C,D) gate-weighted expert outputs of the tokens ``sel_idx``
    (E,C) -> y (T,D): each token's sum over the experts it chose that
    kept it, in ascending expert order, from zero, in ye's dtype.  An
    index T in ``sel_idx`` marks a slot of no token of this ``top_i``."""
    e, c, d = ye.shape
    t = top_i.shape[0]
    slot = torch.full((e, t + 1), -1, dtype=torch.int64, device=ye.device)
    slot.scatter_(1, sel_idx, torch.arange(
        c, dtype=torch.int64, device=ye.device).expand(e, c).contiguous())
    slot = slot[:, :t]
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


def _aux_loss(gates: torch.Tensor, probs: torch.Tensor, moe: MoEConfig,
              axes: Sequence = ()) -> torch.Tensor:
    """Switch-style load-balance loss; the two fractions are first
    averaged over the ranks of ``axes`` (the reference's ``pmean``; one
    f32 all-reduce, whose backward hands each rank its share)."""
    dispatch_frac = (gates > 0).float().mean(0)
    prob_frac = probs.mean(0)
    axes = [a for a in axes if a is not None]
    if axes:
        both = sharding.reduce_sum(torch.stack([dispatch_frac, prob_frac]),
                                   *axes) / math.prod(a.size for a in axes)
        dispatch_frac, prob_frac = both[0], both[1]
    return (moe.num_experts * (dispatch_frac * prob_frac).sum()
            * moe.aux_loss_coef)


def _moe_forward_global(params, x: torch.Tensor, moe: MoEConfig, axes
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-device gather dispatch (route, each expert's top-C
    tokens by gate, the expert FFNs, the fixed-order combine) over a
    batch sharded on ``axes`` (this rank's rows ``x``; no axes: the
    whole batch), as GSPMD computes it: capacity from all ranks' tokens,
    and each expert's top-C tokens by gate among all of them (the ranks'
    gates all-gathered, rank-major); each rank runs the experts on its
    own selected tokens and combines its own rows."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    xf = x.reshape(t, d)
    gates, probs, _, top_i = _route(xf, params["router"], e, k)
    everyone = gates.detach()
    for axis in reversed(axes):
        everyone = sharding.all_gather_rows(everyone, axis)
    idx = 0
    for axis in axes:
        idx = idx * axis.size + axis.rank
    c = capacity(everyone.shape[0], moe)
    _, sel_idx = top_k(everyone.T, c)                            # (E,C)
    loc = sel_idx - idx * t
    loc = torch.where((loc >= 0) & (loc < t), loc, t)            # t: not mine
    xe = torch.cat([xf, xf.new_zeros((1, d))])[loc.reshape(-1)].reshape(
        e, c, d)
    sel_gate = torch.cat([gates, gates.new_zeros((1, e))]).T.gather(1, loc)
    dt = x.dtype
    ye = _expert_ffn(xe, params["wi_gate"], params["wi_up"], params["wo"],
                     dt, n_chunks=1)
    ye = ye * sel_gate[..., None].to(dt)
    y = _combine_selected(ye, loc, top_i)
    return y.reshape(b, s, d), _aux_loss(gates, probs, moe, axes)


def moe_forward_ep(params, x: torch.Tensor, moe: MoEConfig, mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism (the reference's ``shard_map`` body, on
    ``torch.distributed``): the experts shard over ``model``; ``params``
    holds this rank's block of the expert slabs (E/m, ...), ``x`` its
    rows (the batch over the batch axes), whole on ``model``.

    Scheme A (``S % model == 0``, ``S > 1``): the tokens shard over
    ``model`` too (each rank its block of the sequence): local route,
    capacity from the local token count, dispatch, ``all_to_all`` of the
    expert blocks to their ranks, the local experts' FFN on every rank's
    tokens, ``all_to_all`` back, combine, the sequence gathered back.
    Scheme B (any other S: decode at ``S == 1``, or a sequence that
    ``model`` does not divide): every rank routes all its tokens, runs
    its own experts' slots, and the combine is an f32 sum over
    ``model``; the tokens and gates entering the rank's own experts'
    share sum their gradients over ``model``, as the reference's
    ``shard_map`` does for its replicated inputs.
    ``REPRO_MOE_DISPATCH`` (``cumsum``, the default, or the gate
    ``top_k`` form) is read as the reference reads it, and
    ``REPRO_MOE_GATHER_INSIDE`` through ``slab_gather_axis``.  The aux loss averages over the batch axes
    and, in scheme A, ``model``."""
    model = sharding.mesh_axis(mesh, "model")
    m = sharding.mesh_axis_size(mesh, "model")
    dp = _batch_axes(mesh)
    e, k = moe.num_experts, moe.top_k
    e_local = e // m
    b, s, d = x.shape
    dt = x.dtype
    token_sharded = s % m == 0 and s > 1
    use_cumsum = os.environ.get("REPRO_MOE_DISPATCH", "cumsum") == "cumsum"
    wi_gate, wi_up, wo = params["wi_gate"], params["wi_up"], params["wo"]
    inside = slab_gather_axis(mesh, moe)
    if inside is not None:
        wi_gate, wi_up, wo = sharding.flat_gather(
            [wi_gate, wi_up, wo], [1, 1, 2], inside, dt, True)
    router = params["router"]
    if token_sharded:
        router = sharding.copy_to_model(router, model)
        x = sharding.split_dim(x, model, 1)
    bl, sl, _ = x.shape
    t = bl * sl
    xf = x.reshape(t, d)
    gates, probs, top_p, top_i = _route(xf, router, e, k)
    c = capacity(t, moe)
    if not token_sharded:
        # every model rank routes all its tokens alike, so the route's and
        # the aux's gradients are whole on each; what feeds the rank's own
        # experts' share of y sums its cotangent over model (Megatron's f)
        xf, top_p, gates = (sharding.copy_to_model(v, model)
                            for v in (xf, top_p, gates))
    if use_cumsum:
        xe, eid, pos_clip, keep = dispatch_cumsum(xf, top_i, c, e)
    else:
        sel_gate, sel_idx = top_k(gates.T, c)                    # (E,C)
        xe = xf[sel_idx.reshape(-1)].reshape(e, c, d)
    if token_sharded:
        # expert blocks to their ranks: (m, E_l, C, D) from every rank
        xe = sharding.all_to_all(xe, model).reshape(m, e_local, c, d)
        xe = xe.transpose(0, 1).reshape(e_local, m * c, d)
        ye = _expert_ffn(xe, wi_gate, wi_up, wo, dt)
        ye = ye.reshape(e_local, m, c, d).transpose(0, 1).contiguous()
        ye = sharding.all_to_all(ye, model).reshape(e, c, d)
        if use_cumsum:
            y = combine_cumsum(ye, top_p, eid, pos_clip, keep, dt)
        else:
            y = _combine_selected(ye * sel_gate[..., None].to(dt), sel_idx,
                                  top_i)
        aux = _aux_loss(gates, probs, moe, dp + [model])
        return sharding.gather_dim(y.reshape(bl, sl, d), model, 1), aux
    r0 = (model.rank if model is not None else 0) * e_local
    mine = slice(r0, r0 + e_local)
    ye = _expert_ffn(xe[mine], wi_gate, wi_up, wo, dt)
    if not use_cumsum:
        ye = ye * sel_gate[mine, :, None].to(dt)
    pad = lambda n: ye.new_zeros((n, c, d))
    ye = torch.cat([pad(r0), ye, pad(e - r0 - e_local)])         # (E,C,D)
    if use_cumsum:
        y = combine_cumsum(ye, top_p, eid, pos_clip, keep, dt)
    else:
        y = _combine_selected(ye.float(), sel_idx, top_i)
    y = sharding.reduce_sum(y.float(), model).to(dt)
    return y.reshape(b, s, d), _aux_loss(gates, probs, moe, dp)
