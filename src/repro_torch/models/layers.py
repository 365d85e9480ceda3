"""Shared model primitives: norms, rotary, MLPs, embeddings, init helpers
(the port of ``repro/models/layers.py``).

Params are nested dicts of tensors; every module is an ``init_*(gen,
...) -> params`` + ``apply(params, x) -> y`` pair.  Layer stacks carry a
leading ``L`` axis, as the reference's.

Init draws come from an explicit ``torch.Generator`` on the target
device, so a full-size model initialises on the card in seconds.  They
are not ``jax.random``'s bits: where the port must hold the reference's
weights (the tests), it takes them across with
``interop.lm_params_from_jax``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import sharding

__all__ = ["dtype_of", "dense_init", "embed_init", "stacked", "layer_of",
           "layers_of", "init_rmsnorm", "rmsnorm", "init_layernorm",
           "layernorm", "rotary_embed", "sinusoidal_positions", "silu",
           "init_glu_mlp", "glu_mlp", "init_gelu_mlp", "gelu_mlp", "softcap"]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils

_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _truncated_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2] (inverse CDF of a
    uniform on [Φ(-2), Φ(2)]), f32 on the generator's device."""
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(_PHI_LO, _PHI_HI, generator=gen)
    return torch.special.ndtri(u).clamp_(-2.0, 2.0)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init; out_shape may be a tuple (fused heads)."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    std = scale if scale is not None else in_dim ** -0.5
    return (_truncated_normal(gen, (in_dim,) + tuple(out_shape))
            * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype
               ) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def stacked(init_fn, gen: torch.Generator, n: int, *args, **kwargs):
    """``n`` stacked copies (leading axis) of a param tree, drawn one
    after another; each copy goes into its slot as it is drawn, so the
    peak is the stack plus one copy (not two stacks)."""
    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return tree.new_empty((n,) + tuple(tree.shape))

    def put(out, tree, i):
        if isinstance(tree, dict):
            for k in tree:
                put(out[k], tree[k], i)
        else:
            out[i] = tree

    out = None
    for i in range(n):
        tree = init_fn(gen, *args, **kwargs)
        out = alloc(tree) if out is None else out
        put(out, tree, i)
    return out


def layer_of(stack, i: int):
    """Layer ``i`` of a ``stacked`` param tree (views, no copy): the
    serving paths' one-layer read."""
    if isinstance(stack, dict):
        return {k: layer_of(v, i) for k, v in stack.items()}
    return stack[i]


def layers_of(stack, n: int):
    """The ``n`` layers of a ``stacked`` param tree, taken once: one
    ``torch.unbind`` a stacked leaf (views, no copy).  Under autograd the
    ``n`` slices of a leaf share one backward, a ``stack`` of their
    gradients, where ``n`` reads ``stack[i]`` would each zero-fill a
    gradient the size of the whole stack and add it into ``.grad``."""
    if isinstance(stack, dict):
        per_key = {k: layers_of(v, n) for k, v in stack.items()}
        return [{k: per_key[k][i] for k in per_key} for i in range(n)]
    return list(torch.unbind(stack, 0))


# ---------------------------------------------------------------------- norms

def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5,
            axis=None) -> torch.Tensor:
    """Gemma-style ``(1 + scale)`` RMS norm, in f32, cast back.  With
    ``axis`` (tensor parallelism: x and ``scale`` hold this rank's block
    of the channels) it normalises over the whole width: the sum of
    squares in f32, summed over ``axis`` (``sharding.psum``, its
    cotangent's too in the backward)."""
    dt = x.dtype
    x = x.float()
    if axis is None:
        var = (x * x).mean(-1, keepdim=True)
    else:
        var = (sharding.psum((x * x).sum(-1, keepdim=True), axis)
               / (x.shape[-1] * axis.size))
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# --------------------------------------------------------------------- rotary

def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs      # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]               # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int) -> np.ndarray:
    """The encoder's fixed position table (seq, dim), f32: a copy of the
    reference's numpy function."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return out.astype(np.float32)


# ----------------------------------------------------------------------- MLPs

def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1 / (1 + exp(-x))``, each op in x's dtype: ``jax.nn.silu``'s
    lowering, so a bf16 activation rounds where the reference's does
    (``F.silu`` rounds once and differs in ~40% of bf16 outputs)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``'s formula, each op in x's dtype
    (``F.gelu`` rounds once); both constants are first put into x's dtype,
    as JAX does (in bf16 the cubic coefficient is 0.044677734375)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x ** 3)))))


def init_glu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {"wi_gate": dense_init(gen, d_model, d_ff, dtype),
            "wi_up": dense_init(gen, d_model, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d_model, dtype)}


def glu_mlp(params, x: torch.Tensor, activation: str = "silu",
            d_ff: Optional[int] = None) -> torch.Tensor:
    """The gated MLP.  Where ``params`` hold the rank's block of the
    ``d_ff`` hidden units (tensor parallelism: ``wo`` has fewer rows,
    ``sharding.tp_axis``) x goes through ``copy_to_model`` and the
    row-parallel product is summed over ``model``."""
    act = {"silu": silu, "gelu": _gelu_tanh}[activation]
    axis = None if d_ff is None else sharding.tp_axis(params["wo"].shape[0],
                                                      d_ff)
    x = sharding.copy_to_model(x, axis)
    gate = act(x @ params["wi_gate"].to(x.dtype))
    up = x @ params["wi_up"].to(x.dtype)
    return sharding.reduce_sum((gate * up) @ params["wo"].to(x.dtype), axis)


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {"wi": dense_init(gen, d_model, d_ff, dtype),
            "bi": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "wo": dense_init(gen, d_ff, d_model, dtype),
            "bo": torch.zeros((d_model,), dtype=dtype, device=gen.device)}


def gelu_mlp(params, x: torch.Tensor,
             d_ff: Optional[int] = None) -> torch.Tensor:
    """The GELU MLP with biases.  Where ``params`` hold the rank's block
    of the ``d_ff`` hidden units (``wi``, ``bi`` and ``wo``) x goes
    through ``copy_to_model``, the row-parallel product is summed over
    ``model`` and the replicated ``bo`` is added once, after the sum."""
    axis = None if d_ff is None else sharding.tp_axis(params["wo"].shape[0],
                                                      d_ff)
    x = sharding.copy_to_model(x, axis)
    h = _gelu_tanh(x @ params["wi"].to(x.dtype) + params["bi"].to(x.dtype))
    return (sharding.reduce_sum(h @ params["wo"].to(x.dtype), axis)
            + params["bo"].to(x.dtype))


# -------------------------------------------------------------------- softcap

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
