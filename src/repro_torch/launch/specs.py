"""Per-(arch × shape) dry-run targets: abstract inputs, placements and
the step (the port of ``repro/launch/specs.py``).

``build_dryrun(cfg, shape, mesh)`` returns ``(fn, abstract_args,
in_placements, out_placements)``.  An abstract tensor is a
``TensorSpec`` (shape and dtype, no memory: what the reference's
``jax.ShapeDtypeStruct`` is); ``fake_args`` turns them into fake tensors
inside a ``FakeTensorMode``, on which ``fn`` runs at the global shape
and holds no memory (``launch.dryrun``).  A placement is the
reference's ``PartitionSpec`` as a tuple (``sharding``), a tree of them
beside the tree of abstract args; ``None`` leaves the output's placement
open, as the reference's ``out_shardings=None`` does.

Shapes (``configs.INPUT_SHAPES``):
  train_4k     → train_step (forward, backward, Adam) on (B, S) tokens
  prefill_32k  → prefill: the prompt's forward and its caches, the last
                 position's logits
  decode_32k   → serve step: ONE token against a seq_len cache
  long_500k    → serve step at a context of 524,288, for the
                 sub-quadratic archs only (SSM state, ring caches of the
                 window: ``force_window``)

Where the reference differs:
- the reference's layer-scanned caches (its ``uniform_decode`` archs)
  carry a leading layer axis, never sharded; the port's caches are a
  list of layers, each with the same placement without that entry;
- ``build_train`` takes ``remat`` and ``attn_impl`` (an attention form
  that ``attention.use_form`` fixes) as arguments where the reference
  reads ``REPRO_REMAT`` and ``REPRO_ATTN_IMPL``.  Remat is on by
  default, as there.  The reference's default form, ``"chunked"`` at
  seq_len >= 8,192, becomes ``attention.attend``'s own rule (no form
  fixed): K11 on the card, and off it the same chunked-at-8,192 rule.
  ``build_prefill`` likewise.  Only the dry run fixes a form
  (``"full"``).  Nothing here reads the environment.
- the decode step's ``cur_index`` is a Python int (the port's decode
  takes one), ``seq_len - 1``, the last position of the context.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import api, encdec, transformer
from repro_torch.models import attention as attn_mod
from repro_torch.models.api import TensorSpec
from repro_torch.models.layers import dtype_of
from repro_torch.train.optimizer import AdamState
from repro_torch.train.steps import make_train_step

__all__ = ["LONG_CONTEXT_OK", "TensorSpec", "supports", "batch_specs",
           "abstract_params", "abstract_opt", "batch_shardings_abstract",
           "fake_args", "build_train", "build_prefill",
           "build_decode", "build_dryrun"]

LONG_CONTEXT_OK = ("mamba2-1.3b", "hymba-1.5b", "gemma2-9b")


def supports(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch, shape) combination runs (DESIGN.md §4)."""
    if shape.name == "long_500k" and cfg.arch_id not in LONG_CONTEXT_OK:
        return False, ("pure full attention (or ≤448-token decoder): no "
                       "sub-quadratic 500k decode in the source family")
    return True, ""


# ----------------------------------------------------------- abstract inputs

def _specs(tree):
    """A tree of tensors as a tree of ``TensorSpec``s (lists and dicts
    kept; an ``AdamState`` keeps its host step)."""
    if isinstance(tree, AdamState):
        return AdamState(tree.step, _specs(tree.mu), _specs(tree.nu))
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs(v) for v in tree)
    return TensorSpec(tuple(tree.shape), tree.dtype)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *, with_labels: bool
                ) -> Dict[str, TensorSpec]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if with_labels:
        out["labels"] = TensorSpec((b, s), torch.int32)
        out["weights"] = TensorSpec((b,), torch.float32)
    if cfg.family == "audio":
        out["frames"] = TensorSpec((b, cfg.enc_seq, cfg.d_model),
                                   torch.float32)
    if cfg.family == "vlm":
        out["patches"] = TensorSpec((b, cfg.vision_tokens, cfg.d_model),
                                    torch.float32)
    return out


def abstract_params(cfg: ArchConfig):
    """``api.init_params``' tree as ``TensorSpec``s (``api.param_specs``,
    cached: do not modify it)."""
    return api.param_specs(cfg)


def abstract_opt(aparams) -> AdamState:
    """The port's Adam state (``adam_init``): both moments in the
    params' dtype (f32 for every config), the step a host int."""
    return AdamState(step=0, mu=_specs(aparams), nu=_specs(aparams))


def batch_shardings_abstract(abatch, mesh):
    return sharding.batch_shardings(abatch, mesh)


def fake_args(args, mode):
    """The abstract args as fake tensors of ``mode`` (zeros; Python
    values kept)."""
    if isinstance(args, TensorSpec):
        with mode:
            return torch.zeros(args.shape, dtype=args.dtype)
    if isinstance(args, AdamState):
        return AdamState(args.step, fake_args(args.mu, mode),
                         fake_args(args.nu, mode))
    if isinstance(args, dict):
        return {k: fake_args(v, mode) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(fake_args(v, mode) for v in args)
    return args


def _with_form(fn, form: Optional[str]):
    """``fn`` with its attention in ``form`` (``attention.use_form``);
    ``fn`` itself for ``None``/``"auto"``, attend's own rule."""
    if form in (None, "auto"):
        return fn

    def run(*args):
        with attn_mod.use_form(form):
            return fn(*args)
    return run


# -------------------------------------------------------------- cache specs

def _cache_spec_tree(acaches, mesh, cfg: ArchConfig):
    """KV caches: batch→dp; kv-heads→model when divisible, else
    seq→model.  SSM states: batch→dp, heads→model when divisible; the
    conv window's channels→model.  ``pos`` (slot bookkeeping)
    replicated."""
    dp = sharding.dp_spec(mesh)
    msize = sharding.axis_sizes(mesh).get("model", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        last = path.rsplit("/", 1)[-1]
        if last == "pos":
            return sharding._spec([None] * nd)
        entries = [None] * nd
        if nd:
            entries[0] = dp if dp else None
        if last in ("k", "v", "cross_k", "cross_v"):
            kv_dim, s_dim = nd - 2, nd - 3           # (B, S, KV, Dh)
            if shape[kv_dim] % msize == 0:
                entries[kv_dim] = "model"
            elif shape[s_dim] % msize == 0:
                entries[s_dim] = "model"
        elif last == "state":                        # (B, H, P, N)
            if shape[nd - 3] % msize == 0:
                entries[nd - 3] = "model"
        elif last == "conv":                         # (B, W-1, di)
            if shape[nd - 1] % msize == 0:
                entries[nd - 1] = "model"
        return sharding.check_divisible(sharding._spec(entries), shape,
                                        mesh)

    return sharding._map_path(one, acaches)


# ------------------------------------------------------------------ steps

def build_train(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                remat: bool = True, attn_impl: Optional[str] = None):
    """The train step (``make_train_step``, lr 1e-4): forward, backward
    and Adam.  ``remat`` recomputes each layer in the backward;
    ``attn_impl``, where given, fixes the attention form (default:
    ``attention.attend``'s rule)."""
    aparams = abstract_params(cfg)
    aopt = abstract_opt(aparams)
    abatch = batch_specs(cfg, shape, with_labels=True)
    p_shard = sharding.param_specs_abstract(aparams, mesh)
    opt_shard = AdamState(step=sharding.replicated(mesh), mu=p_shard,
                          nu=p_shard)
    b_shard = batch_shardings_abstract(abatch, mesh)
    step = _with_form(make_train_step(cfg, lr=1e-4, remat=remat), attn_impl)
    return (step, (aparams, aopt, abatch), (p_shard, opt_shard, b_shard),
            (p_shard, opt_shard, None))


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                  attn_impl: Optional[str] = None):
    """The prompt's forward and its caches (context seq_len + 1), the
    last position's logits; audio: the encoder and the decoder's
    forward.  ``attn_impl`` as ``build_train``'s."""
    aparams = abstract_params(cfg)
    abatch = batch_specs(cfg, shape, with_labels=False)
    p_shard = sharding.param_specs_abstract(aparams, mesh)
    b_shard = batch_shardings_abstract(abatch, mesh)

    if cfg.family == "audio":
        def fn(params, batch):
            return encdec.forward_encdec(params, cfg, batch["tokens"],
                                         batch["frames"], last_only=True)
    else:
        def fn(params, batch):
            return transformer.prefill(
                params, cfg, batch["tokens"], api.extra_embeds_of(cfg, batch),
                context_len=shape.seq_len + 1, last_only=True)

    return (_with_form(fn, attn_impl), (aparams, abatch), (p_shard, b_shard),
            None)


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """ONE token against caches of a seq_len context, at ``cur_index``
    seq_len - 1; long_500k puts every attention layer of a non-SSM arch
    on a ring cache of its window (``force_window``)."""
    aparams = abstract_params(cfg)
    b, ctx = shape.global_batch, shape.seq_len
    force_window = shape.name == "long_500k" and cfg.family != "ssm"
    p_shard = sharding.param_specs_abstract(aparams, mesh)
    dp = sharding.dp_spec(mesh)
    tok = TensorSpec((b,), torch.int32)
    idx = ctx - 1
    tok_shard = sharding.check_divisible(sharding._spec([dp or None]),
                                         (b,), mesh)
    idx_shard = sharding.replicated(mesh)

    if cfg.family == "audio":
        mode = _fake_mode()
        amem = TensorSpec((b, cfg.enc_seq, cfg.d_model), dtype_of(cfg.dtype))
        with mode:
            acaches = _specs(encdec.init_decode_state(
                fake_args(aparams, mode), cfg, b, ctx,
                fake_args(amem, mode)))

        def fn(params, caches, cur_index, token):
            return encdec.decode_step(params, cfg, caches, cur_index, token)
    else:
        with _fake_mode():
            acaches = _specs(transformer.init_decode_state(
                cfg, b, ctx, force_window=force_window, device="cpu"))

        def fn(params, caches, cur_index, token):
            return transformer.decode_step(params, cfg, caches, cur_index,
                                           token, force_window=force_window)

    c_shard = _cache_spec_tree(acaches, mesh, cfg)
    return (fn, (aparams, acaches, idx, tok),
            (p_shard, c_shard, idx_shard, tok_shard), (None, c_shard))


def build_dryrun(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                 attn_impl: Optional[str] = None):
    """The shape's ``build_*``; ``attn_impl``, where given, is the attention
    form of a train or prefill step (a decode step attends to its cache,
    ``attention.decode_attention``)."""
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, attn_impl=attn_impl)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, attn_impl=attn_impl)
    return build_decode(cfg, shape, mesh)
