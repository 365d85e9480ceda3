"""train_step / eval_step factories for the LM architectures (the port
of ``repro.train.steps``).

Every train_step is Eq.(2)-aware: the batch may carry per-sample
``weights`` (the TreeCSS coreset weights) which scale each sequence's
token-level cross-entropy.  This is how the paper's technique becomes a
first-class feature of the framework rather than a bolt-on.

Gradients come from ``torch.autograd``.  Attention runs as ``attn_impl``
says (``None``: K11 forward and backward on a CUDA tensor, the plain
full attention on the CPU; ``"ref"``: the plain version everywhere); the
Mamba2 scan always takes K12's plain version (``scan_impl="ref"``), as
the reference's train path runs its jnp ``ssd_chunked``: K12 has no
backward.  ``adam_update`` updates the params and moments in place.

Under an active mesh (``sharding.use_mesh``), as the reference's steps
read ``active_mesh()``: the params are each rank's blocks
(``init_train_state`` draws them whole from the seed and keeps the
rank's), every rank is given the whole batch and takes its rows, the
loss sums over the batch axes, and the gradients of params that rest
whole on a batch axis are summed over it (``LMLayout.sync_grads``)
before Adam updates each block in place.  Every rank returns the same
metrics.  A mesh whose dims all have size 1 is the unsharded step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.train.losses import weighted_softmax_xent
from repro_torch.train.optimizer import adam_init, adam_update, tree_leaves

__all__ = ["lm_loss", "loss_and_grads", "make_train_step", "make_eval_step",
           "init_train_state"]


def lm_loss(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = True, attn_impl: Optional[str] = None):
    """-> (ce + aux, (ce, aux)): the weighted next-token cross-entropy
    after any prefix (vlm patches, hybrid meta tokens), plus the MoE
    load-balance loss."""
    lay = sharding.lm_layout(cfg)
    if lay is not None:
        batch = lay.local_batch(batch)
    logits, aux, n_prefix = api.forward(params, cfg, batch, remat=remat,
                                        impl=attn_impl, scan_impl="ref")
    # drop any meta/vision prefix, then shift: predict token t+1 at pos t
    if n_prefix:
        logits = logits[:, n_prefix:]
    logits = logits[:, :-1]
    labels = batch["labels"][:, 1:]
    ce = weighted_softmax_xent(logits, labels, batch.get("weights"),
                               axes=lay.batch if lay is not None else ())
    return ce + aux, (ce, aux)


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, Any], *,
                   remat: bool = True, attn_impl: Optional[str] = None):
    """-> (loss, (ce, aux), gradient leaves in ``tree_leaves`` order):
    ``lm_loss`` and its gradients, the params made leaves that require
    grad; under a mesh each rank's gradient of its blocks, summed over
    the batch axes."""
    leaves = [p if p.requires_grad else p.requires_grad_()
              for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, (ce, aux) = lm_loss(params, cfg, batch, remat=remat,
                                  attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    lay = sharding.lm_layout(cfg)
    if lay is not None:
        keys = [k for k, _ in sharding.flat_tree(params)]
        grads = lay.sync_grads(leaves, keys, grads)
    return loss.detach(), (ce.detach(), aux.detach()), grads


def make_train_step(cfg: ArchConfig, *, lr: float = 1e-4,
                    remat: bool = True, attn_impl: Optional[str] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); the params are made leaves that require grad, and are
    updated in place."""

    def train_step(params, opt_state, batch):
        loss, (ce, aux), grads = loss_and_grads(
            params, cfg, batch, remat=remat, attn_impl=attn_impl)
        params, opt_state = adam_update(params, grads, opt_state, lr=lr)
        metrics = {"loss": loss, "ce": ce, "aux": aux}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, *, attn_impl: Optional[str] = None):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, (ce, aux) = lm_loss(params, cfg, batch, remat=False,
                                      attn_impl=attn_impl)
        return {"loss": loss, "ce": ce, "aux": aux}
    return eval_step


def init_train_state(key: Union[int, torch.Generator], cfg: ArchConfig, *,
                     device=None):
    """(params, Adam state): ``key`` a seed, drawn on ``device`` (``None``:
    the CUDA device), or a ``torch.Generator``, whose device they go to.
    Under an active mesh each rank draws the whole params and keeps its
    blocks (the rest is freed)."""
    params = api.init_params(key, cfg, device=device)
    lay = sharding.lm_layout(cfg)
    if lay is not None:
        params = lay.shard(params)
    return params, adam_init(params)
