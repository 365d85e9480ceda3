"""Adam over a tree of tensors, the port of ``repro.train.optimizer``.

The arithmetic is the reference's: ``m/bc1 / (sqrt(v/bc2) + eps)`` with
the bias corrections computed from the step count in float32.
``torch.optim.Adam`` places ``eps`` and the corrections differently, so
it is not used.  Unlike the reference, ``adam_update`` updates the
parameters and moments in place (one multi-tensor launch per operation
on the card for each group of leaves, no new buffers kept) and returns
them.  The leaves go in groups of at most ``GROUP_ELEMENTS`` elements
(a leaf larger than that alone), so the update's temporaries stay
within a few times a group: a SplitNN's params are one group, an LLM's
f32 params (4.4 GB at tinyllama-1.1b) several, whose temporaries would
otherwise add 3× the params to a training step's peak memory.  The step
count lives on the host, so the corrections cost no device round trip.
A tree is a tensor, or a dict or list of trees (the SplitNN zoo's
``{"bottoms": [...], "top": {...}}`` and the slab form).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["AdamState", "adam_init", "adam_update", "sgd_init", "sgd_update",
           "tree_leaves", "tree_map"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    return AdamState(step=0, mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


#: the most elements a group of leaves ``adam_update`` updates together
GROUP_ELEMENTS = 1 << 26


def _groups(leaves: List[torch.Tensor]) -> List[slice]:
    """Runs of consecutive leaves of at most ``GROUP_ELEMENTS`` elements
    (a larger leaf alone)."""
    out, start, size = [], 0, 0
    for i, t in enumerate(leaves):
        if i > start and size + t.numel() > GROUP_ELEMENTS:
            out.append(slice(start, i))
            start, size = i, 0
        size += t.numel()
    return out + [slice(start, len(leaves))]


def adam_update(params, grads, state: AdamState, *, lr: float = 1e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> Tuple[Any, AdamState]:
    """One Adam step, in place on ``params`` and ``state``'s moments.
    ``grads`` is a tree of ``params``'s structure or its leaf list.
    ``weight_decay`` adds ``weight_decay · p`` to the step before ``lr``
    scales it (the reference's decoupled decay)."""
    step = state.step + 1
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    ps, ms, vs, gs = (tree_leaves(params), tree_leaves(state.mu),
                      tree_leaves(state.nu), tree_leaves(grads))
    for part in _groups(ps):
        _adam_group(ps[part], [g.float() for g in gs[part]], ms[part],
                    vs[part], lr, b1, b2, eps, bc1, bc2, weight_decay)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)


def _adam_group(ps, gs, ms, vs, lr, b1, b2, eps, bc1, bc2,
                weight_decay) -> None:
    with torch.no_grad():
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1.0 - b2))
        upd = torch._foreach_div(ms, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        if weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ps, upd)


def sgd_init(params) -> int:
    """Plain SGD's state: the step count."""
    return 0


def sgd_update(params, grads, state: int, *, lr: float = 0.1, **_
               ) -> Tuple[Any, int]:
    """One SGD step, ``p - lr·g`` in f32 cast back to p's dtype, in
    place on ``params``; other keyword arguments (Adam's) are ignored,
    as the reference does."""
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_((p.float() - g.float() * lr).to(p.dtype))
    return params, state + 1
