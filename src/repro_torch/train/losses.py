"""Per-sample-weighted losses — Eq. (2) of the paper, the port of
``repro.train.losses``:

    L(D_core, W_core, θ) = Σ_i  w_i · L(x_i, θ)  /  max(Σ_i w_i, 1e-12)

``w=None`` means uniform (vanilla VFL "ALL" training).  The per-sample
terms (``*_terms``) are shared with the sharded train engine, which sums
``w·l`` and ``w`` on each rank and divides after the all-reduce.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["weighted_softmax_xent", "weighted_mse", "weighted_binary_xent",
           "softmax_xent_terms", "squared_error_terms", "binary_xent_terms"]


def _norm_weights(w: Optional[torch.Tensor], like: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    w = torch.ones_like(like) if w is None else w.float()
    return w, torch.clamp(w.sum(), min=1e-12)


def softmax_xent_terms(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """logits (..., C), labels (...) integer -> CE (...) in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, labels.long()[..., None])[..., 0]


def squared_error_terms(pred: torch.Tensor, target: torch.Tensor
                        ) -> torch.Tensor:
    """pred/target (B, ...) -> ||p_i - t_i||² (B,) in f32."""
    return torch.square(pred.float() - target.float()).sum(
        dim=tuple(range(1, pred.ndim)))


def binary_xent_terms(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """logits (B,), labels (B,) in {0, 1} -> CE (B,) in f32.  The
    gradient at a zero logit is the reference's, -y: ``torch.maximum``
    against a zero tensor splits it as ``jnp.maximum`` does (1/2), and
    ``|l|`` is written as ``where(l >= 0, l, -l)``, whose slope at 0 is 1
    as ``jnp.abs``'s is (``Tensor.abs`` has slope 0 there).  Quantized
    logits hit 0 exactly."""
    logits = logits.float()
    labels = labels.float()
    abs_l = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-abs_l)))


def weighted_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                          w: Optional[torch.Tensor] = None, *,
                          label_mask: Optional[torch.Tensor] = None,
                          axes: Sequence = ()) -> torch.Tensor:
    """logits (..., C), labels (...) integer, w broadcastable to labels
    -> scalar Σ_i w_i·CE_i / Σ_i w_i.  ``label_mask`` (labels' shape)
    drops the positions where it is 0 from both sums, as the
    reference's token-level mask does.  ``axes`` (``sharding.MeshAxis``es
    whose ranks hold the other rows): both sums are taken over their
    ranks' rows too, in one f32 all-reduce whose backward hands each
    rank the gradient of the whole loss at its own rows."""
    ce = softmax_xent_terms(logits, labels)
    if label_mask is not None:
        ce = ce * label_mask.float()
    if w is None:
        w_full = torch.ones_like(ce)
    else:
        w_full = w.float().reshape(
            w.shape + (1,) * (ce.ndim - w.ndim)).expand(ce.shape)
    if label_mask is not None:
        w_full = w_full * label_mask.float()
    if axes:
        from repro_torch.sharding import reduce_sum
        both = reduce_sum(torch.stack([(w_full * ce).sum(), w_full.sum()]),
                          *axes)
        return both[0] / torch.clamp(both[1], min=1e-12)
    return (w_full * ce).sum() / torch.clamp(w_full.sum(), min=1e-12)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred/target (B, ...) -> scalar Σ w_i ||p_i - t_i||² / Σ w_i."""
    err = squared_error_terms(pred, target)
    w, z = _norm_weights(w, err)
    return (w * err).sum() / z


def weighted_binary_xent(logits: torch.Tensor, labels: torch.Tensor,
                         w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,), labels (B,) in {0, 1} (``binary_xent_terms``)."""
    ce = binary_xent_terms(logits, labels)
    w, z = _norm_weights(w, ce)
    return (w * ce).sum() / z
