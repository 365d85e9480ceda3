"""Roofline model of one NVIDIA H100 SXM (the port of
``repro/analysis/roofline.py``, with the reference's arithmetic).

Per (arch × shape × mesh), from a dry run (``launch.dryrun``):

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / (links × link_bw)

A collective term the caller did not count (``None``: a dry run on fake
tensors sees no collective) stays ``None`` and takes no part in the
bound.  Plus MODEL_FLOPS = 6·N·D (6·N_active·D for MoE) and the useful-compute
ratio MODEL_FLOPS / (FLOPs × chips).

``HW`` holds NVIDIA's data-sheet peaks of the H100 SXM part (dense, no
sparsity), which assume its full 700 W: the card this port runs on
reports itself as ``NVIDIA H100 80GB HBM3, 700.00 W``
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12        # bf16 FLOP/s a card, dense
    hbm_bw: float = 3.35e12           # bytes/s a card (HBM3)
    hbm_bytes: float = 80e9           # bytes of HBM a card
    link_bw: float = 25e9             # bytes/s a NVLink 4 link, a direction
    links: int = 18                   # NVLink 4 links a card


HW = Hardware()


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: Optional[float],
                   model_flops_global: float, chips: int,
                   hw: Hardware = HW) -> Dict[str, object]:
    compute_s = flops_per_device / hw.peak_flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = (None if collective_bytes_per_device is None else
                    collective_bytes_per_device / (hw.links * hw.link_bw))
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    counted = {k: v for k, v in terms.items() if v is not None}
    dominant = max(counted, key=counted.get)
    bound = max(counted.values())
    useful = (model_flops_global / (flops_per_device * chips)
              if flops_per_device else 0.0)
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops_global": model_flops_global,
        "useful_compute_ratio": useful,
        # the share of the bound the compute term takes
        "compute_fraction_of_bound": compute_s / bound if bound else 0.0,
    }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D with N = (active) params, D = processed tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len  # forward only
    return 2.0 * n * shape.global_batch           # decode: one token each
