"""Plain PyTorch version of the SSD scan kernel (K12): the port's
``models.ssm.ssd_chunked``, as ``repro/kernels/ssd_scan/ref.py``
delegates to the reference's."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.ssm import ssd_chunked


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32, dt (B,S,H) f32 softplus'ed, A (H,) negative,
    B/C (B,S,N) f32 -> (y (B,S,H,P), final_state (B,H,P,N))."""
    return ssd_chunked(x, dt, A, B, C, chunk)
