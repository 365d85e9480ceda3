"""Analysis helpers of the port: the roofline model (``roofline``).

The reference's package also re-exports its HLO parsers
(``repro/analysis/hlo.py``); the port has no HLO, and those are not
ported here (ROADMAP.md, queue 8).
"""
from repro_torch.analysis.roofline import (HW, Hardware, model_flops_for,
                                           roofline_terms)

__all__ = ["HW", "Hardware", "model_flops_for", "roofline_terms"]
