"""Analysis helpers of the port: the roofline model (``roofline``), the
engine-contract gate (``check``) and its layers, and the per-op cost
tools.

The reference reads its programs' XLA text; the port has none, and
these take the place of its parsers:
- ``repro/analysis/hlo.py`` (collectives and their bytes in an HLO):
  ``sharding.COLLECTIVES``' counts per kind, kept by the collectives
  themselves;
- ``census.py`` (a jaxpr walk): ``census``, one run of a program under a
  ``TorchDispatchMode``;
- ``hlo_cost.py`` and ``breakdown.py`` (HLO costs): ``op_cost``, the op
  table of one call on fake tensors, and ``breakdown``, its two tables
  (both runnable with ``python -m``, so not imported here);
- ``blocks.py`` (Pallas VMEM footprints): ``blocks``, the kernels'
  shared memory a CTA;
- ``lint.py`` and ``contracts.py``: ``lint`` (the same mechanics, the
  JAX rules in PyTorch terms) and ``contracts`` (a copy).
"""
from repro_torch.analysis.blocks import BlockReport, smem_report
from repro_torch.analysis.census import (CENSUS_FIELDS, ProgramCensus,
                                         census_program)
from repro_torch.analysis.contracts import (diff_rows, load_contract,
                                            rows_to_doc, write_contract)
from repro_torch.analysis.lint import (Finding, lint_paths, lint_source,
                                       split_baselined)
from repro_torch.analysis.roofline import (HW, Hardware, model_flops_for,
                                           roofline_terms)

__all__ = ["HW", "Hardware", "model_flops_for", "roofline_terms",
           "BlockReport", "smem_report", "CENSUS_FIELDS", "ProgramCensus",
           "census_program", "diff_rows", "load_contract", "rows_to_doc",
           "write_contract", "Finding", "lint_paths", "lint_source",
           "split_baselined"]
