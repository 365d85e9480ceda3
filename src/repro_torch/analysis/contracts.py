"""Shared contract plumbing for the CI gates: a copy of
``repro.analysis.contracts``.

``repro_torch.analysis.check`` pins the counters of the port's engine
programs, read by running them once under the census
(``repro_torch.analysis.census``); the reference's dynamic contract
(``benchmarks/check_contract.py``) pins counters measured by running its
engines.  The gate mechanics are the same for both: a JSON document of
keyed counter rows, an observed dict of the same shape, and a
field-by-field diff that fails on drift in either direction (changed
value, missing row, row not covered).  This module is that mechanism,
letter for letter the reference's, so the port's contract reports and
matches as the reference's does.

Contract documents are ``{"rows": [{<key fields...>, "counters": {...}}],
...metadata}``; in memory they are ``{key_tuple: counters_dict}``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

Key = Tuple[str, ...]
Rows = Dict[Key, Dict[str, object]]


def diff_rows(contract: Rows, got: Rows, source: str,
              failures: List[str]) -> None:
    """Append one human-readable failure line per drifted field, missing
    row, or uncovered row.  Symmetric: observed rows absent from the
    contract fail too (a silently-added engine config is itself drift)."""
    for key, expect in contract.items():
        if key not in got:
            failures.append(f"{key}: row missing from {source}")
            continue
        for field, want in expect.items():
            have = got[key].get(field)
            if have != want:
                failures.append(
                    f"{key}: {field} = {have!r}, contract pins {want!r}")
    for key in got:
        if key not in contract:
            failures.append(f"{key}: row not covered by the contract — "
                            f"regenerate with --write if intended")


def load_contract(path: str | Path, key_fields: Sequence[str],
                  rows_key: str = "rows") -> Rows:
    """Read a contract document's ``rows_key`` list into keyed form."""
    with open(path) as f:
        doc = json.load(f)
    return {tuple(str(r[k]) for k in key_fields): r["counters"]
            for r in doc.get(rows_key, [])}


def rows_to_doc(rows: Rows, key_fields: Sequence[str]
                ) -> List[Dict[str, object]]:
    """Keyed rows back to the JSON list form, sorted for stable diffs."""
    return [{**dict(zip(key_fields, key)), "counters": counters}
            for key, counters in sorted(rows.items())]


def write_contract(path: str | Path, doc: Dict[str, object]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
