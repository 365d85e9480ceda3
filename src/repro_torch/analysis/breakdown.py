"""Per-op / per-shape cost breakdown of an op table (the counterpart of
``repro.analysis.breakdown``): the two tables the reference prints of an
HLO dump, top byte movers and top FLOP ops, from the port's op table
(``repro_torch.analysis.op_cost``), keyed ``op -> dtype[shape]`` of the
op's first output as the reference keys ``opcode -> dtype[shape]``.

    PYTHONPATH=src python -m repro_torch.analysis.breakdown <ops.jsonl> [N]
"""
from __future__ import annotations

import sys
from collections import Counter
from typing import Dict, Iterable, Tuple

from repro_torch.analysis.op_cost import load_table


def _key(r: Dict) -> str:
    shape = (r["outputs"] or r["inputs"] or [[]])[0]
    return f"{r['op']} -> {r['dtype']}[{','.join(str(d) for d in shape)}]"


def breakdown(records: Iterable[Dict]) -> Tuple[Counter, Counter]:
    """(bytes by key, FLOPs by key), each record weighted by its
    count."""
    by_bytes, by_flops = Counter(), Counter()
    for r in records:
        key = _key(r)
        by_bytes[key] += r["bytes"] * r["count"]
        if r["flops"]:
            by_flops[key] += r["flops"] * r["count"]
    return by_bytes, by_flops


def main(argv=None) -> int:
    """Exit 2 on an unreadable file, 1 when it is not an op table, 0 with
    the tables printed."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.breakdown",
        description="per-op/per-shape byte and flop breakdown of an op "
                    "table (JSONL)")
    ap.add_argument("ops", help="path to an op table (op_costs, "
                                "launch/dryrun --save-ops)")
    ap.add_argument("top", nargs="?", type=int, default=15,
                    help="rows per table (default 15)")
    args = ap.parse_args(argv)
    records, rc = load_table(args.ops)
    if rc:
        return rc
    by_bytes, by_flops = breakdown(records)
    print("== top byte movers (GB, trip-weighted) ==")
    for k, v in by_bytes.most_common(args.top):
        print(f"{v/1e9:10.1f}  {k}")
    print("\n== top flop ops (GFLOP) ==")
    for k, v in by_flops.most_common(args.top):
        print(f"{v/1e9:10.1f}  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
