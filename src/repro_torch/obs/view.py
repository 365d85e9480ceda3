"""Trace artifact summarizer/validator CLI (DESIGN.md §10): the port's
copy of ``repro.obs.view`` (stdlib only; the same output and exit codes).

    python -m repro_torch.obs.view experiments/bench/pipeline_trace.json
    python -m repro_torch.obs.view trace.json \\
        --require align,coreset,train,serve

Loads a Chrome trace-event JSON (the ``obs.export.write_chrome_trace``
artifact), validates the span schema (``validate_chrome_trace`` — exit
1 on malformed spans or a missing required stage category), and prints
the per-category and per-span-name breakdown the artifact encodes.  CI
runs this against the uploaded e2e trace as part of the contract-gate
step, so a malformed artifact fails the build, not the reader.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.obs.export import TraceValidationError, validate_chrome_trace
from repro_torch.obs.metrics import _nearest_rank


def _rows(events: List[Dict[str, Any]], key) -> List[Dict[str, Any]]:
    groups: Dict[str, List[float]] = {}
    for ev in events:
        groups.setdefault(key(ev), []).append(ev["dur"] / 1e6)
    rows = []
    for name, durs in groups.items():
        durs.sort()
        rows.append({"name": name, "count": len(durs),
                     "total_s": float(sum(durs)),
                     "p50_s": _nearest_rank(durs, 50),
                     "p99_s": _nearest_rank(durs, 99)})
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def _table(rows: List[Dict[str, Any]], title: str) -> None:
    print(f"\n{title}")
    hdr = ["name", "count", "total_s", "p50_s", "p99_s"]
    fmt = lambda r: [r["name"], str(r["count"]), f"{r['total_s']:.4f}",
                     f"{r['p50_s']:.4f}", f"{r['p99_s']:.4f}"]
    widths = [max(len(h), *(len(fmt(r)[i]) for r in rows))
              for i, h in enumerate(hdr)] if rows else [len(h) for h in hdr]
    print("  " + " | ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for r in rows:
        print("  " + " | ".join(c.ljust(w)
                                for c, w in zip(fmt(r), widths)))


def view(path: str, require_cats: List[str] = ()) -> int:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"obs.view: cannot load {path}: {e}", file=sys.stderr)
        return 1
    try:
        n = validate_chrome_trace(doc, require_cats=require_cats)
    except TraceValidationError as e:
        print(f"obs.view: INVALID trace {path}:", file=sys.stderr)
        for finding in e.findings:
            print(f"  - {finding}", file=sys.stderr)
        return 1
    events = doc["traceEvents"]
    lanes = {(ev["pid"], ev["tid"]) for ev in events}
    span_s = max((ev["ts"] + ev["dur"] for ev in events), default=0.0) / 1e6
    print(f"{path}: {n} spans, {len(lanes)} lane(s), "
          f"timeline {span_s:.4f}s — schema OK")
    _table(_rows(events, lambda ev: ev.get(
        "cat", ev["name"].split(".", 1)[0])), "by stage category:")
    _table(_rows(events, lambda ev: ev["name"]), "by span name:")
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(
        description="validate + summarize a Chrome-trace artifact")
    ap.add_argument("trace", help="path to the trace-event JSON")
    ap.add_argument("--require", default="",
                    help="comma-separated stage categories that must "
                         "each have at least one span")
    args = ap.parse_args()
    cats = [c for c in args.require.split(",") if c]
    sys.exit(view(args.trace, cats))


if __name__ == "__main__":
    main()
