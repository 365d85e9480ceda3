"""Trace export: Chrome trace-event JSON (Perfetto-loadable), JSONL
event log, CSV summary — plus the schema validator the CI gate runs
(DESIGN.md §10).  The port's copy of ``repro.obs.export``: on the same
spans its documents and files are byte-identical to the reference's.

Chrome trace format: ``{"traceEvents": [...]}`` with complete-duration
events (``"ph": "X"``) — ``ts``/``dur`` in microseconds relative to the
tracer epoch, one ``tid`` lane per python thread (nesting inside a lane
is inferred by the viewer from containment, which matches the tracer's
per-thread span stacks exactly).  ``cat`` is the span name's first
dotted component (align/coreset/train/serve/pipeline), so Perfetto can
filter by stage.  Span attributes ride in ``args``.  Load at
https://ui.perfetto.dev or chrome://tracing.

``validate_chrome_trace`` re-checks everything a consumer relies on —
required keys, types, non-negative times, per-lane nesting (events on
one tid must nest or be disjoint; partial overlap means a corrupted
stack) — and raises ``TraceValidationError`` listing every finding.
``python -m repro_torch.obs.view`` exits non-zero on it, which is how CI
gates the uploaded artifact.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.obs.metrics import _nearest_rank
from repro_torch.obs.trace import Span, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "write_jsonl",
           "write_csv_summary", "summarize", "validate_chrome_trace",
           "TraceValidationError"]

_REQUIRED = ("name", "ph", "ts", "dur", "pid", "tid")


def _json_safe(v: Any) -> Union[int, float, str, bool]:
    """Span attrs may carry numpy scalars / tuples (mesh shapes): fold
    them to JSON-native scalars/strings."""
    if isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return "x".join(str(_json_safe(x)) for x in v)
    try:
        return v.item()          # numpy scalar
    except AttributeError:
        return str(v)


def chrome_trace(tracer: Tracer, *, pid: int = 1) -> Dict[str, Any]:
    """Tracer → Chrome trace-event document (pure dict; see module
    docstring for the format)."""
    events: List[Dict[str, Any]] = []
    tids: Dict[int, int] = {}
    for sp in tracer.finished():
        # compact thread lanes: first-seen order, main thread = 1
        lane = tids.setdefault(sp.tid, len(tids) + 1)
        events.append({
            "name": sp.name,
            "cat": sp.name.split(".", 1)[0],
            "ph": "X",
            "ts": (sp.t0 - tracer.epoch) * 1e6,
            "dur": sp.duration * 1e6,
            "pid": pid,
            "tid": lane,
            "args": {k: _json_safe(v) for k, v in sp.attrs.items()},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> Dict[str, Any]:
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def write_jsonl(tracer: Tracer, path: str) -> int:
    """One JSON object per finished span (seconds, absolute-epoch
    relative) — the machine-greppable event log."""
    spans = tracer.finished()
    with open(path, "w") as f:
        for sp in spans:
            f.write(json.dumps({
                "name": sp.name, "t0": sp.t0 - tracer.epoch,
                "dur": sp.duration, "sid": sp.sid, "parent": sp.parent,
                "depth": sp.depth,
                "attrs": {k: _json_safe(v) for k, v in sp.attrs.items()},
            }) + "\n")
    return len(spans)


def summarize(spans: Sequence[Span]) -> List[Dict[str, Any]]:
    """Per-name aggregate rows: count, total/mean/p50/p99/max seconds.
    Sorted by total descending — the per-stage breakdown table."""
    groups: Dict[str, List[float]] = {}
    for sp in spans:
        groups.setdefault(sp.name, []).append(sp.duration)
    rows = []
    for name, durs in groups.items():
        durs.sort()
        total = float(sum(durs))
        rows.append({
            "name": name, "count": len(durs), "total_s": total,
            "mean_s": total / len(durs),
            "p50_s": _nearest_rank(durs, 50),
            "p99_s": _nearest_rank(durs, 99),
            "max_s": durs[-1],
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def write_csv_summary(tracer: Tracer, path: str) -> List[Dict[str, Any]]:
    rows = summarize(tracer.finished())
    keys = ["name", "count", "total_s", "mean_s", "p50_s", "p99_s",
            "max_s"]
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(
                f"{r[k]:.6f}" if isinstance(r[k], float) else str(r[k])
                for k in keys) + "\n")
    return rows


# ------------------------------------------------------------ validation


class TraceValidationError(ValueError):
    """Raised by ``validate_chrome_trace``; ``findings`` lists every
    schema violation found (not just the first)."""

    def __init__(self, findings: List[str]):
        self.findings = findings
        super().__init__(
            f"{len(findings)} malformed span(s): " + "; ".join(findings[:5])
            + ("; ..." if len(findings) > 5 else ""))


def validate_chrome_trace(doc: Any, *,
                          require_cats: Sequence[str] = ()) -> int:
    """Check a Chrome trace-event document's schema; returns the event
    count, raises ``TraceValidationError`` on any finding.

    ``require_cats`` additionally demands at least one event per named
    category — how CI asserts the e2e artifact really contains all four
    stages."""
    findings: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise TraceValidationError(
            ["top level must be a dict with a 'traceEvents' list"])
    events = doc["traceEvents"]
    lanes: Dict[Any, List[tuple]] = {}
    cats = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            findings.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            findings.append(f"event {i}: missing {missing}")
            continue
        if not isinstance(ev["name"], str) or not ev["name"]:
            findings.append(f"event {i}: empty name")
        if ev["ph"] != "X":
            findings.append(f"event {i} ({ev.get('name')}): ph "
                            f"{ev['ph']!r} != 'X'")
            continue
        ts, dur = ev["ts"], ev["dur"]
        if not isinstance(ts, (int, float)) or ts < 0:
            findings.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            findings.append(f"event {i} ({ev['name']}): bad dur {dur!r}")
            continue
        if "args" in ev and not isinstance(ev["args"], dict):
            findings.append(f"event {i} ({ev['name']}): args not a dict")
        cats.add(ev.get("cat", ev["name"].split(".", 1)[0]))
        lanes.setdefault((ev["pid"], ev["tid"]), []).append(
            (ts, ts + dur, ev["name"]))
    # per-lane nesting: sorted by (start, -end), a stack of open
    # intervals must always contain the next one or be disjoint from it
    for lane, ivs in lanes.items():
        ivs.sort(key=lambda x: (x[0], -x[1]))
        stack: List[tuple] = []
        for t0, t1, name in ivs:
            while stack and stack[-1][1] <= t0:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                findings.append(
                    f"lane {lane}: span '{name}' [{t0:.1f}, {t1:.1f}] "
                    f"partially overlaps '{stack[-1][2]}' "
                    f"[{stack[-1][0]:.1f}, {stack[-1][1]:.1f}]")
                continue
            stack.append((t0, t1, name))
    for cat in require_cats:
        if cat not in cats:
            findings.append(f"required stage category {cat!r} has no "
                            f"spans")
    if findings:
        raise TraceValidationError(findings)
    return len(events)
