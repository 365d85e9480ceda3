"""``repro_torch.obs.export`` and ``repro_torch.obs.view`` against
``repro.obs.export`` and ``repro.obs.view``: on the same spans, the
Chrome trace document, its file, the JSONL log and the CSV summary are
byte-identical; the validator gives the same verdict (the event count,
or the same findings and message) on good and malformed documents; the
view CLI prints the same standard output and error and exits with the
same code.

The spans are made on fixed clocks in both packages' ``Tracer``s (each
span's start and end set by hand, the epoch fixed), never read from a
live clock, so both sides export the same numbers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.obs import export as ref_export
from repro.obs import trace as ref_trace
from repro_torch.obs import export, trace

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

#: (name, t0, t1, parent index or -1, thread, attrs): a pipeline on two
#: threads, nested three deep, with the attribute kinds spans carry
#: (ints, floats, strings, bools, mesh tuples, numpy scalars)
SPANS = [
    ("pipeline.run", 0.5, 4.25, -1, 11, {"variant": "treecss"}),
    ("align.step", 0.625, 1.125, 0, 11,
     {"comm_bytes": 4096, "mesh": (2, 4), "ok": True}),
    ("align.dispatch", 0.75, 0.875, 1, 11, {"rows": np.int64(131072)}),
    ("coreset.fit", 1.25, 2.0, 0, 11,
     {"n": np.float32(0.25), "clients": [3, 1]}),
    ("train.step", 2.125, 2.75, 0, 11, {"loss": 0.6931471805599453}),
    ("train.step", 2.75, 3.5, 0, 11, {"loss": 0.5}),
    ("serve.step", 3.625, 4.0, 0, 11, {"blocks": 59}),
    ("serve.dispatch", 1.0, 3.0, -1, 22, {"worker": "thread-2"}),
    ("serve.dispatch", 3.0, 3.0, -1, 22, {}),
]
EPOCH = 0.25


def _tracer(mod):
    """A ``Tracer`` of ``mod`` (either package's ``obs.trace``) holding
    ``SPANS`` on fixed clocks."""
    tracer = mod.Tracer()
    tracer.epoch = EPOCH
    spans = []
    for sid, (name, t0, t1, parent, tid, attrs) in enumerate(SPANS):
        depth = 0 if parent < 0 else spans[parent].depth + 1
        spans.append(mod.Span(name=name, t0=t0, t1=t1, sid=sid,
                              parent=parent, depth=depth, tid=tid,
                              attrs=dict(attrs)))
    # finished in exit order, not start order: finished() sorts
    tracer.spans = sorted(spans, key=lambda s: (s.t1, -s.depth))
    return tracer


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_documents_and_files_are_byte_identical(tmp_path):
    ours, ref = _tracer(trace), _tracer(ref_trace)
    doc = export.chrome_trace(ours)
    assert doc == ref_export.chrome_trace(ref)
    assert json.dumps(doc) == json.dumps(ref_export.chrome_trace(ref))
    assert export.chrome_trace(ours, pid=7) == ref_export.chrome_trace(
        ref, pid=7)
    a, b = tmp_path / "ours", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    assert export.write_chrome_trace(ours, str(a / "t.json")) == \
        ref_export.write_chrome_trace(ref, str(b / "t.json"))
    assert export.write_jsonl(ours, str(a / "t.jsonl")) == \
        ref_export.write_jsonl(ref, str(b / "t.jsonl")) == len(SPANS)
    assert export.write_csv_summary(ours, str(a / "t.csv")) == \
        ref_export.write_csv_summary(ref, str(b / "t.csv"))
    for name in ("t.json", "t.jsonl", "t.csv"):
        assert _read(a / name) == _read(b / name), name
    assert export.summarize(ours.finished()) == ref_export.summarize(
        ref.finished())
    # lanes: the main thread's spans on tid 1, the second thread's on 2
    assert sorted({e["tid"] for e in doc["traceEvents"]}) == [1, 2]
    assert export.validate_chrome_trace(
        doc, require_cats=("align", "coreset", "train", "serve")) == \
        len(SPANS)


def _event(name="x", ph="X", ts=0, dur=0, pid=1, tid=1, **extra):
    return dict(name=name, ph=ph, ts=ts, dur=dur, pid=pid, tid=tid, **extra)


#: (document, required categories): the reference's own rejection cases
#: (tests/test_obs.py) and one of each other finding the validator makes
CASES = [
    ({"events": []}, ()),
    ([], ()),
    ({"traceEvents": {}}, ()),
    ({"traceEvents": [_event(ph="B")]}, ()),
    ({"traceEvents": [_event(ts=-5)]}, ()),
    ({"traceEvents": [_event(dur=-1)]}, ()),
    ({"traceEvents": [_event(ts="0")]}, ()),
    ({"traceEvents": [_event(name="")]}, ()),
    ({"traceEvents": [_event(args=[1])]}, ()),
    ({"traceEvents": [{"name": "x"}]}, ()),
    ({"traceEvents": [7, _event()]}, ()),
    ({"traceEvents": [_event("a", ts=0, dur=10),
                      _event("b", ts=5, dur=10)]}, ()),
    ({"traceEvents": [_event("a", ts=0, dur=10),
                      _event("b", ts=5, dur=10, tid=2)]}, ()),
    ({"traceEvents": [_event("align.a", ts=0, dur=10),
                      _event("align.b", ts=2, dur=3)]}, ("align",)),
    ({"traceEvents": [_event("align.a")]}, ("align", "serve")),
    ({"traceEvents": [_event(f"s{i}", ph="E") for i in range(8)]}, ()),
    ({"traceEvents": []}, ("train",)),
]


def _verdict(fn, exc, doc, cats):
    try:
        return ("ok", fn(doc, require_cats=cats))
    except exc as e:
        return ("error", e.findings, str(e))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_validator_verdicts_match_reference(case):
    doc, cats = CASES[case]
    got = _verdict(export.validate_chrome_trace, export.TraceValidationError,
                   doc, cats)
    want = _verdict(ref_export.validate_chrome_trace,
                    ref_export.TraceValidationError, doc, cats)
    assert got == want


def _cli(module, args, cwd):
    proc = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout, proc.stderr


#: (file written, the CLI's arguments after the path)
VIEWS = [("good", ["--require", "align,coreset,train,serve"]),
         ("good", []),
         ("good", ["--require", "align,nonexistent"]),
         ("overlap", []),
         ("missing_keys", []),
         ("not_json", []),
         ("absent", [])]


def test_view_cli_matches_reference(tmp_path):
    """``python -m repro_torch.obs.view PATH [--require ...]`` prints
    what ``python -m repro.obs.view`` prints, on both streams, and exits
    with its code: 0 on a valid trace, 1 on a malformed one, a missing
    category, a file that is no JSON or no file."""
    export.write_chrome_trace(_tracer(trace), str(tmp_path / "good"))
    with open(tmp_path / "overlap", "w") as f:
        json.dump(CASES[11][0], f)
    with open(tmp_path / "missing_keys", "w") as f:
        json.dump({"traceEvents": [{"name": "x"}]}, f)
    with open(tmp_path / "not_json", "w") as f:
        f.write("{\"traceEvents\": [")
    codes = []
    for name, args in VIEWS:
        got = _cli("repro_torch.obs.view", [name] + args, str(tmp_path))
        want = _cli("repro.obs.view", [name] + args, str(tmp_path))
        assert got == want, (name, args)
        codes.append(got[0])
    assert codes == [0, 0, 1, 1, 1, 1, 1]
    out = _cli("repro_torch.obs.view", ["good"], str(tmp_path))[1]
    assert "schema OK" in out and "by span name:" in out


def test_view_function_matches_reference(tmp_path, capsys):
    """``view`` called in the process: the same return code and output
    as the reference's (the CLI's ``main`` exits with it)."""
    from repro.obs.view import view as ref_view
    from repro_torch.obs.view import view
    path = str(tmp_path / "t.json")
    export.write_chrome_trace(_tracer(trace), path)
    for cats in ((), ("serve",), ("missing",)):
        got = (view(path, list(cats)), capsys.readouterr())
        want = (ref_view(path, list(cats)), capsys.readouterr())
        assert got == want
