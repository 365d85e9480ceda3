"""``BENCHMARK.json`` against the benchmark's contract: the files each
entry names, the characters of names and units, which metrics each cell
reports, and the time a full measurement of 24 cells may take."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.harness.manifest import PERFBENCH, ROOT, cell, load_manifest

MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_run_seconds_fit_a_full_check():
    """A full check of 24 cells: 2 + 14 × 24 runs of run_seconds + 60,
    2 × 90 s a cell to compile and 1,200 spare, within 43,200 s."""
    t = MANIFEST["run_seconds"]
    assert 1 <= t <= 51
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert ONE_LINE.match(entry[key]), entry[key]
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_exist(name):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert entry["chips"] == 1
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    c = cell(name)
    assert (PERFBENCH / "drivers" / f"{c.mix['driver']}.py").exists()
    for m in c.per_layer:
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").exists()
    assert c.limits, "every cell compares something"


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_its_metrics_move(name):
    c = cell(name)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in MANIFEST["per_layer"]:
        if name in m.get("workloads", [name]):
            assert m["moves"] in e2e, (m["name"], name)


def test_configs():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        path = ROOT / c["file"]
        assert path.exists()
        body = json.loads(path.read_text())
        assert body["name"] == c["name"]
        assert c["reduced"] == body["reduced"] == []
        assert c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_metrics():
    layers = {}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        layers.setdefault(m["layer"], set()).add(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert {"alignment", "coreset", "training", "evaluation",
            "model step", "kernels", "device"} <= set(layers)
