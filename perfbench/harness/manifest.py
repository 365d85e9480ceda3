"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.
Everything that belongs to one of them sits in a file of its own:

- ``perfbench/configs/<config>.json``: the configuration (the file the
  manifest's ``configs`` entry names);
- ``perfbench/mixes/<traffic>.json``: the mix, with the driver it runs
  (``perfbench/drivers/<driver>.py``);
- ``perfbench/limits/<cell>.json``: the limit of each number the cell's
  comparison prints;
- ``perfbench/metrics/<metric>.py``: the reader of a per-layer metric;
- ``perfbench/rooflines/<kernel>.py``: a kernel's bytes and operations.

So a later cell, configuration, mix or metric needs new files and
entries, and no edit of a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, manifest: dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and the
    metrics it reports (those whose ``workloads`` list it, or that have
    none)."""
    manifest = manifest or load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    config = _json(root / cfg_entry["file"])
    mix = _json(PERFBENCH / "mixes" / f"{entry['traffic']}.json")
    limits = _json(PERFBENCH / "limits" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = [m["name"] for m in e2e]
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name]) and m["moves"] in names]
    return Cell(name=name, config=config, mix=mix, limits=limits,
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots,
    so the file is loaded by path)."""
    path = PERFBENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod
