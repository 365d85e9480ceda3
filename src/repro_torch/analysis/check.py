"""Engine-contract gate of the port (the port of ``repro.analysis.check``).

    python -m repro_torch.analysis.check               # lint + census gate
    python -m repro_torch.analysis.check --write       # regenerate contract
    python -m repro_torch.analysis.check --lint-only --src PATH
    python -m repro_torch.analysis.check --census-only --census-csv out.csv

Two layers, as the reference's:

**Census** — every engine program is run once under the census
(``repro_torch.analysis.census``; the reference traces and lowers its
programs instead, never running them): the PSI dispatches
(``psi/engine``: the PRF launch over both sides of every pair, the merge,
``_oprf_single`` and the union merge, b = 8 pairs at P = 2,048) on meshes
``1`` and ``8``;
``train_scan``'s epochs (fd (3, 4, 5), n 256, bs 64; lr on the plain
bottom, mlp on the kernel route, as the reference pairs them; int8 and
fp8 wires) on meshes ``1``, ``8``, ``2x4`` and ``4x2``;
``make_score_step``'s scoring step on ``1``; ``kmeans_fit`` (256 × 8,
k 4, 5 iterations) on ``1``.  A PSI program is the dispatch, what runs
between the host's transfers: on a mesh each rank runs it on its block
of pairs, and the round's all-gather of the intersections stands where
the reference's host reads a sharded output.  The mesh rows run on ONE
spawned gloo world of 8 ranks (``launch.mesh.run_ranks``), regrouped
into the three meshes.  The counters are pinned in
``static_contract.json`` beside this module, every census field but the
kernel launches, which depend on the device (zero on the CPU, where the
plain versions run; ``chip_smoke.py --only analysis`` holds them on the
card).  On top of the pinned values, HARD invariants are enforced even
under ``--write``:

- train: zero host syncs inside a step and exactly one a round outside
  them (the epoch's one sync), zero f64, and exactly ONE all-gather a
  step (and one reduce-scatter, its transpose in the backward) if and
  only if the mesh has a model axis (the paper's client→server
  activation send); for the quantized variants (int8,
  fp8) ALSO that a step's all-gather moves at most 0.3x the bytes of
  its f32 twin's;
- PSI / scoring / k-means programs: zero collectives, zero host syncs,
  zero f64;
- every kernel's shared memory a CTA within its limit
  (``repro_torch.analysis.blocks``).

**Lint** — the port's AST rules over ``src/repro_torch``
(``repro_torch.analysis.lint``): host syncs in step bodies, call-time
``torch.compile``, unbounded ``lru_cache``, reassociating sums in
bitwise paths, config sprawl.  Findings are suppressed inline
(``# lint-ok: <rule>``) or accepted in ``lint_baseline.json``; anything
else fails the gate.

Exit status: 0 clean, 1 violations, 2 environment/usage errors (a
missing contract without ``--write`` among them, found before any
census).  ``--device`` places the programs: the card where there is
one, else the CPU.  ``--write`` stops after a failing lint (nothing
would be written).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
DEFAULT_CONTRACT = str(HERE / "static_contract.json")
DEFAULT_BASELINE = str(HERE / "lint_baseline.json")
DEFAULT_SRC = str(HERE.parent)

KEY = ("engine", "mesh")

# mesh name -> (data, model); model = 0 means the 1-D data mesh
MESH_SHAPES: Dict[str, Optional[Tuple[int, int]]] = {
    "1": None, "8": (8, 0), "2x4": (2, 4), "4x2": (4, 2)}
WORLD = 8

_PSI_MESHES = ("1", "8")
_TRAIN_MESHES = ("1", "8", "2x4", "4x2")
#: census fields that depend on the device, not pinned in the contract
DEVICE_FIELDS = ("kernel_launches", "kernel_launches_in_loop")

# (tag, model, bottom impl, wire): "ref" the plain bottom, "kernel" the
# kernel route (which the CPU takes as the plain version)
TRAIN_VARIANTS = (("lr", "lr", "ref", None), ("mlp", "mlp", "kernel", None),
                  ("lr-int8", "lr", "ref", "int8"),
                  ("mlp-int8", "mlp", "kernel", "int8"),
                  ("lr-fp8", "lr", "ref", "fp8"))
SERVE_VARIANTS = TRAIN_VARIANTS[:4]
FEATURE_DIMS = (3, 4, 5)
TRAIN_N, TRAIN_BS = 256, 64
PSI_PAIRS, PSI_P = 8, 2048
KMEANS = dict(n=256, d=8, k=4, iters=5)

Program = Tuple[str, Callable, Dict[str, Any]]


def _impl(impl: str) -> Optional[str]:
    """The kernel route resolves by device (the plain version on the
    CPU); the plain route is "ref" everywhere."""
    return None if impl == "kernel" else impl


# -------------------------------------------------------- program matrix


def psi_inputs(device, seed: int = 0):
    """The PSI programs' inputs: b pairs of ids at P, their counts and
    seeds, and the sorted key rows of a merge."""
    import numpy as np
    import torch
    from repro_torch.kernels.sorted_intersect.ops import PAD_A64, PAD_B64
    from repro_torch.psi.engine import _host_key_row

    rng = np.random.default_rng(seed)
    b, p = PSI_PAIRS, PSI_P
    ids = rng.choice(1 << 40, size=(2 * b, p), replace=False)
    r_ids, s_ids = ids[:b].copy(), ids[b:].copy()
    s_ids[:, : p // 2] = r_ids[:, : p // 2]          # half in common
    n = np.full((b,), p, np.int64)
    seeds = rng.integers(0, 1 << 32, (b, 2), dtype=np.int64)
    tags = rng.integers(0, 1 << 62, (2 * b, p), dtype=np.int64)
    a = np.stack([_host_key_row(np.sort(t.astype(np.uint64)), 1, PAD_A64,
                                p) for t in tags[:b]])
    bk = np.stack([_host_key_row(np.sort(t.astype(np.uint64)), 0, PAD_B64,
                                 p) for t in tags[b:]])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dict(r_ids=t(r_ids), s_ids=t(s_ids), r_n=t(n), s_n=t(n),
                seeds=t(seeds), a=t(a), b=t(bk))


def psi_programs(device, mesh=None) -> Iterator[Program]:
    """(engine, fn, kwargs) per PSI dispatch, on this rank's block of
    pairs where ``mesh`` shards them (as ``oprf_round`` splits them)."""
    import torch
    from repro_torch.config import resolve_impl
    from repro_torch.kernels.psi_prf.ops import prf_tags
    from repro_torch.kernels.sorted_intersect.ops import sorted_intersect
    from repro_torch.psi import engine
    from repro_torch.sharding import MeshAxis, my_rows, resolve_batch_mesh

    x = psi_inputs(device)
    impl = resolve_impl(None, torch.device(device))
    mesh, axis, _ = resolve_batch_mesh(mesh)
    if mesh is not None:
        mine = torch.from_numpy(my_rows(PSI_PAIRS, MeshAxis(mesh, axis)))
        x = {k: v[mine.to(v.device)].contiguous() for k, v in x.items()}
    # oprf_round's host-sort dispatches: one PRF launch over both sides of
    # every pair (the reference's two PRF calls), the merge's (sel, rank)
    # and union_merge's merged keys
    yield "psi.prf", lambda r, s, seeds: prf_tags(
        torch.cat([r, s]), torch.cat([seeds, seeds]), impl=impl), dict(
            r=x["r_ids"], s=x["s_ids"], seeds=x["seeds"])
    yield "psi.merge", lambda a, b: sorted_intersect(a, b, impl=impl)[:2], \
        dict(a=x["a"], b=x["b"])
    yield "psi.single", engine._oprf_single, dict(
        r_ids=x["r_ids"], r_n=x["r_n"], s_ids=x["s_ids"], s_n=x["s_n"],
        seeds=x["seeds"], impl=impl)
    yield "psi.union", lambda a, b: sorted_intersect(a, b, impl=impl)[2], \
        dict(a=x["a"], b=x["b"])


def train_partition(seed: int = 0):
    """n rows of fd (3, 4, 5) features and binary labels."""
    import numpy as np
    from repro_torch.data.vertical import partition_features

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRAIN_N, sum(FEATURE_DIMS))).astype(np.float32)
    y = (x[:, 0] + x[:, 5] - x[:, 9] > 0).astype(np.int64)
    return partition_features(x, y, len(FEATURE_DIMS),
                              proportions=FEATURE_DIMS)


def train_programs(device, mesh=None) -> Iterator[Program]:
    """(engine, loop program, kwargs) per ``train_scan`` variant; the
    program runs ``rounds`` epochs."""
    from repro_torch.config import EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.train.vfl import train_scan

    part = train_partition()
    for tag, model, impl, quant in TRAIN_VARIANTS:
        cfg = SplitNNConfig(model, 2, batch_size=TRAIN_BS)
        opts = EngineOptions(device=device, mesh=mesh,
                             bottom_impl=_impl(impl), quant=quant)

        def run(rounds, cfg=cfg, opts=opts):
            return train_scan(part, dataclasses.replace(
                cfg, max_epochs=rounds), options=opts)
        yield f"train.epoch.{tag}+{impl}", run, {}


def serve_programs(device) -> Iterator[Program]:
    """(engine, fn, kwargs) per scoring step (single device: serving
    shards by replication, not in-program collectives)."""
    import numpy as np
    import torch
    from repro_torch.core import splitnn as models
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.train.vfl import make_score_step

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(len(FEATURE_DIMS), 64, max(
        FEATURE_DIMS))).astype(np.float32)).to(device)
    for tag, model, impl, quant in SERVE_VARIANTS:
        cfg = SplitNNConfig(model, 2)
        params = models.init_splitnn(cfg, list(FEATURE_DIMS), device=device)
        packed, step = make_score_step(params, cfg, FEATURE_DIMS,
                                       bottom_impl=_impl(impl), quant=quant)
        yield f"serve.score.{tag}+{impl}", step, dict(packed=packed,
                                                      x_slab=x)


def kmeans_programs(device) -> Iterator[Program]:
    """(engine, loop program, kwargs) per k-means fit: ``rounds`` × 5
    Lloyd iterations, 5 steps a round."""
    import numpy as np
    import torch
    from repro_torch import rng as prng
    from repro_torch.core.kmeans import kmeans_fit

    pts = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, KMEANS["n"], KMEANS["d"])).astype(np.float32)).to(device)
    keys = prng.PRNGKey(0)[None]
    for impl in ("ref", "kernel"):
        def run(rounds, impl=impl):
            return kmeans_fit(keys, pts, KMEANS["k"],
                              iters=KMEANS["iters"] * rounds,
                              impl=_impl(impl))
        yield f"kmeans.fit+{impl}", run, {}


# ---------------------------------------------------------------- census


def census_rows(device, meshes: Dict[str, Any], *, sync_debug=False
                ) -> Dict[Tuple[str, str], Any]:
    """{(engine, mesh): ProgramCensus} of every program on ``meshes``
    (mesh name -> mesh, ``None`` for ``1``) this process can run."""
    from repro_torch.analysis.census import census_program

    out: Dict[Tuple[str, str], Any] = {}
    for name in _PSI_MESHES:
        if name in meshes:
            for engine, fn, kw in psi_programs(device, meshes[name]):
                out[engine, name] = census_program(
                    fn, sync_debug=sync_debug, **kw)
    for name in _TRAIN_MESHES:
        if name in meshes:
            for engine, fn, kw in train_programs(device, meshes[name]):
                out[engine, name] = census_program(
                    fn, steps=-(-TRAIN_N // TRAIN_BS),
                    sync_debug=sync_debug, **kw)
    if "1" in meshes:
        for engine, fn, kw in serve_programs(device):
            out[engine, "1"] = census_program(fn, sync_debug=sync_debug,
                                              **kw)
        for engine, fn, kw in kmeans_programs(device):
            out[engine, "1"] = census_program(fn, steps=KMEANS["iters"],
                                              sync_debug=sync_debug, **kw)
    return out


def mesh_rank(device) -> Dict[str, Dict[str, Any]]:
    """One rank of the 8-rank world: the census of the mesh rows on
    ``8``, ``2x4`` and ``4x2`` (rank 0's, after every rank agreed)."""
    from repro_torch.launch.mesh import make_data_mesh, make_train_mesh

    meshes = {"8": make_data_mesh(WORLD), "2x4": make_train_mesh(2, 4),
              "4x2": make_train_mesh(4, 2)}
    rows = census_rows(device, meshes)
    return {f"{e}@{m}": dataclasses.asdict(c) for (e, m), c in rows.items()}


def run_census(device) -> Tuple[Dict[Tuple[str, str], Dict[str, Any]],
                                List[str]]:
    """Every program's counters plus every HARD-invariant violation: the
    single-device rows here, the mesh rows on the 8-rank world."""
    from repro_torch.analysis.census import ProgramCensus
    from repro_torch.launch.mesh import run_ranks

    census = census_rows(device, {"1": None})
    ranks = run_ranks(mesh_rank, WORLD, (), device=device, timeout=900.0)
    for key, c in ranks[0].items():
        engine, mesh = key.split("@")
        census[engine, mesh] = ProgramCensus(**c)
    return ({k: c.counters() for k, c in census.items()},
            hard_invariants(census))


def hard_invariants(census: Dict[Tuple[str, str], Any]) -> List[str]:
    """The violations of the invariants the gate enforces (module
    docstring) in ``census`` ({(engine, mesh): ProgramCensus})."""
    hard: List[str] = []
    ag_bytes: Dict[Tuple[str, str], Dict[str, int]] = {}
    for key in sorted(census):
        c = census[key]
        engine, mesh = key
        if c.f64_values or c.f64_widenings:
            hard.append(f"{key}: f64 in the program ({c.f64_values} "
                        f"values, {c.f64_widenings} widenings)")
        if not engine.startswith("train."):
            if c.total_collectives():
                hard.append(f"{key}: program contains collectives "
                            f"({c.collectives}) — must be zero")
            if c.host_syncs or c.host_syncs_in_loop:
                hard.append(f"{key}: {c.host_syncs} host sync(s) in the "
                            "program — zero-host-sync contract")
            continue
        if c.host_syncs_in_loop:
            hard.append(f"{key}: {c.host_syncs_in_loop} host sync(s) "
                        "inside a train step — one-sync-per-epoch contract")
        if c.round_syncs != 1:
            hard.append(f"{key}: {c.round_syncs} host sync(s) an epoch "
                        "outside the steps, contract requires exactly 1")
        has_model = bool(MESH_SHAPES[mesh] and MESH_SHAPES[mesh][1])
        want = 1 if has_model else 0
        for kind in ("all_gather", "reduce_scatter"):
            n = c.collectives_in_loop.get(kind, 0)
            if n != want:
                why = ("one activation send per step over model, and its "
                       "transpose" if want else "none without a model axis")
                hard.append(f"{key}: {n} {kind}(s) a train step, contract "
                            f"requires exactly {want} ({why})")
        if has_model:
            name, impl = engine.split(".", 2)[2].split("+")
            model, _, quant = name.partition("-")
            ag_bytes.setdefault((f"{model}+{impl}", mesh), {})[
                quant or "f32"] = c.collective_bytes_in_loop.get(
                    "all_gather", 0)
    # payload-shrink gate: on every model-axis mesh a quantized step's
    # all-gather moves at most 0.3x the bytes of its f32 twin's
    for (base, mesh), by_quant in sorted(ag_bytes.items()):
        f32 = by_quant.get("f32", 0)
        for quant in sorted(q for q in by_quant if q != "f32"):
            b = by_quant[quant]
            if not f32:
                hard.append(f"train.epoch.{base}@{mesh}: no f32 twin to "
                            f"ratio quant={quant} against")
            elif b > 0.3 * f32:
                hard.append(f"train.epoch.{base}@{mesh}: quant={quant} "
                            f"all_gather payload {b}B > 0.3x f32 twin "
                            f"({f32}B) — wire did not narrow")
    return hard


def run_blocks() -> Tuple[List[Dict[str, Any]], List[str]]:
    from repro_torch.analysis.blocks import smem_report
    reports = [r.as_row() for r in smem_report()]
    fails = [f"smem: {r['kernel']} [{r['shape']}]: {r['smem_bytes']}B a "
             f"CTA exceeds its {r['limit']}B limit"
             for r in reports if not r["ok"]]
    return reports, fails


def run_lint(src: str, baseline_path: str):
    from repro_torch.analysis.lint import (iter_source_files, lint_paths,
                                           load_baseline, split_baselined)
    root = Path(src)
    if not root.exists():
        return None, [f"lint: source path {src!r} does not exist"]
    findings = lint_paths(iter_source_files(root))
    baseline = load_baseline(Path(baseline_path))
    new, accepted = split_baselined(findings, baseline)
    fails = [f.render() for f in new]
    return {"new": [f.as_dict() for f in new],
            "accepted": [f.as_dict() for f in accepted]}, fails


def pinned(rows: Dict[Tuple[str, str], Dict[str, Any]]
           ) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """The rows' contract fields (every census field but the device's)."""
    return {k: {f: v for f, v in c.items() if f not in DEVICE_FIELDS}
            for k, c in rows.items()}


def _cell(value) -> str:
    if isinstance(value, dict):
        return ";".join(f"{k}={v}" for k, v in value.items())
    if isinstance(value, list):
        return ";".join(str(x) for x in value)
    return str(value)


def write_census_csv(rows, path: str) -> None:
    """The census counters as CSV: one row a program, ``KEY`` then
    ``CENSUS_FIELDS``; a dict field as ``name=n;name=n``."""
    from repro_torch.analysis.census import CENSUS_FIELDS
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(list(KEY) + list(CENSUS_FIELDS))
        for key in sorted(rows):
            wr.writerow(list(key) + [_cell(rows[key][c])
                                     for c in CENSUS_FIELDS])


def read_census_csv(path: str) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """``write_census_csv``'s rows back."""
    from repro_torch.analysis.census import CENSUS_FIELDS
    dict_fields = ("kernel_launches", "kernel_launches_in_loop")
    out = {}
    with open(path, newline="") as f:
        rd = csv.reader(f)
        header = next(rd)
        if header != list(KEY) + list(CENSUS_FIELDS):
            raise ValueError(f"{path}: not a census CSV")
        for row in rd:
            vals = dict(zip(CENSUS_FIELDS, row[len(KEY):]))
            out[tuple(row[:len(KEY)])] = {
                f: ({k: int(v) for k, v in (kv.split("=") for kv in
                                            vals[f].split(";") if kv)}
                    if f in dict_fields else int(vals[f]))
                for f in CENSUS_FIELDS}
    return out


def _default_device() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.check",
        description="engine-contract gate: program census + the port's "
                    "AST lint")
    ap.add_argument("--contract", default=DEFAULT_CONTRACT)
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--src", default=DEFAULT_SRC,
                    help="source tree the lint layer audits")
    ap.add_argument("--write", action="store_true",
                    help="regenerate the contract from the current "
                         "programs (hard invariants and lint still gate)")
    ap.add_argument("--report", default=None,
                    help="write the full JSON report (census rows, lint "
                         "findings, shared-memory table) to this path")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--census-only", action="store_true")
    ap.add_argument("--census-csv", default=None,
                    help="also emit the census counters as CSV")
    ap.add_argument("--device", default=None,
                    help="where the programs run (default: the card "
                         "where there is one, else the CPU)")
    args = ap.parse_args(argv)
    if args.lint_only and args.census_only:
        print("error: --lint-only and --census-only are exclusive")
        return 2
    if not args.lint_only and not args.write and \
            not os.path.exists(args.contract):
        print(f"error: contract {args.contract} missing — generate it "
              "with --write")
        return 2

    failures: List[str] = []
    report: Dict[str, Any] = {}

    if not args.census_only:
        lint_report, lint_fails = run_lint(args.src, args.baseline)
        failures += lint_fails
        report["lint"] = lint_report
        n_ok = len(lint_report["accepted"]) if lint_report else 0
        print(f"lint: {len(lint_fails)} unbaselined finding(s), "
              f"{n_ok} baselined")
        if args.write and lint_fails:
            print("--write: lint fails; the contract is not rewritten")

    if not args.lint_only and not (args.write and failures):
        device = args.device or _default_device()
        try:
            rows, hard = run_census(device)
        except (RuntimeError, TimeoutError) as e:
            print(f"error: census failed to run: {e}")
            return 2
        print(f"census: {len(rows)} program(s) across "
              f"{len(MESH_SHAPES)} mesh shape(s) on {device}; "
              f"{len(hard)} hard-invariant violation(s)")
        failures += hard
        report["census"] = {f"{e}@{m}": c for (e, m), c in
                            sorted(rows.items())}

        blocks, block_fails = run_blocks()
        failures += block_fails
        report["smem"] = blocks
        print(f"smem: {len(blocks)} kernel/shape row(s), "
              f"{len(block_fails)} over their limit")

        if args.census_csv:
            write_census_csv(rows, args.census_csv)
            print(f"census csv -> {args.census_csv}")

        from repro_torch.analysis.contracts import (diff_rows, load_contract,
                                                    rows_to_doc,
                                                    write_contract)
        if args.write:
            doc = {
                "source": "python -m repro_torch.analysis.check --write",
                "note": "program-census invariants of the port's engines "
                        "(each program run once under the census); the "
                        "kernel launches depend on the device and are "
                        "held on the card by chip_smoke.py. Regenerate "
                        "after an intentional engine change.",
                "mesh_shapes": dict(MESH_SHAPES),
                "rows": rows_to_doc(pinned(rows), KEY),
            }
            if not failures:
                write_contract(args.contract, doc)
                print(f"wrote {len(rows)} census row(s) -> "
                      f"{args.contract}")
        else:
            contract = load_contract(args.contract, KEY)
            diff_rows(contract, pinned(rows), "the census", failures)

    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"failures": failures, **report}, f, indent=2)
            f.write("\n")
        print(f"report -> {args.report}")

    if failures:
        print(f"ENGINE CONTRACT VIOLATED ({len(failures)} finding(s)):")
        for f_ in failures:
            print(f"  - {f_}")
        return 1
    print("engine contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
