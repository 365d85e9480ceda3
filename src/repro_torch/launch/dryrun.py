"""Dry run of the production shapes (the port of
``repro/launch/dryrun.py``): for every (architecture × input shape ×
mesh), build the step and its abstract inputs and placements
(``launch.specs``), run the step once on fake tensors at the global
shape, and write a record to ``<out>/<arch>__<shape>__<mesh>.json``.

The reference compiles an XLA program for 256 or 512 placeholder
devices and reads its memory and cost analyses.  The port has no such
compiler, so a record holds what a run on fake tensors (no memory, no
device: ``FakeTensorMode``) can show:
- that the step runs at the global shape (the shape check);
- its FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``
  over the one-device step; train and prefill steps attend in the
  ``"full"`` form (``ATTENTION``), which computes every score block the
  reference's default ``"chunked"`` form computes, so the count is the
  same (``tests/test_torch_specs.py``), on fake tensors some 300 times
  faster (a chunked prefill at 32,768 tokens dispatches ~2,000 block
  steps a layer);
- each rank's resident bytes of params, Adam state, batch and caches
  under the placements on the production mesh (each leaf's block), per
  category and in total, and whether they fit one H100's 80 GB
  (activations are not counted);
- the roofline terms (``analysis.roofline``) with FLOPs / chips and the
  rank's resident bytes.  A run on fake tensors makes no collective, so
  ``collective_bytes_per_device`` is ``null`` and its term is left out.

A step that needs the values of its data (a routing that reads them, an
``.item()``) fails on fake tensors; that is a ``failed`` record with its
error, never a skip.  The reference's ``--save-hlo`` becomes
``--save-ops``: each record's run also writes its op table
(``analysis.op_cost``) to ``<out>/<tag>.ops.jsonl``, which
``python -m repro_torch.analysis.op_cost`` and ``analysis.breakdown``
read.  Nothing here sets ``XLA_FLAGS`` or needs a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun_torch] \\
      [--save-ops]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

ATTENTION = "full"

NOTES = ("a run on fake tensors makes no collective: collective bytes "
         "are not counted, and the roofline leaves that term out; "
         "resident bytes count params, Adam state, batch and caches, not "
         "activations")


def rank_bytes(aargs, placements, sizes) -> int:
    """The bytes one rank holds of the abstract tree ``aargs`` laid out
    by ``placements`` (the tree of specs beside it) over a mesh of axis
    ``sizes``: each leaf's block (Python values hold none)."""
    from repro_torch.launch.specs import TensorSpec
    from repro_torch.train.optimizer import AdamState

    if isinstance(aargs, TensorSpec):
        n = aargs.dtype.itemsize
        for i, d in enumerate(aargs.shape):
            entry = placements[i] if i < len(placements) else None
            axes = (() if entry is None else
                    entry if isinstance(entry, tuple) else (entry,))
            for a in axes:
                d //= sizes[a]
            n *= d
        return n
    if isinstance(aargs, AdamState):
        return (rank_bytes(aargs.mu, placements.mu, sizes)
                + rank_bytes(aargs.nu, placements.nu, sizes))
    if isinstance(aargs, dict):
        return sum(rank_bytes(v, placements[k], sizes)
                   for k, v in aargs.items())
    if isinstance(aargs, (list, tuple)):
        return sum(rank_bytes(v, p, sizes)
                   for v, p in zip(aargs, placements))
    return 0


def resident(cfg, shape, aargs, in_pl, out, mesh) -> dict:
    """Each rank's resident bytes by category: params, Adam state, batch,
    caches (a prefill's are its output, placed as decode's are)."""
    from repro_torch import sharding
    from repro_torch.launch import specs

    sizes = sharding.axis_sizes(mesh)
    if shape.kind == "train":
        names = ("params", "adam", "batch")
    elif shape.kind == "prefill":
        names = ("params", "batch")
    else:
        names = ("params", "caches", None, "batch")
    got = {"params": 0, "adam": 0, "batch": 0, "caches": 0}
    for name, a, p in zip(names, aargs, in_pl):
        if name:
            got[name] = rank_bytes(a, p, sizes)
    if shape.kind == "prefill" and cfg.family != "audio":
        acaches = specs._specs(out[1])
        got["caches"] = rank_bytes(
            acaches, specs._cache_spec_tree(acaches, mesh, cfg), sizes)
    got["total"] = sum(got.values())
    return got


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            out_dir: str = "experiments/dryrun_torch",
            variant: str = "", save_ops: bool = False) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import sharding
    from repro_torch.analysis.op_cost import OpRecorder, write_ops
    from repro_torch.analysis.roofline import (HW, model_flops_for,
                                               roofline_terms)
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (f"__{variant}" if variant
                                                  else "")
    ok, why = specs.supports(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "variant": variant or "baseline"}
    if not ok:
        record.update(status="skipped", reason=why)
        _save(out_dir, tag, record)
        print(f"[dryrun] SKIP {tag}: {why}")
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.shape)
    t0 = time.perf_counter()
    try:
        if sharding.active_mesh() is not None:
            raise RuntimeError("the dry run runs the one-device step; a "
                               "mesh is active")
        fn, aargs, in_pl, _ = specs.build_dryrun(cfg, shape, mesh,
                                                 attn_impl=ATTENTION)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        mode = specs._fake_mode()
        args = specs.fake_args(aargs, mode)
        counter = FlopCounterMode(display=False)
        grad = (contextlib.nullcontext() if shape.kind == "train"
                else torch.no_grad())
        ops = OpRecorder() if save_ops else contextlib.nullcontext()
        with mode, counter, grad, ops:
            out = fn(*args)
        t_run = time.perf_counter() - t0
        flops = float(counter.get_total_flops())
        held = resident(cfg, shape, aargs, in_pl, out, mesh)
    except Exception as exc:  # noqa: BLE001 — recorded for the report
        record.update(status="failed", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
        _save(out_dir, tag, record)
        print(f"[dryrun] FAIL {tag}: {exc}")
        return record

    flops_dev = flops / chips
    bytes_dev = float(held["total"])
    terms = roofline_terms(
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=None,
        model_flops_global=model_flops_for(cfg, shape), chips=chips)
    record.update(
        status="ok",
        chips=chips,
        build_s=t_build, run_s=t_run,
        attention=(ATTENTION if shape.kind != "decode"
                   else "decode_attention against the cache"),
        resident_bytes_per_device=held,
        fits_hbm=held["total"] <= HW.hbm_bytes,
        hbm_bytes=HW.hbm_bytes,
        cost={"flops_global": flops, "flops_per_device": flops_dev,
              "bytes_per_device": bytes_dev},
        collective_bytes_per_device=None,
        roofline=terms,
        notes=NOTES,
    )
    _save(out_dir, tag, record)
    if save_ops:
        write_ops(os.path.join(out_dir, f"{tag}.ops.jsonl"), ops.records())
    print(f"[dryrun] OK {tag}: run={t_run:.1f}s flops/dev={flops_dev:.3e} "
          f"resident/dev={bytes_dev / 2 ** 30:.2f}GiB "
          f"fits={record['fits_hbm']} dominant={terms['dominant']}")
    return record


def _save(out_dir: str, tag: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape on both meshes (or on the "
                         "two-pod mesh alone with --multi-pod)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default="",
                    help="a tag for the records of one variant")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos whose record is already ok/skipped")
    ap.add_argument("--reverse", action="store_true",
                    help="reverse arch order (light archs first)")
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each record's op table "
                         "(<tag>.ops.jsonl)")
    args = ap.parse_args()

    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        rec = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                      out_dir=args.out, variant=args.variant,
                      save_ops=args.save_ops)
        raise SystemExit(1 if rec.get("status") == "failed" else 0)
    n_fail = 0
    meshes = (True,) if args.multi_pod else (False, True)
    arch_list = list(reversed(ARCH_IDS)) if args.reverse else ARCH_IDS
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        for arch in arch_list:
            for shape in INPUT_SHAPES:
                tag = f"{arch}__{shape}__{mesh_name}" + (
                    f"__{args.variant}" if args.variant else "")
                if args.skip_existing and _done(args.out, tag):
                    print(f"[dryrun] CACHED {tag}")
                    continue
                rec = run_one(arch, shape, multi_pod=multi_pod,
                              out_dir=args.out, variant=args.variant,
                              save_ops=args.save_ops)
                n_fail += rec.get("status") == "failed"
    raise SystemExit(1 if n_fail else 0)


def _done(out_dir: str, tag: str) -> bool:
    try:
        with open(os.path.join(out_dir, f"{tag}.json")) as f:
            return json.load(f).get("status") in ("ok", "skipped")
    except FileNotFoundError:
        return False


if __name__ == "__main__":
    main()
