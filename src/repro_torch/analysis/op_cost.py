"""Per-op cost table of one call of a program (the counterpart of
``repro.analysis.hlo_cost``).

The reference parses an optimized HLO dump and weights while bodies by
their trip counts.  Eager PyTorch has no HLO: ``op_costs`` walks one
call under a ``TorchDispatchMode`` on fake tensors (no memory, no
device, as ``launch/dryrun.py`` runs its steps), so the loops have
already run their trips, and records each aten op: its name, its
tensor inputs' and outputs' shapes and dtypes, its FLOPs from
``torch.utils.flop_counter``'s registry (0 for an op the registry does
not know), its bytes and how often it ran.

Bytes are the sum of the op's tensor inputs and outputs for EVERY op.
Unlike ``hlo_cost.py``, which leaves elementwise ops out because XLA
fuses them on the TPU, eager PyTorch runs each op as its own kernel,
which reads its inputs from memory and writes its outputs back, so
elementwise ops count.  Views (``view``, ``expand``, ``detach``, ...)
move no bytes; metadata queries (an op that returns no tensor) are not
recorded.

An op table is a JSONL file, one record a line:
``{"op", "inputs", "outputs", "dtype", "flops", "bytes", "count"}``
(``flops``/``bytes`` a call of the op; shapes as lists).

    PYTHONPATH=src python -m repro_torch.analysis.op_cost <ops.jsonl>

prints the table's ``flops``/``bytes`` totals.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["OpRecorder", "op_costs", "write_ops", "read_ops", "totals",
           "main"]

#: the record keys an op table must have
FIELDS = ("op", "inputs", "outputs", "dtype", "flops", "bytes", "count")

_DTYPE_NAMES = {"float32": "f32", "float64": "f64", "float16": "f16",
                "bfloat16": "bf16", "int8": "s8", "uint8": "u8",
                "int16": "s16", "int32": "s32", "int64": "s64",
                "bool": "pred", "float8_e4m3fn": "f8e4m3fn",
                "float8_e5m2": "f8e5m2"}


def _dtype(t) -> str:
    name = str(t.dtype).replace("torch.", "")
    return _DTYPE_NAMES.get(name, name)


class OpRecorder(TorchDispatchMode):
    """Records every aten op it sees (``records()``: one per distinct op,
    shapes and dtypes, with its count)."""

    def __init__(self) -> None:
        super().__init__()
        self._rows: Dict[Tuple, Dict[str, Any]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not outs:                 # a metadata query (``prim.device``)
            return out
        packet = func._overloadpacket
        key = (packet.__name__,
               tuple((tuple(t.shape), _dtype(t)) for t in ins),
               tuple((tuple(t.shape), _dtype(t)) for t in outs))
        row = self._rows.get(key)
        if row is None:
            flops = 0
            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
            moved = 0 if _is_view(func) else sum(
                t.numel() * t.element_size() for t in ins + outs)
            row = self._rows[key] = dict(
                op=key[0], inputs=[list(s) for s, _ in key[1]],
                outputs=[list(s) for s, _ in key[2]],
                dtype=key[2][0][1],
                flops=flops, bytes=moved, count=0)
        row["count"] += 1
        return out

    def records(self) -> List[Dict[str, Any]]:
        return list(self._rows.values())


def _is_view(func) -> bool:
    """An op whose output aliases an input (``_unsafe_view`` is one too,
    though its schema does not say so)."""
    return func._overloadpacket.__name__ == "_unsafe_view" or any(
        a.alias_info is not None and not a.alias_info.is_write
        for a in func._schema.returns)


def op_costs(fn: Callable, *args, **kwargs) -> List[Dict[str, Any]]:
    """One call of ``fn(*args, **kwargs)`` on fake tensors (the tensors
    among ``args`` and ``kwargs``, and those ``fn`` holds, are faked,
    keeping shape and dtype) -> its op table, in the order the ops first
    ran."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = lambda t: (mode.from_tensor(t) if isinstance(t, torch.Tensor)
                      else t)
    args, kwargs = tree_map(fake, (args, kwargs))
    rec = OpRecorder()
    with mode, rec:
        fn(*args, **kwargs)
    return rec.records()


def write_ops(path: str, records: Iterable[Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def read_ops(text: str) -> List[Dict[str, Any]]:
    """The records of an op table's text; raises ``ValueError`` when a
    line is not one."""
    out = []
    for ln in text.splitlines():
        if not ln.strip():
            continue
        r = json.loads(ln)
        if not isinstance(r, dict) or any(k not in r for k in FIELDS):
            raise ValueError(f"not an op record: {ln[:80]}")
        out.append(r)
    if not out:
        raise ValueError("no op records")
    return out


def totals(records: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    """FLOPs and bytes of the whole call (each record × its count)."""
    f = b = 0.0
    for r in records:
        f += r["flops"] * r["count"]
        b += r["bytes"] * r["count"]
    return {"flops": f, "bytes": b}


def load_table(path: str):
    """(records, exit code): 2 on an unreadable file, 1 when it is not
    an op table, with the error printed; (records, 0) otherwise."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        print(f"error: cannot read {path}: {e}")
        return None, 2
    try:
        return read_ops(text), 0
    except ValueError as e:
        print(f"error: {path} is not an op table ({e})")
        return None, 1


def main(argv=None) -> int:
    """Exit 2 on an unreadable file, 1 when it is not an op table, 0
    with the totals printed."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.op_cost",
        description="flop/byte totals of an op table (JSONL)")
    ap.add_argument("ops", help="path to an op table (op_costs, "
                                "launch/dryrun --save-ops)")
    args = ap.parse_args(argv)
    records, rc = load_table(args.ops)
    if rc:
        return rc
    cost = totals(records)
    print(f"flops {cost['flops']:.6g}")
    print(f"bytes {cost['bytes']:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
