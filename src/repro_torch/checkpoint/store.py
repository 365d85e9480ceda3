"""Checkpointing: flat-key ``.npz`` snapshots of param and optimizer
trees (the port of ``repro.checkpoint.store``; the file format is the
reference's, so a file written by either side loads into the other).

Keys are ``'/'``-joined tree paths spelled as JAX prints them: a dict
key as itself (keys sorted), a list or tuple index as its number, a
named tuple's field as ``.name`` (``AdamState`` gives ``.step``,
``.mu/<path>``, ``.nu/<path>``).  ``__meta__`` is a JSON string holding
``step``, ``extra`` and ``exotic_dtypes``: a bf16 leaf is stored
through its u16 view and its dtype's name recorded there.

Leaves are tensors, or Python ints and floats (the port's
``AdamState.step`` is an int on the host, the reference's an int32
scalar): an int is stored as an int32 scalar and a float as a float32
one, and each is restored as the Python type of the ``like`` leaf, so
the reference reads the port's ``.step`` as its own int32 and the port
reads the reference's as an int.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

#: the dtype numpy cannot hold that the port's trees use, by the name
#: ``ml_dtypes`` gives it
_BF16 = "bfloat16"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name in tree._fields
                for kv in _paths(getattr(tree, name), prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in _paths(sub, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as numpy, and the dtype name it was viewed from (or None)."""
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float,
                                                       torch.Tensor)):
        raise TypeError(f"checkpoint: unsupported leaf {type(leaf)}")
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), None
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32), None
    t = leaf.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy(), None
    return t.view(torch.int16).numpy().view(np.uint16), _BF16


def _layout(cfg):
    if cfg is None:
        return None
    from repro_torch.sharding import lm_layout
    return lm_layout(cfg)


def save_checkpoint(path: str, tree: Any, *, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    cfg=None) -> None:
    """Write ``tree`` to ``path`` (``np.savez``: ``.npz`` is appended
    where missing), with ``step`` and ``extra`` in ``__meta__``.  Given
    the ``cfg`` of a tree sharded on the active mesh, every rank calls
    it: the whole leaves are gathered, rank 0 writes the keys and shapes
    an unsharded save writes, and the ranks wait for it."""
    lay = _layout(cfg)
    if lay is not None:
        import torch.distributed as dist
        whole = lay.gather(tree)
        if dist.get_rank() == 0:
            save_checkpoint(path, whole, step=step, extra=extra)
        dist.barrier()
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    exotic: Dict[str, str] = {}
    for key, leaf in _paths(tree):
        flat[key], name = _to_numpy(leaf)
        if name is not None:
            exotic[key] = name
    meta = {"step": step, "extra": extra or {}, "exotic_dtypes": exotic}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def _restore(arr: np.ndarray, dtype_name: Optional[str], like,
             block=None):
    if isinstance(like, (int, float)):
        return type(like)(arr.item())
    if dtype_name == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype_name is not None:
        raise ValueError(f"checkpoint: leaf stored as {dtype_name}, which "
                         "the port's trees do not hold")
    else:
        t = torch.from_numpy(np.array(arr))
    if block is not None:
        t = block(t)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint: leaf of shape {tuple(t.shape)}, "
                         f"expected {tuple(like.shape)}")
    return t.to(like.device)


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: None for k in like}
        for k in sorted(like):
            out[k] = _rebuild(like[k], leaves)
        return out
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, leaves) for sub in like)
    return next(leaves)


def load_checkpoint(path: str, like: Any, *, cfg=None
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Restore a tree with the structure of ``like``: each tensor in the
    dtype it was saved in, on the device of ``like``'s leaf.  Returns
    (tree, meta); a key ``like`` has and the file lacks raises
    ``KeyError``.  Given the ``cfg`` of a ``like`` sharded on the active
    mesh, each whole leaf is cut to this rank's block."""
    lay = _layout(cfg)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        exotic = meta.get("exotic_dtypes", {})
        leaves = []
        for key, leaf in _paths(like):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            spec = lay.spec_of(key) if lay is not None else None
            leaves.append(_restore(
                data[key], exotic.get(key), leaf,
                None if spec is None else lambda t: lay.block(spec, t)))
    return _rebuild(like, iter(leaves)), meta
