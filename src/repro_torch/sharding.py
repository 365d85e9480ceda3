"""Sharding of the VFL pipeline over a device mesh: the VFL half of
``repro.sharding`` on ``torch.distributed``.

The reference runs one process over many devices and shards with
``shard_map``; the port runs SPMD, one process a rank.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
``("data",)`` or ``("data", "model")`` (``launch.mesh``).  Every rank
calls the same entry point with the same arguments; each computes its
block of the batch and the blocks meet through the collectives below, so
every rank returns the same result, as a ``shard_map`` with replicated
outputs does.

The helpers resolve a mesh and an axis as the reference's do: a mesh
whose sharded axes all have size 1 collapses to ``None``, the
single-device path, and an axis the mesh does not have raises.

Collectives (what ``shard_map`` bodies write as ``all_gather``/
``psum_scatter``/``psum``): ``all_gather_rows`` (a tiled dim-0
all-gather over one mesh dim), ``gather_rows`` (the same under autograd,
its backward the sum reduce-scatter, the transpose
``jax.lax.all_gather`` gets), ``reduce_scatter_rows`` and
``all_reduce_sum`` (over one mesh dim or two).  The transport is the
group's backend, read from the group and never found by catching an
error: NCCL takes CUDA tensors; gloo takes host tensors, so a CUDA
tensor given to a gloo group is staged through host memory here, on
purpose (several ranks on one card, where NCCL refuses two ranks a
device).  ``COLLECTIVES`` counts the collectives a process made, the
ones it staged and their bytes.

The LLM half (the second part of this module) lays a model's params
out by the reference's rules and trains it on a ``(data, model)`` or
``(pod, data, model)`` mesh: ``_RULES``, ``spec_for_param``,
``filter_spec``, ``check_divisible``, ``param_shardings`` and
``batch_shardings`` give the reference's ``PartitionSpec``s entry for
entry (as tuples), on a ``DeviceMesh`` or any object with
``mesh_dim_names`` and ``shape`` (``MeshShape``: no world needed).
GSPMD's ``with_sharding_constraint`` has no PyTorch counterpart, so
``shard_act``/``shard_attn_act`` change nothing and the layout is
explicit (``LMLayout``): params rest as each rank's block of their spec;
a layer gathers its ``data``-sharded blocks in one flat collective just
before it runs (backward: the sum reduce-scatter); under the ``"2d"``
profile every family keeps the ``model`` shards the model code runs on
(Megatron's pair ``copy_to_model``/``reduce_sum`` around attention's
heads, an MLP's ``d_ff``, the Mamba mixer's SSM heads, the vocab; the
experts through ``models.moe.moe_forward_ep``'s ``all_to_all``), and
attention whose q heads do not divide ``model`` runs context-parallel
over the sequence where the sequence divides it (``LMLayout.attention_route``,
the reference's ``shard_attn_act`` rule).  A block whose ``model`` shards
the code cannot run on (a Mamba mixer whose rank block splits an SSM
head, attention in neither case) is gathered whole and runs replicated
over ``model``.  Batch rows shard over the profile's batch axes (``pod``
and ``data``, and ``model`` under ``"fsdp"``); the gradients of params
replicated over a batch axis (every param over ``pod``) are summed over
it after the backward.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "reset_collectives", "shard_axis_name",
           "padded_rows", "pad_batch_rows", "resolve_batch_mesh",
           "resolve_train_mesh", "mesh_axis_size", "MeshAxis", "my_rows",
           "all_gather_rows", "gather_rows", "reduce_scatter_rows",
           "all_reduce_sum", "DP", "set_profile", "profile", "batch_axes",
           "set_active_mesh", "active_mesh", "use_mesh", "MeshShape",
           "axis_sizes", "filter_spec", "check_divisible", "dp_spec",
           "shard_act", "shard_attn_act", "spec_for_param",
           "param_shardings", "param_specs_abstract", "replicated",
           "batch_shardings", "flat_tree", "flat_specs", "mesh_axis",
           "all_to_all", "copy_to_model", "reduce_sum", "gather_dim",
           "split_dim", "flat_gather", "copy_params_to_model", "psum",
           "tp_axis", "LMLayout", "lm_layout"]

#: collectives this process made: all of them, the ones staged through
#: host memory (a CUDA tensor on a gloo group), and the bytes each rank
#: put in (read by chip_smoke.py's sharded phase)
COLLECTIVES: Dict[str, int] = {"calls": 0, "staged": 0, "bytes": 0}


def reset_collectives() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def shard_axis_name(mesh) -> str:
    """The mesh dim the PSI/CSS batch paths shard over: ``data`` when
    the mesh has one, else its first dim."""
    names = tuple(mesh.mesh_dim_names)
    return "data" if "data" in names else names[0]


def padded_rows(b: int, n_shards: int) -> int:
    """The leading-dim size ``pad_batch_rows`` pads a B-row batch to."""
    return b + (-b) % n_shards


def pad_batch_rows(arrays: Sequence[np.ndarray], n_shards: int
                   ) -> Tuple[List[np.ndarray], int]:
    """Pad every array's leading dim (shared batch size B) to
    ``padded_rows(B, n_shards)`` by repeating row 0.  Returns (padded,
    B): callers truncate outputs back to B rows.  Row-0 filler keeps
    the padded rows representative, so the per-row program is the same
    on every shard (the filler's outputs are dropped)."""
    b = arrays[0].shape[0]
    pad = padded_rows(b, n_shards) - b
    if pad == 0:
        return list(arrays), b
    return [np.concatenate([np.asarray(a),
                            np.repeat(np.asarray(a[:1]), pad, axis=0)])
            for a in arrays], b


def axis_sizes(mesh) -> Dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    return dict(zip(tuple(mesh.mesh_dim_names or ()),
                    (int(n) for n in mesh.shape)))


def mesh_axis_size(mesh, name: Optional[str]) -> int:
    """The size of mesh dim ``name``; 1 for a dim the mesh lacks."""
    return axis_sizes(mesh).get(name, 1)


def _check_axis(mesh, shard_axis: Optional[str]) -> None:
    names = tuple(mesh.mesh_dim_names)
    if shard_axis is not None and shard_axis not in names:
        raise ValueError(f"shard_axis {shard_axis!r} not in mesh axes "
                         f"{names}")


def resolve_batch_mesh(mesh, shard_axis: Optional[str] = None):
    """(mesh, axis, n_shards) for the batch-sharding paths (PSI rounds,
    the coreset fit); ``mesh=None`` or an axis of size 1 collapses to
    (None, None, 1), the single-device path.  An explicit
    ``shard_axis`` the mesh does not have raises."""
    if mesh is None:
        return None, None, 1
    _check_axis(mesh, shard_axis)
    axis = shard_axis or shard_axis_name(mesh)
    n = mesh_axis_size(mesh, axis)
    if n <= 1:
        return None, None, 1
    return mesh, axis, n


def resolve_train_mesh(mesh, shard_axis: Optional[str] = None):
    """(mesh, data_axis, n_data, model_axis, n_model) for the VFL train
    engine: ``data_axis`` (``shard_axis`` or ``data``) shards the step's
    batch columns; ``model_axis``, the mesh's ``model`` dim where it is
    not the data axis, shards the M-client bottom.  ``mesh=None`` or a
    mesh whose axes are all of size 1 collapses to (None, None, 1, None,
    1), the single-device path."""
    if mesh is None:
        return None, None, 1, None, 1
    _check_axis(mesh, shard_axis)
    names = tuple(mesh.mesh_dim_names)
    data_axis = shard_axis or shard_axis_name(mesh)
    model_axis = "model" if ("model" in names and data_axis != "model") \
        else None
    n_data = mesh_axis_size(mesh, data_axis)
    n_model = mesh_axis_size(mesh, model_axis)
    if n_model <= 1:
        model_axis, n_model = None, 1
    if n_data <= 1 and n_model <= 1:
        return None, None, 1, None, 1
    return mesh, data_axis, n_data, model_axis, n_model


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One named dim of a mesh, as this rank sees it: its process group,
    its size and this rank's coordinate on it."""
    mesh: Any
    name: str

    @property
    def group(self):
        return self.mesh.get_group(self.name)

    @property
    def size(self) -> int:
        return mesh_axis_size(self.mesh, self.name)

    @property
    def rank(self) -> int:
        return int(self.mesh.get_local_rank(self.name))

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` rows (``n`` a multiple of the
        size): block r is rows [r·n/size, (r+1)·n/size)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def my_rows(n: int, axis: Optional[MeshAxis]) -> np.ndarray:
    """The indices of the rows of an n-row batch this rank takes: its
    block of the batch padded with row-0 filler (``pad_batch_rows``),
    every row where ``axis`` is None."""
    rows = np.arange(n)
    if axis is None:
        return rows
    (rows,), _ = pad_batch_rows([rows], axis.size)
    return rows[axis.block(len(rows))]


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host memory: a CUDA tensor on a gloo
    group (gloo moves host buffers)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(t: torch.Tensor, staged: bool) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["staged"] += int(staged)
    COLLECTIVES["bytes"] += t.numel() * t.element_size()


def all_gather_rows(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The tiled dim-0 all-gather over ``axis``: every rank's (n, ...)
    block, in rank order, as one (size·n, ...) tensor on ``t``'s
    device."""
    group = axis.group
    staged = _host_staged(t, group)
    src = (t.cpu() if staged else t).contiguous()
    out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _count(src, staged)
    return out.to(t.device) if staged else out


def reduce_scatter_rows(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum reduce-scatter over ``axis``: the (size·n, ...) tensors of
    the ranks summed, and this rank's block of n rows of the sum."""
    group = axis.group
    staged = _host_staged(t, group)
    src = (t.cpu() if staged else t).contiguous()
    out = src.new_empty((src.shape[0] // axis.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    _count(src, staged)
    return out.to(t.device) if staged else out


def all_reduce_sum(t: torch.Tensor, *axes: MeshAxis) -> torch.Tensor:
    """``t`` summed over the ranks of each of ``axes`` in turn (the
    reference's ``psum`` over one mesh dim or two), in place where ``t``
    needs no staging; returns the sum.  Every rank gets the same bits."""
    for axis in axes:
        group = axis.group
        staged = _host_staged(t, group)
        src = t.cpu() if staged else t
        dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
        _count(src, staged)
        if staged:
            t.copy_(src)
    return t


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` under autograd: the backward hands each rank
    the sum over ``axis`` of the cotangents of its own block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.axis), None


def gather_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Differentiable ``all_gather_rows`` (backward: the sum
    reduce-scatter)."""
    return _GatherRows.apply(x, axis)


# ============================================================ the LLM half

DP = ("pod", "data")    # batch axes (filtered to the mesh's actual axes)

# "2d" (default): batch over (pod, data), tensor parallel over model (heads,
# d_ff, experts, vocab) and FSDP over data.  "fsdp": no tensor parallelism,
# model joins the batch axes and params shard over data alone.  The
# reference reads the same variable.
_PROFILE = os.environ.get("REPRO_SHARDING_PROFILE", "2d")


def set_profile(name: str) -> None:
    global _PROFILE
    if name not in ("2d", "fsdp"):
        raise ValueError(f"unknown sharding profile {name!r}")
    _PROFILE = name


def profile() -> str:
    return _PROFILE


def batch_axes() -> Tuple[str, ...]:
    return ("pod", "data", "model") if _PROFILE == "fsdp" else DP


_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


class use_mesh:
    """``with use_mesh(mesh): ...`` makes ``mesh`` the one the model code
    lays its params and batches out on (``lm_layout``); on exit the mesh
    that was active before it is again."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._outer = []

    def __enter__(self):
        self._outer.append(active_mesh())
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self._outer.pop())
        return False


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes with no world behind it: what the
    rule helpers read (a ``(1, 1)`` one is the host mesh of a process
    that is not a rank)."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _entry(e):
    """``PartitionSpec``'s normal form of an entry: a one-name tuple is
    the name, an empty one ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _spec(entries) -> tuple:
    return tuple(_entry(e) for e in entries)


def _filter_entry(entry, axes):
    if entry is None:
        return None
    # the DP marker expands to the profile's batch axes
    if isinstance(entry, (tuple, list)) and set(entry) == {"pod", "data"}:
        entry = batch_axes()
    elif _PROFILE == "fsdp":
        # the model axis belongs to the batch: drop it from every
        # tensor-parallel entry
        if entry == "model":
            return None
        if isinstance(entry, (tuple, list)):
            entry = tuple(a for a in entry if a != "model") or None
            if entry is None:
                return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in axes)
        return kept if kept else None
    return entry if entry in axes else None


def filter_spec(spec, mesh) -> tuple:
    """``spec`` with the axes the mesh lacks (and, under ``"fsdp"``,
    ``model``) dropped."""
    axes = set(mesh.mesh_dim_names)
    return _spec(_filter_entry(e, axes) for e in spec)


def check_divisible(spec, shape, mesh) -> tuple:
    """``spec`` with each sharded dim whose size does not divide by its
    axes' product left whole."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        total = 1
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            total *= sizes.get(n, 1)
        out.append(entry if shape[i] % total == 0 else None)
    return _spec(out)


def dp_spec(mesh) -> Tuple[str, ...]:
    return tuple(a for a in batch_axes() if a in mesh.mesh_dim_names)


def shard_act(x, *entries):
    """The reference's activation constraint.  It changes no value, and
    the port's layout is explicit (``LMLayout``): ``x`` unchanged."""
    return x


def shard_attn_act(x, *, head_axis: int = 2, seq_axis: int = 1):
    """The reference's attention-activation constraint (heads over
    ``model``, else context parallelism over the sequence): a layout
    only, so ``x`` unchanged.  The port runs the same rule explicitly:
    a rank's q heads where the heads divide ``model`` (``LMLayout``'s
    kept shards), else its block of the q rows where the sequence does
    (``LMLayout.attention_route``, ``models.attention.context_attention``)."""
    return x


_RULES = [
    # (regex over the "/"-joined path, spec of the UNSTACKED param)
    (r"(^|/)embed$", ("model", "data")),
    (r"(^|/)lm_head$", ("data", "model")),
    (r"(^|/)(dec_)?pos_embed$", (None, "model")),
    (r"(^|/)meta_tokens$", (None, None)),
    (r"(^|/)vision_proj$", ("data", "model")),
    (r"attn.*/wq$", ("data", "model", None)),
    (r"attn.*/w[kv]$", ("data", "model", None)),
    (r"attn.*/wo$", ("model", "data")),
    (r"attn.*/b[qkv]$", (None, None)),
    (r"(mlp|cross_mlp)/wi(_gate|_up)?$", ("data", "model")),
    (r"(mlp|cross_mlp)/wo$", ("model", "data")),
    (r"(mlp|cross_mlp)/bi$", ("model",)),
    (r"(mlp|cross_mlp)/bo$", (None,)),
    (r"moe/router$", ("data", None)),
    (r"moe/wi(_gate|_up)$", ("model", "data", None)),
    (r"moe/wo$", ("model", None, "data")),
    (r"(mamba|ssm)/w[zx]$", ("data", "model")),
    (r"(mamba|ssm)/w[BC]$", ("data", None)),
    (r"(mamba|ssm)/wdt$", ("data", None)),
    (r"(mamba|ssm)/conv_x$", (None, "model")),
    (r"(mamba|ssm)/out_proj$", ("model", "data")),
    (r"(mamba|ssm)/gate_norm/scale$", ("model",)),
]

_STACKS = ("layers", "enc_layers", "dec_layers")


def spec_for_param(path_str: str, ndim: int) -> tuple:
    """The rule's spec for a param at ``path_str``, padded or cut to its
    ``ndim`` (a stacked leaf's leading layer axis stays whole)."""
    stacked = bool(re.search(r"(^|/)(layers|enc_layers|dec_layers)(/|$)",
                             path_str))
    base_ndim = ndim - (1 if stacked else 0)
    spec = next((s for pat, s in _RULES if re.search(pat, path_str)), None)
    entries = list(spec) if spec is not None else [None] * base_ndim
    entries = (entries + [None] * base_ndim)[:base_ndim]
    return _spec(([None] if stacked else []) + entries)


def _is_leaf(t) -> bool:
    return isinstance(t, torch.Size) or not isinstance(t, (dict, list,
                                                            tuple))


def flat_tree(tree, prefix: str = "", is_leaf=_is_leaf
              ) -> List[Tuple[str, Any]]:
    """(``"/"``-joined path, leaf) pairs in ``tree_leaves``' order (dict
    keys sorted); a ``torch.Size`` is a leaf."""
    if is_leaf(tree):
        return [(prefix, tree)]
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    return [kv for k, v in items
            for kv in flat_tree(v, f"{prefix}/{k}" if prefix else str(k),
                                is_leaf)]


def flat_specs(specs) -> Dict[str, tuple]:
    """{path: spec} of a spec tree (``param_shardings``)."""
    return dict(flat_tree(specs, is_leaf=lambda t: not isinstance(t, dict)))


def _map_path(fn, tree, prefix: str = ""):
    if _is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    subs = [_map_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree)]
    return type(tree)(*subs) if hasattr(tree, "_fields") else type(tree)(subs)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs_abstract(abstract_params, mesh):
    """The spec tree of a param tree whose leaves are tensors or shapes:
    each leaf's rule, filtered to the mesh and checked for
    divisibility."""
    def one(path, leaf):
        shape = _shape(leaf)
        spec = filter_spec(spec_for_param(path, len(shape)), mesh)
        return check_divisible(spec, shape, mesh)
    return _map_path(one, abstract_params)


param_shardings = param_specs_abstract


def replicated(mesh) -> tuple:
    return ()


def batch_shardings(batch, mesh):
    """The spec tree of a batch: every leaf's leading dim over the
    profile's batch axes (left whole where it does not divide)."""
    dp = dp_spec(mesh)

    def one(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        return check_divisible(_spec((dp,) + (None,) * (len(shape) - 1)),
                               shape, mesh)
    return _map_path(one, batch)


# ------------------------------------------------ collectives under autograd

def mesh_axis(mesh, name: str) -> Optional[MeshAxis]:
    """Dim ``name`` of ``mesh`` as a ``MeshAxis``; None where the mesh
    lacks it or it has size 1 (no collective to make)."""
    if mesh is None or mesh_axis_size(mesh, name) <= 1:
        return None
    return MeshAxis(mesh, name)


def _moved(op, t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``op`` (a gather or an all-to-all along dim 0: data movement only)
    on ``t``, a 16-bit float tensor moved as its bytes (gloo moves no
    bf16 or int16 in some builds)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return op(t.view(torch.uint8), axis).view(t.dtype)
    return op(t, axis)


def _sum_f32(t: torch.Tensor, axes) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``axes`` in f32, in t's dtype."""
    y = t.detach().to(torch.float32, copy=True)
    all_reduce_sum(y, *axes)
    return y.to(t.dtype)


class _ReduceSum(torch.autograd.Function):
    """Sum over ``axes`` forward (in f32), identity backward: the pieces
    each rank holds meet in one value every rank then uses as its own
    (Megatron's g; the loss's and the MoE aux's means)."""

    @staticmethod
    def forward(ctx, x, axes):
        return _sum_f32(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(x: torch.Tensor, *axes: Optional[MeshAxis]) -> torch.Tensor:
    """``_ReduceSum`` over the axes given (None ones skipped): over
    ``model``, Megatron's g, the row-parallel output summed."""
    axes = tuple(a for a in axes if a is not None)
    return _ReduceSum.apply(x, axes) if axes else x


class _CopyTo(torch.autograd.Function):
    """Megatron's f of one or several tensors: identity forward; backward
    their cotangents summed over ``axis`` in one flat f32 all-reduce,
    each returned in its own dtype (values every rank holds whole, used
    by each for its own part)."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.float().reshape(-1) for g in gs])
        all_reduce_sum(flat, ctx.axis)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
            off += g.numel()
        return (None,) + tuple(out)


def copy_to_model(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Megatron's f over ``model``: the input of a column-parallel
    product, or a replicated param each rank uses in part."""
    return x if axis is None else _CopyTo.apply(axis, x)[0]


def copy_params_to_model(params: Dict[str, torch.Tensor],
                         axis: Optional[MeshAxis]) -> Dict[str, torch.Tensor]:
    """``copy_to_model`` of every tensor of ``params`` (a flat dict of
    params replicated over ``model`` that each rank uses in part: its
    heads' rows, its q rows), their gradients summed in one collective."""
    if axis is None or not params:
        return dict(params)
    keys = list(params)
    return dict(zip(keys, _CopyTo.apply(axis, *(params[k]
                                                for k in keys))))


def psum(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """``x`` summed over ``axis`` in f32, and the cotangent summed the
    same way in the backward: a value each rank computes a part of and
    every rank then uses whole, each for its own part of what follows
    (the gated RMS norm's sum of squares over a Mamba mixer's channels):
    ``reduce_sum`` then ``copy_to_model``."""
    return copy_to_model(reduce_sum(x, axis), axis)


def tp_axis(local: int, whole: int) -> Optional[MeshAxis]:
    """The active mesh's ``model`` axis where a param holds ``local`` of
    ``whole`` columns (tensor parallelism: ``LMLayout`` kept its
    ``model`` shard), else None."""
    return mesh_axis(active_mesh(), "model") if local != whole else None


def _gather_along(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The tiled all-gather of ``x`` along ``dim`` over ``axis``."""
    moved = x.movedim(dim, 0).contiguous()
    return _moved(all_gather_rows, moved, axis).movedim(0, dim)


def _block_along(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward this rank's block of
    the cotangent (every rank of ``axis`` uses the whole identically)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_along(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block_along(g, ctx.axis, ctx.dim).contiguous(), None, None


class _SplitDim(torch.autograd.Function):
    """This rank's block along ``dim`` forward; backward the all-gather
    of the blocks' cotangents (the inverse pair of ``_GatherDim``)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block_along(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g.contiguous(), ctx.axis, ctx.dim), None, None


def gather_dim(x: torch.Tensor, axis: Optional[MeshAxis], dim: int
               ) -> torch.Tensor:
    return x if axis is None else _GatherDim.apply(x, axis, dim % x.dim())


def split_dim(x: torch.Tensor, axis: Optional[MeshAxis], dim: int
              ) -> torch.Tensor:
    return x if axis is None else _SplitDim.apply(x, axis, dim % x.dim())


def _all_to_all_raw(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    group = axis.group
    staged = _host_staged(t, group)
    src = (t.cpu() if staged else t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count(src, staged)
    return out.to(t.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _moved(_all_to_all_raw, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _moved(_all_to_all_raw, g.contiguous(), ctx.axis), None


def all_to_all(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Dim 0 in ``axis.size`` chunks, chunk j to rank j; the result's
    chunk i came from rank i (``jax.lax.all_to_all`` tiled, split and
    concat on dim 0).  Its backward is the same exchange."""
    return x if axis is None else _AllToAll.apply(x, axis)


class _FlatGather(torch.autograd.Function):
    """FSDP's gather of several leaves' blocks in one collective: each
    block cast to ``dtype`` and flattened, the flat buffers all-gathered
    over ``axis``, each leaf rebuilt along its sharded dim.  Backward:
    the whole cotangents cut into the ranks' blocks, in f32, and summed
    over ``axis`` by one reduce-scatter (``reduce``, the ranks of a batch
    axis hold other rows) or this rank's block taken (every rank used
    the whole identically); each returned in its block's dtype."""

    @staticmethod
    def forward(ctx, axis, dims, dtype, reduce, *blocks):
        ctx.axis, ctx.dims, ctx.reduce = axis, dims, reduce
        ctx.meta = [(tuple(b.shape), b.dtype) for b in blocks]
        ctx.device = blocks[0].device
        flat = torch.cat([b.detach().to(dtype).reshape(-1) for b in blocks])
        full = _moved(all_gather_rows, flat, axis).view(axis.size, -1)
        outs, off = [], 0
        for b, d in zip(blocks, dims):
            k = b.numel()
            piece = full[:, off:off + k].reshape((axis.size,) + tuple(b.shape))
            shape = list(b.shape)
            shape[d] *= axis.size
            outs.append(piece.movedim(0, d).reshape(shape))
            off += k
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        size = ctx.axis.size
        rows = []
        for g, (shape, _), d in zip(grads, ctx.meta, ctx.dims):
            whole = shape[:d] + (size * shape[d],) + shape[d + 1:]
            g = (torch.zeros(whole, dtype=torch.float32, device=ctx.device)
                 if g is None else g.float())
            rows.append(g.reshape(shape[:d] + (size,) + shape[d:])
                        .movedim(d, 0).reshape(size, -1))
        buf = torch.cat(rows, 1)
        mine = (reduce_scatter_rows(buf.contiguous(), ctx.axis)[0]
                if ctx.reduce else buf[ctx.axis.rank])
        out, off = [], 0
        for shape, dt in ctx.meta:
            k = int(np.prod(shape))
            out.append(mine[off:off + k].reshape(shape).to(dt))
            off += k
        return (None, None, None, None) + tuple(out)


def flat_gather(blocks: Sequence[torch.Tensor], dims: Sequence[int],
                axis: MeshAxis, dtype, reduce: bool) -> List[torch.Tensor]:
    """``_FlatGather`` of ``blocks`` (the whole leaves, in order)."""
    if not blocks:
        return []
    return list(_FlatGather.apply(axis, tuple(dims), dtype, reduce, *blocks))


# ----------------------------------------------------------- the LLM layout

def _cast_before_gather(path: str, t: torch.Tensor) -> bool:
    """Whether the compute casts this leaf to the compute dtype anyway
    (every matrix but the f32 router), so that it can be gathered cast."""
    return (t.is_floating_point() and t.dim() >= 2
            and not path.endswith("router"))


#: a Mamba mixer's leaves that hold d_inner channels, sharded over
#: ``model`` together (``models.ssm``)
_MAMBA_TP = ("mamba/wz", "mamba/wx", "mamba/conv_x", "mamba/out_proj",
             "mamba/gate_norm/scale")


def _model_kept(specs: Dict[str, tuple], cfg, model: int,
                heads: bool) -> set:
    """The leaves of one layer (paths within the layer) that keep their
    ``model`` shards under tensor parallelism, on a ``model`` axis of
    size ``model``: attention's and cross-attention's where ``heads``
    (``LMLayout.attention_route`` gives each rank its q heads; k/v where
    the kv heads shard too), an MLP's when d_ff does (GLU: both input
    matrices and ``wo``; GELU: ``wi``, ``bi`` and ``wo``, its ``bo``
    replicated), the experts when they do (expert parallelism), the
    Mamba mixer's d_inner leaves when a rank's block of d_inner is whole
    SSM heads."""
    sharded = lambda p: "model" in specs.get(p, ())
    keep = set()
    for attn in ("attn", "cross_attn"):
        if heads and f"{attn}/wq" in specs:
            keep |= {f"{attn}/wq", f"{attn}/wo"}
            keep |= {p for p in (f"{attn}/wk", f"{attn}/wv") if sharded(p)}
    for group in (("mlp/wi_gate", "mlp/wi_up", "mlp/wo"),
                  ("mlp/wi", "mlp/bi", "mlp/wo"),
                  ("moe/wi_gate", "moe/wi_up", "moe/wo")):
        if all(sharded(p) for p in group):
            keep |= set(group)
    if cfg.ssm is not None and all(sharded(p) for p in _MAMBA_TP):
        d_inner = cfg.ssm.expand * cfg.d_model
        if (d_inner // model) % cfg.ssm.head_dim == 0:
            keep |= set(_MAMBA_TP)
    return keep


class LMLayout:
    """One config's params on one mesh: the specs, this rank's blocks, the
    batch rows it takes, and the gathers a forward makes.

    ``specs`` holds each param's spec (``param_specs_abstract`` of the
    config's whole shapes).  A leaf rests as this rank's block of it
    (``shard``); ``gather_top``/``gather_layer`` give the forward its
    params: every ``data`` shard gathered (one flat collective a dtype,
    the matrices cast to the compute dtype first), every ``model`` shard
    too except those tensor parallelism keeps (``tp``: profile ``"2d"``,
    every family, ``_model_kept``; the vocab for every decoder-only
    family).  Batch rows split over ``batch`` (the profile's batch axes
    the mesh has: ``pod`` and ``data``, rank-major, as the reference's
    ``("pod", "data")``).  No rule names ``pod``: every param is
    replicated over it, and ``sync_grads`` sums its gradient there."""

    def __init__(self, cfg, mesh):
        from repro_torch.models import api
        from repro_torch.models.layers import dtype_of

        extra = set(mesh.mesh_dim_names) - {"pod", "data", "model"}
        if extra:
            raise ValueError(f"mesh dims {sorted(extra)}: the port trains on "
                             "meshes of pod, data and model dims")
        self.cfg, self.mesh = cfg, mesh
        self.data = mesh_axis(mesh, "data")
        self.model = mesh_axis(mesh, "model")
        self.batch = [a for a in (mesh_axis(mesh, n) for n in dp_spec(mesh))
                      if a is not None]
        self.dtype = dtype_of(cfg.dtype)
        self.specs = flat_specs(param_specs_abstract(api.param_shapes(cfg),
                                                     mesh))
        self.tp = profile() == "2d"
        self._kept = {}

    # ------------------------------------------------------------ specs
    def spec_of(self, key: str) -> Optional[tuple]:
        """The spec of the leaf at ``key``, a params path or one with a
        prefix (``0/...``, ``.mu/...`` in a ``(params, AdamState)``)."""
        parts = key.split("/")
        for i in range(len(parts)):
            spec = self.specs.get("/".join(parts[i:]))
            if spec is not None:
                return spec
        return None

    def _axis(self, name) -> Optional[MeshAxis]:
        return {"data": self.data, "model": self.model}.get(name)

    def attention_route(self, seq: Optional[int] = None
                        ) -> Tuple[Optional[str], Optional[MeshAxis]]:
        """How an attention block over ``seq`` q positions runs on this
        layout, the reference's ``shard_attn_act`` rule: ``("tp",
        model)`` under ``"2d"`` where the q heads divide ``model`` (each
        rank its heads; ``gather_layer`` keeps their shards), else
        ``("cp", model)`` where ``seq`` does (each rank its block of the
        q rows, ``models.attention.context_attention``), else ``(None,
        None)``: replicated over ``model``, as always under ``"fsdp"``.
        With no ``seq``, only the heads are asked."""
        m = self.model
        if not self.tp or m is None:
            return None, None
        if self.cfg.n_heads % m.size == 0:
            return "tp", m
        if seq is not None and seq % m.size == 0:
            return "cp", m
        return None, None

    # ------------------------------------------------------------ blocks
    def block(self, spec: tuple, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``t``, a copy."""
        for d, entry in enumerate(spec):
            axis = self._axis(entry)
            if axis is not None:
                t = _block_along(t, axis, d)
        return t.contiguous().clone()

    def whole(self, spec: tuple, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of this rank's block ``t`` (no autograd)."""
        for d, entry in enumerate(spec):
            axis = self._axis(entry)
            if axis is not None:
                t = _gather_along(t.detach(), axis, d)
        return t

    def shard(self, tree):
        """Each leaf of ``tree`` (params, or a tree holding params such
        as ``(params, AdamState)``) as this rank's block."""
        def one(key, leaf):
            spec = self.spec_of(key) if isinstance(leaf, torch.Tensor) \
                else None
            return leaf if spec is None else self.block(spec, leaf)
        return _map_path(one, tree)

    def gather(self, tree):
        """Whole copies of every sharded leaf of ``tree``, on every
        rank (a collective: every rank calls it)."""
        def one(key, leaf):
            spec = self.spec_of(key) if isinstance(leaf, torch.Tensor) \
                else None
            return leaf if spec is None else self.whole(spec, leaf)
        return _map_path(one, tree)

    # ------------------------------------------------------------- batch
    def rows(self, n: int) -> slice:
        """This rank's rows of an n-row batch."""
        shards, idx = 1, 0
        for axis in self.batch:
            shards *= axis.size
            idx = idx * axis.size + axis.rank
        if n % shards:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"{shards} ranks of the batch axes")
        per = n // shards
        return slice(idx * per, (idx + 1) * per)

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of every leaf of ``batch``."""
        return {k: v[self.rows(v.shape[0])] if getattr(v, "ndim", 0) else v
                for k, v in batch.items()}

    # ----------------------------------------------------------- gathers
    def _gather(self, items, keep, inside=()) -> Dict[str, torch.Tensor]:
        """{key: tensor} of ``items`` ((key, block, spec) triples) with the
        sharded dims gathered, ``keep``'s ``model`` shards kept and
        ``inside``'s ``data`` shards left to the code that uses them."""
        out = {k: t for k, t, _ in items}
        batch_names = {a.name for a in self.batch}
        for axis in (self.data, self.model):
            if axis is None:
                continue
            groups: Dict[Any, List[Tuple[str, int]]] = {}
            for k, _, spec in items:
                if axis.name not in spec or (axis is self.model
                                             and k in keep) or (
                        axis is self.data and k in inside):
                    continue
                t = out[k]
                dt = self.dtype if _cast_before_gather(k, t) else t.dtype
                groups.setdefault(dt, []).append((k, spec.index(axis.name)))
            for dt, group in groups.items():
                got = flat_gather([out[k] for k, _ in group],
                                  [d for _, d in group], axis, dt,
                                  axis.name in batch_names)
                out.update(zip((k for k, _ in group), got))
        return out

    def gather_top(self, params):
        """``params`` with its non-layer leaves ready for the forward
        (the layer stacks untouched): the vocab's ``model`` shards kept
        for a decoder-only family under ``"2d"``."""
        keep = set()
        if profile() == "2d" and self.cfg.family != "audio":
            keep = {"embed", "lm_head"}
        items = [(k, t, self.specs[k]) for k, t in flat_tree(
            {k: v for k, v in params.items() if k not in _STACKS})]
        got = self._gather(items, keep)
        return _rebuild(params, lambda k: got.get(k), skip=_STACKS)

    def gather_layer(self, lp, stack: str = "layers"):
        """One layer's params (views of its blocks, ``layers_of``) ready
        for its block: called inside the layer's checkpoint, so the
        recompute gathers again."""
        if stack not in self._kept:
            layer = {k[len(stack) + 1:]: s[1:] for k, s in self.specs.items()
                     if k.startswith(stack + "/")}
            keep = set()
            if self.tp and self.model is not None:
                keep = _model_kept(layer, self.cfg, self.model.size,
                                   self.attention_route()[0] == "tp")
            self._kept[stack] = (layer, keep)
        layer, keep = self._kept[stack]
        inside = ()
        if stack == "layers" and self.cfg.moe is not None:
            from repro_torch.models.moe import slab_gather_axis
            if slab_gather_axis(self.mesh, self.cfg.moe) is not None:
                inside = ("moe/wi_gate", "moe/wi_up", "moe/wo")
        items = [(k, t, layer[k]) for k, t in flat_tree(lp)]
        got = self._gather(items, keep, inside)
        return _rebuild(lp, lambda k: got[k])

    # ------------------------------------------------------------- grads
    def sync_grads(self, leaves: Sequence[torch.Tensor], keys: Sequence[str],
                   grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over each batch axis the gradients of the leaves that rest
        whole on it (each rank computed its rows' part), one flat f32
        all-reduce an axis; the gathered leaves' were summed by the
        gather's reduce-scatter."""
        for axis in self.batch:
            idx = [i for i, k in enumerate(keys)
                   if axis.name not in (self.spec_of(k) or ())]
            if not idx:
                continue
            flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
            all_reduce_sum(flat, axis)
            off = 0
            for i in idx:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view_as(grads[i]).to(
                    leaves[i].dtype)
                off += n
        return grads


def _rebuild(tree, get, prefix: str = "", skip=()):
    """``tree``'s dict structure with leaf ``k`` replaced by ``get(k)``;
    top-level keys in ``skip`` kept as they are."""
    if not isinstance(tree, dict):
        return get(prefix)
    return {k: (v if not prefix and k in skip else
                _rebuild(v, get, f"{prefix}/{k}" if prefix else k))
            for k, v in tree.items()}


_LAYOUTS: Dict[Any, LMLayout] = {}


def lm_layout(cfg, mesh=None) -> Optional[LMLayout]:
    """The layout of ``cfg`` on ``mesh`` (the active mesh by default);
    None with no mesh or one whose dims all have size 1: the unsharded
    path."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None or all(n == 1 for n in axis_sizes(mesh).values()):
        return None
    key = (cfg, id(mesh), profile())
    lay = _LAYOUTS.get(key)
    if lay is None or lay.mesh is not mesh:
        for k in [k for k, v in _LAYOUTS.items() if v.mesh is not mesh]:
            del _LAYOUTS[k]         # only the newest mesh's layouts stay
        lay = _LAYOUTS[key] = LMLayout(cfg, mesh)
    return lay
