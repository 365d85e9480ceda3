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

The LLM half of the reference (parameter rules, ``shard_act``, profiles,
``use_mesh``) waits for a later slice (ROADMAP.md, queue 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "reset_collectives", "shard_axis_name",
           "padded_rows", "pad_batch_rows", "resolve_batch_mesh",
           "resolve_train_mesh", "mesh_axis_size", "MeshAxis", "my_rows",
           "all_gather_rows", "gather_rows", "reduce_scatter_rows",
           "all_reduce_sum"]

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


def mesh_axis_size(mesh, name: Optional[str]) -> int:
    """The size of mesh dim ``name``; 1 for a dim the mesh lacks."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 1
    return int(mesh.size(names.index(name)))


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
