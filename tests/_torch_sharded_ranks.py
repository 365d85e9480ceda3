"""The port's side of ``tests/test_torch_sharded.py``: scenarios that run
on every rank of a spawned world (``repro_torch.launch.mesh.run_ranks``)
and, with no mesh, in the test process itself.  This module imports the
port only (the ranks never load JAX); inputs arrive as numpy arrays and
results leave as numpy arrays and plain numbers."""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core import splitnn as models
from repro_torch.core.coreset import cluster_coreset
from repro_torch.core.mpsi import MPSI
from repro_torch.core.splitnn import SplitNNConfig, evaluate, train_splitnn
from repro_torch.core.treecss import run_pipeline
from repro_torch.data.vertical import VerticalPartition
from repro_torch.interop import params_from_jax
from repro_torch.psi import engine
from repro_torch.sharding import resolve_batch_mesh, resolve_train_mesh

Part = Tuple[List[np.ndarray], np.ndarray, List[slice]]


def partition(raw: Part) -> VerticalPartition:
    feats, labels, slices = raw
    return VerticalPartition(list(feats), labels, list(slices))


@contextlib.contextmanager
def reference_init(init):
    """Start training from ``init`` (the reference's initial params, a
    numpy tree) instead of the port's own draws."""
    if init is None:
        yield
        return
    own = models.init_splitnn
    models.init_splitnn = lambda cfg, fd, device=None: params_from_jax(
        init, device)
    try:
        yield
    finally:
        models.init_splitnn = own


def flat_params(params) -> np.ndarray:
    from repro_torch.train.optimizer import tree_leaves
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tree_leaves(params)])


def _oprf(device, mesh, *, batch, sort):
    senders, receivers, seeds = batch
    rnd = engine.oprf_round(senders, receivers, seeds, options=AlignOptions(
        impl="ref", sort=sort, device=device, mesh=mesh))
    return {"inters": rnd.intersections, "shards": rnd.shards,
            "dispatches": rnd.dispatches}


def _match(device, mesh, *, batch):
    senders, receivers, _ = batch
    r_tags = [ids & engine.TAG_MASK for ids in receivers]
    s_tags = [ids & engine.TAG_MASK for ids in senders]
    rnd = engine.match_round(r_tags, receivers, s_tags, options=AlignOptions(
        impl="ref", device=device, mesh=mesh))
    return {"inters": rnd.intersections, "shards": rnd.shards}


def _tree_mpsi(device, mesh, *, sets, protocol):
    st = MPSI["tree"](sets, use_he=False, options=AlignOptions(
        protocol=protocol, psi_backend="device", impl="ref", device=device,
        mesh=mesh))
    return {"intersection": st.intersection, "total_bytes": st.total_bytes,
            "total_messages": st.total_messages, "rounds": st.rounds,
            "device_dispatches": st.device_dispatches}


def _coreset(device, mesh, *, part, k, seed, shard_axis=None):
    res = cluster_coreset(partition(part), k, seed=seed, device=device,
                          mesh=mesh, shard_axis=shard_axis)
    return {"indices": res.indices, "weights": res.weights,
            "shards": res.shards, "batched": res.batched,
            "assign": [c.assign for c in res.local],
            "sq_dist": [c.sq_dist for c in res.local],
            "centroids": [c.centroids.cpu().numpy() for c in res.local]}


def _train_out(rep, cfg, te):
    st = rep.engine_stats
    return {"losses": np.asarray(rep.losses), "epochs": rep.epochs,
            "steps": rep.steps, "comm_bytes": rep.comm_bytes,
            "params": flat_params(rep.params),
            "metric": None if te is None else evaluate(
                rep.params, cfg, partition(te)),
            "shards": st.shards, "model_shards": st.model_shards,
            "padded_batch": st.padded_batch,
            "host_syncs": st.host_syncs, "dispatches": st.dispatches,
            "steps_per_epoch": st.steps_per_epoch,
            "fused_gather": st.fused_gather,
            "gather_payload_bytes": st.gather_payload_bytes}


def _train(device, mesh, *, tr, te, cfg, init, bottom_impl="ref",
           fuse_gather=True, quant=None):
    cfg = SplitNNConfig(**cfg)
    with reference_init(init):
        rep = train_splitnn(partition(tr), cfg, options=EngineOptions(
            device=device, mesh=mesh, bottom_impl=bottom_impl,
            fuse_gather=fuse_gather, quant=quant))
    return _train_out(rep, cfg, te)


def _pipeline(device, mesh, *, tr, te, cfg, init, psi_backend="host",
              clusters=4):
    cfg = SplitNNConfig(**cfg)
    with reference_init(init):
        rep = run_pipeline(
            partition(tr), partition(te), cfg, variant="treecss",
            clusters_per_client=clusters, seed=0,
            options=EngineOptions(device=device, mesh=mesh),
            align=AlignOptions(psi_backend=psi_backend))
    st = rep.train.engine_stats
    return {"intersection": rep.mpsi.intersection,
            "total_bytes": rep.mpsi.total_bytes, "n_train": rep.n_train,
            "indices": rep.coreset.indices, "weights": rep.coreset.weights,
            "coreset_shards": rep.coreset.shards, "metric": rep.metric,
            "losses": np.asarray(rep.train.losses),
            "epochs": rep.train.epochs, "steps": rep.train.steps,
            "comm_bytes": rep.train.comm_bytes,
            "shards": None if st is None else st.shards,
            "model_shards": None if st is None else st.model_shards,
            "host_syncs": None if st is None else st.host_syncs}


def _refusals(device, mesh, *, tr, cfg):
    """What a misuse raises: each case's exception type and message."""
    cfg = SplitNNConfig(**cfg)
    out = {}
    cases = {
        "loop_on_model_axis": lambda: train_splitnn(
            partition(tr), cfg, options=EngineOptions(
                device=device, mesh=mesh, bottom_impl="loop")),
        "loop_engine_on_mesh": lambda: train_splitnn(
            partition(tr), cfg, options=EngineOptions(
                device=device, mesh=mesh, train_engine="loop")),
        "batch_axis_typo": lambda: resolve_batch_mesh(mesh, "dat"),
        "train_axis_typo": lambda: resolve_train_mesh(mesh, "dat"),
        "coreset_axis": lambda: cluster_coreset(
            partition(tr), 4, seed=0, device=device, mesh=mesh,
            shard_axis="modle"),
    }
    for name, call in cases.items():
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def _resolve(device, mesh):
    """``resolve_*_mesh`` on ``mesh``, without the mesh object."""
    b = resolve_batch_mesh(mesh)
    t = resolve_train_mesh(mesh)
    return {"batch": b[1:], "train": t[1:], "batch_none": b[0] is None,
            "train_none": t[0] is None}


SCENARIOS = {"oprf": _oprf, "match": _match, "tree_mpsi": _tree_mpsi,
             "coreset": _coreset, "train": _train, "pipeline": _pipeline,
             "refusals": _refusals, "resolve": _resolve}


def run(device, mesh, plan: Sequence[Tuple[str, str, Dict[str, Any]]]):
    """Run ``plan``'s (key, scenario, kwargs) on ``mesh`` (None: the
    unsharded path) -> {key: result}."""
    return {key: SCENARIOS[name](device, mesh, **kw)
            for key, name, kw in plan}


def world(device, plans: Dict[str, Sequence]):
    """One rank's part of a world: build every mesh (each rank the same,
    in the same order), then run each mesh's plan.  ``plans`` maps a
    mesh name ("data": all ranks, "one": rank 0 alone, "host": the
    (1, 1) mesh, "2x4": the (data 2, model 4) grid) to its plan."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_data_mesh, make_host_mesh,
                                         make_train_mesh)
    torch.set_num_threads(1)
    meshes = {"data": make_data_mesh(), "one": make_data_mesh(1),
              "host": make_host_mesh()}
    if dist.get_world_size() == 8:
        meshes["2x4"] = make_train_mesh(2, 4)
    return {name: run(device, meshes[name], plan)
            for name, plan in plans.items()}


def raise_on_rank_1(device):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return dist.get_rank()


def hang(device):
    import time
    time.sleep(600)
