"""The port's side of ``tests/test_torch_llm_sharded.py``: LLM training,
``moe_forward_ep`` and the launcher on every rank of a spawned world
(``repro_torch.launch.mesh.run_ranks``), and the same training without a
mesh in the test process.  This module imports the port only (the ranks
never load JAX); inputs arrive as numpy arrays and results leave as
numpy arrays and plain numbers."""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.mesh import make_data_mesh, make_train_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.train.optimizer import adam_init, tree_leaves
from repro_torch.train.steps import make_train_step


def _mesh(shape):
    if shape is None:
        return None
    if len(shape) == 1:
        return make_data_mesh()
    return make_train_mesh(*shape)


def _flat(tree) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in sharding.flat_tree(tree)}


def _digest(flat: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _env(env):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def train(device, mesh, *, arch, params, batch, steps, lr, profile="2d",
          want_grads=False, env=None):
    """``steps`` train steps of ``arch`` from ``params`` (the reference's,
    numpy) on ``batch`` under ``mesh`` (None: unsharded): the metrics of
    every step, the whole params after them, a digest of those, and the
    faults of this rank's blocks (a block's shape not its spec's); with
    ``want_grads``, the first step's gradients, gathered whole; ``env``
    set in ``os.environ`` meanwhile."""
    cfg = get_config(arch)
    sharding.set_profile(profile)
    try:
        with sharding.use_mesh(mesh), _env(env or {}):
            lay = sharding.lm_layout(cfg)
            p = lm_params_from_jax(params, device=device)
            if lay is not None:
                p = lay.shard(p)
            opt = adam_init(p)
            step = make_train_step(cfg, lr=lr)
            tb = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in batch.items()}
            grads = None
            if want_grads:
                from repro_torch.train.steps import loss_and_grads
                _, _, g = loss_and_grads(p, cfg, tb)
                keys = [k for k, _ in sharding.flat_tree(p)]
                grads = dict(zip(keys, g))
                grads = _flat(lay.gather(grads) if lay is not None else grads)
            metrics = []
            for _ in range(steps):
                p, opt, m = step(p, opt, tb)
                metrics.append({k: float(v) for k, v in m.items()})
            faults = []
            if lay is not None:
                sizes = sharding.axis_sizes(mesh)
                shapes = {k: np.shape(v)
                          for k, v in sharding.flat_tree(params)}
                for k, t in sharding.flat_tree(p):
                    spec = lay.specs[k]
                    want = [n // sizes[e] if e is not None else n
                            for n, e in zip(shapes[k], spec)]
                    if list(t.shape) != want:
                        faults.append(f"{k}: block {list(t.shape)}, spec "
                                      f"{spec} gives {want}")
                whole = _flat(lay.gather(p))
            else:
                whole = _flat(p)
    finally:
        sharding.set_profile("2d")
    return {"metrics": metrics, "params": whole, "digest": _digest(whole),
            "faults": faults, "grads": grads}


def bf16_grads(device, mesh, *, arch, params, batch):
    """The first gradient of ``arch`` with bf16 compute (the config's
    ``dtype`` bfloat16; the params stay f32 masters) from ``params``:
    sharded on ``mesh`` and gathered whole, and unsharded; per leaf the
    distance of each from the unsharded f32 gradient at the same params
    and that gradient's norm; the three losses; a digest of the sharded
    gradient."""
    import dataclasses

    from repro_torch.train.steps import loss_and_grads
    cfg32 = get_config(arch)
    cfg = dataclasses.replace(cfg32, dtype="bfloat16")
    tb = {k: torch.from_numpy(np.asarray(v)).to(device)
          for k, v in batch.items()}
    fresh = lambda: lm_params_from_jax(params, device=device)
    l32, _, g32 = loss_and_grads(fresh(), cfg32, tb)
    l16, _, g16 = loss_and_grads(fresh(), cfg, tb)
    with sharding.use_mesh(mesh):
        lay = sharding.lm_layout(cfg)
        p = lay.shard(fresh())
        ls, _, gs = loss_and_grads(p, cfg, tb)
        keys = [k for k, _ in sharding.flat_tree(p)]
        gs = _flat(lay.gather(dict(zip(keys, gs))))
    dist = lambda a, b: float(np.linalg.norm(
        np.asarray(a, np.float64) - np.asarray(b, np.float64)))
    w = {k: g.detach().cpu().numpy() for k, g in zip(keys, g32)}
    u = {k: g.detach().cpu().numpy() for k, g in zip(keys, g16)}
    return {"losses": (float(ls), float(l16), float(l32)),
            "sharded": {k: dist(gs[k], w[k]) for k in keys},
            "unsharded": {k: dist(u[k], w[k]) for k in keys},
            "norm": {k: float(np.linalg.norm(w[k].astype(np.float64)))
                     for k in keys},
            "digest": _digest(gs), "faults": []}


def _expert_blocks(params, mesh, inside: bool):
    """The expert slabs as ``moe_forward_ep`` takes them: this rank's
    experts over ``model`` and, where it gathers them ``inside``, its
    block of d_model over ``data``."""
    axes = [(0, sharding.mesh_axis(mesh, "model"))]
    out = {"router": torch.from_numpy(np.asarray(params["router"]))}
    for name, d_dim in (("wi_gate", 1), ("wi_up", 1), ("wo", 2)):
        t = torch.from_numpy(np.asarray(params[name]))
        for dim, axis in axes + ([(d_dim, sharding.mesh_axis(mesh, "data"))]
                                 if inside else []):
            if axis is not None:
                n = t.shape[dim] // axis.size
                t = t.narrow(dim, axis.rank * n, n)
        out[name] = t.contiguous()
    return out


def moe_ep(device, mesh, *, params, cases):
    """``moe_forward_ep`` on this rank's rows of each case's x, under the
    case's ``REPRO_MOE_DISPATCH`` and ``REPRO_MOE_GATHER_INSIDE``: (y,
    aux) of each case."""
    out = []
    with sharding.use_mesh(mesh):
        rows = sharding.mesh_axis(mesh, "data")
        for x, cf, dispatch, inside in cases:
            blocks = {k: v.to(device) for k, v in _expert_blocks(
                params, mesh, inside).items()}
            moe = MoEConfig(num_experts=params["router"].shape[1], top_k=2,
                            capacity_factor=cf)
            x = torch.from_numpy(np.asarray(x)).to(device)
            if rows is not None:
                x = x[rows.block(x.shape[0])]
            with _env({"REPRO_MOE_DISPATCH": dispatch,
                       "REPRO_MOE_GATHER_INSIDE": str(int(inside))}):
                y, aux = moe_mod.moe_forward_ep(blocks, x, moe, mesh)
            out.append((y.detach().cpu().numpy(), float(aux)))
    return out


def launch(device, mesh, *, argv):
    """``launch.train``'s ``main`` on this rank: its standard output,
    whether the checkpoint it saved holds the world's gathered params,
    and whether it loads back into this rank's blocks bitwise."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, cfg, mesh = main(argv)
    path = argv[argv.index("--ckpt") + 1]
    with sharding.use_mesh(mesh):
        lay = sharding.lm_layout(cfg)
        whole = lay.gather(params)
        unsharded, _ = load_checkpoint(path, whole)
        blocks, _ = load_checkpoint(path, params, cfg=cfg)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b)))
    return {"log": buf.getvalue(), "whole_equals_ckpt": same(whole, unsharded),
            "blocks_reload_bitwise": same(blocks, params)}


SCENARIOS = {"train": train, "bf16": bf16_grads, "moe_ep": moe_ep,
             "launch": launch}


def world(device, plans: Dict[Any, List]):
    """Every plan of every mesh on this rank: {mesh: {key: result}}; a
    scenario that raises gives its message, so the others still run."""
    out = {}
    for shape, plan in plans.items():
        mesh = _mesh(shape)
        res = {}
        for key, kind, kwargs in plan:
            try:
                res[key] = SCENARIOS[kind](device, mesh, **kwargs)
            except Exception as e:          # reported by the test
                import traceback
                res[key] = RuntimeError(traceback.format_exc())
        out[shape] = res
    return out
