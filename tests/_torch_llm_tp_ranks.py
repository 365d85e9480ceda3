"""The port's side of ``tests/test_torch_llm_tp.py``: training of the
ssm, hybrid, vlm and audio families (and variants of their configs) on
every rank of a spawned world (``repro_torch.launch.mesh.run_ranks``),
with the probes the test holds to its formulas: each layer stack's
kept leaves and gathered shapes, the bytes of one layer's gather, and
the collectives of one train step.  This module imports the port only
(the ranks never load JAX); inputs arrive as numpy arrays and results
leave as numpy arrays and plain numbers."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from _torch_llm_sharded_ranks import _digest, _flat, launch
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.mesh import make_pod_mesh, make_train_mesh
from repro_torch.models.layers import layers_of
from repro_torch.train.optimizer import adam_init
from repro_torch.train.steps import loss_and_grads, make_train_step

STACKS = ("layers", "enc_layers", "dec_layers")


def config(arch: str, over=None, ssm_over=None):
    """``arch``'s config with the fields of ``over`` replaced, and those
    of its ``SSMConfig`` in ``ssm_over``."""
    cfg = get_config(arch)
    over = dict(over or {})
    if ssm_over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **ssm_over)
    return dataclasses.replace(cfg, **over) if over else cfg


def _mesh(shape):
    return make_train_mesh(*shape) if len(shape) == 2 else \
        make_pod_mesh(*shape)


def _probe_layers(lay, params) -> Dict[str, Any]:
    """Per layer stack: the leaves kept over ``model`` (``LMLayout``'s
    choice), every leaf's shape as ``gather_layer`` hands it to layer 0,
    and the collectives and bytes of that one gather."""
    out = {}
    for stack in STACKS:
        if stack not in params:
            continue
        lp = layers_of(params[stack], 1)[0]
        sharding.reset_collectives()
        with torch.no_grad():
            got = lay.gather_layer(lp, stack)
        out[stack] = {"kept": sorted(lay._kept[stack][1]),
                      "shapes": {k: tuple(v.shape)
                                 for k, v in sharding.flat_tree(got)},
                      "calls": sharding.COLLECTIVES["calls"],
                      "bytes": sharding.COLLECTIVES["bytes"]}
    return out


def train(device, mesh, *, arch, over, ssm_over, params, batch, steps, lr,
          profile):
    """``steps`` train steps of ``arch`` (with ``over``/``ssm_over``)
    from ``params`` (the reference's, numpy) on ``batch`` under ``mesh``
    (None: unsharded): the metrics of every step, the first gradients
    and the params after the steps gathered whole, a digest of those,
    the faults of this rank's blocks (a block's shape not its spec's),
    the layer probes (``_probe_layers``) and the collectives of the
    first train step."""
    cfg = config(arch, over, ssm_over)
    sharding.set_profile(profile)
    try:
        with sharding.use_mesh(mesh):
            lay = sharding.lm_layout(cfg)
            p = lm_params_from_jax(params, device=device)
            probes = {}
            if lay is not None:
                p = lay.shard(p)
                probes = _probe_layers(lay, p)
            tb = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in batch.items()}
            _, _, g = loss_and_grads(p, cfg, tb)
            keys = [k for k, _ in sharding.flat_tree(p)]
            grads = dict(zip(keys, g))
            grads = _flat(grads if lay is None else lay.gather(grads))
            opt = adam_init(p)
            step = make_train_step(cfg, lr=lr)
            metrics, step_calls = [], None
            for _ in range(steps):
                sharding.reset_collectives()
                p, opt, m = step(p, opt, tb)
                if step_calls is None:
                    step_calls = sharding.COLLECTIVES["calls"]
                metrics.append({k: float(v) for k, v in m.items()})
            faults = []
            if lay is not None:
                sizes = sharding.axis_sizes(mesh)
                shapes = {k: np.shape(v)
                          for k, v in sharding.flat_tree(params)}
                for k, t in sharding.flat_tree(p):
                    want = [n // sizes[e] if e is not None else n
                            for n, e in zip(shapes[k], lay.specs[k])]
                    if list(t.shape) != want:
                        faults.append(f"{k}: block {list(t.shape)}, spec "
                                      f"{lay.specs[k]} gives {want}")
            whole = _flat(p if lay is None else lay.gather(p))
    finally:
        sharding.set_profile("2d")
    return {"metrics": metrics, "params": whole, "digest": _digest(whole),
            "faults": faults, "grads": grads, "probes": probes,
            "step_calls": step_calls}


SCENARIOS = {"train": train, "launch": launch}


def world(device, plans: Dict[Any, List]):
    """Every plan of every mesh on this rank: {mesh: {key: result}}; a
    scenario that raises gives its message, so the others still run.
    One torch thread a rank: the ranks share the test run's cores."""
    torch.set_num_threads(1)
    out = {}
    for shape, plan in plans.items():
        mesh = _mesh(shape)
        res = {}
        for key, kind, kwargs in plan:
            try:
                res[key] = SCENARIOS[kind](device, mesh, **kwargs)
            except Exception:               # reported by the test
                import traceback
                res[key] = RuntimeError(traceback.format_exc())
        out[shape] = res
    return out
