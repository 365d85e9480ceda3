"""VFL training engines on one device (paper §3 training stage): the port
of ``repro.train.vfl``.

``train_scan`` — the epoch engine.  The reference runs an epoch as one
compiled ``lax.scan``; here it is a Python loop over the epoch's steps
in which every step is launched asynchronously: the minibatch gather
fuses into the bottom pass (K2, ``fuse_gather=True``), then the top
model, the Eq.(2) loss, the backward and Adam, and the step loss adds
into a device tensor.  The epoch's schedule goes to the device in one
copy before its first step, and the host syncs exactly once per epoch,
on the ``float(loss)`` that feeds the paper's convergence window.
``EngineStats.dispatches`` counts one per epoch-function call, as the
reference counts its one compiled dispatch.  Remainder batches are
padded to the step shape and masked out through the Eq.(2) sample
weights (w = 0 rows contribute exactly 0.0 to every loss sum and
gradient), so the last ``n mod bs`` rows train.  The M-client bottom
layer is one block-diagonal slab pass (``kernels/splitnn_bottom``).

``train_loop`` — the per-minibatch host loop (one sync per step), kept
as the parity oracle, as in the reference.

``EngineOptions.quant`` ("int8"|"fp8", DESIGN.md §12) narrows the
activation send to a 1-byte wire dtype: on one device the bottom
activations take the wire rounding of ``quant.fake_quantize`` (an
identity backward), inside the bottom pass's one launch.  Under int8 the
bottom GEMM itself runs on the int8 kernels (K10 in training, K9 in
evaluation and serving), in their wire form: the weights' column
quantizer (every step), K9's row quantizer and the wire rounding run
inside the launch.  The slab's int8 rows are loop-invariant, so
``train_scan`` quantizes them once per run, as the reference's hoisted
per-step quantization does, and K10 gathers them and their scales.  fp8
is comm-only: the GEMM stays f32, on K1/K2's fp8 wire form (K2 in
training, K1 in evaluation and serving), whose epilogue rounds.

With ``EngineOptions.mesh`` the engine shards over a 1-D ``("data",)``
or 2-D ``("data", "model")`` mesh (``sharding.resolve_train_mesh``), one
process a rank, every rank running the same loop:

- ``data`` shards the step's batch columns (the batch pads to a multiple
  of the dim's size; the padded columns are weighted out).  Each rank
  forms the unnormalized loss sum S = Σ w·l and weight sum W of its
  columns and their gradients; S, W and the gradients are all-reduced
  in one flat buffer and divided by max(W, 1e-12), so every rank takes
  the same replicated Adam step, within the all-reduce's reassociation
  of the unsharded one (not bitwise, unlike the PSI and coreset
  shards).
- ``model`` shards the M-client bottom: the clients pad to a multiple of
  the dim's size with all-zero dummies, and each rank holds a contiguous
  block of them (their weights, their Adam moments, their slab).  The
  clients' activation send is ONE all-gather a step
  (``sharding.gather_rows``, or ``quant.all_gather_quantized`` under a
  wire), whose backward is the sum reduce-scatter.  The label owner's
  loss counts on model rank 0 only (the others multiply theirs by 0.0),
  so the bottom gradients all-reduce over ``data`` only, and the top's,
  S and W over both dims.
- One host sync an epoch still, on every rank; ``comm_bytes``,
  ``steps_per_epoch`` and ``gather_payload_bytes`` are the unsharded
  run's; the returned params are whole (the model blocks gathered).

Left out, being TPU-only: the slab's 128-lane pre-padding (``d_eff``:
the CUDA kernels take unpadded widths) and the warm-up compile epoch
with its ``train.compile`` span (nothing compiles: the kernels are
built once per process, at first use).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import (EngineOptions, resolve_bottom_impl,
                                resolve_device, resolve_impl)
from repro_torch.kernels.splitnn_bottom.ops import int8_rows, splitnn_bottom
from repro_torch.obs.metrics import StatsMixin
from repro_torch.obs.trace import span
from repro_torch.quant import (all_gather_quantized, payload_bytes,
                               resolve_quant, scale_bytes_per_step)
from repro_torch.sharding import (MeshAxis, all_gather_rows, all_reduce_sum,
                                  gather_rows, padded_rows,
                                  resolve_train_mesh)
from repro_torch.train.losses import (binary_xent_terms, softmax_xent_terms,
                                      squared_error_terms)
from repro_torch.train.optimizer import (adam_init, adam_update, tree_leaves,
                                         tree_map)

__all__ = ["EngineStats", "TrainReport", "pack_slab", "pack_slab_params",
           "unpack_slab_params", "forward_slab_packed", "forward_slab_eval",
           "make_score_step", "epoch_schedule", "train_scan", "train_loop"]


# ------------------------------------------------------------------ reports


@dataclasses.dataclass
class EngineStats(StatsMixin):
    """Measured execution counts for one training run.

    ``dispatches`` counts epoch-function calls in the timed training
    loop and ``host_syncs`` blocking device→host transfers: one of each
    per epoch for the epoch engine, one of each per minibatch for the
    loop (a gloo group's staging of CUDA tensors through host memory is
    the transport's, counted in ``sharding.COLLECTIVES``).
    ``shards``/``model_shards`` are the (data, model) mesh sizes the run
    sharded over (1 unsharded); ``quant`` is the activation wire dtype
    and ``gather_payload_bytes`` the modeled per-step forward activation
    payload at the logical batch size."""
    dispatches: int = 0
    host_syncs: int = 0
    shards: int = 1
    steps_per_epoch: int = 0
    padded_batch: int = 0
    engine: str = "scan"
    bottom_impl: str = "ref"
    model_shards: int = 1
    fused_gather: bool = False
    quant: str = "none"
    gather_payload_bytes: int = 0

    CONTRACT_FIELDS = ("dispatches", "host_syncs", "steps_per_epoch")


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    epochs: int
    steps: int
    train_seconds: float          # measured compute
    comm_bytes: int               # instance-wise activation/grad traffic
    simulated_comm_seconds: float
    params: Any
    engine_stats: Optional[EngineStats] = None


# ------------------------------------------------------------ slab params


def pack_slab(features: Sequence[np.ndarray], m_pad: int = 0) -> np.ndarray:
    """Stack per-client (N, d_m) slices into the (M, N, d_max) slab;
    ``m_pad`` > M appends all-zero dummy clients."""
    m = len(features)
    n = features[0].shape[0]
    d_max = max(f.shape[1] for f in features)
    slab = np.zeros((max(m, m_pad), n, d_max), np.float32)
    for i, f in enumerate(features):
        slab[i, :, :f.shape[1]] = f
    return slab


def pack_slab_params(params, d_max: int, m_pad: int = 0):
    """Model-zoo params → the slab form ``{"bw": (Mp, d_max, o),
    ["bb": (Mp, o)], "top": {...}}``: the per-client bottom blocks
    zero-padded to the widest client and stacked.  Zero padding is
    exact and stays zero through Adam (zero features give zero
    gradients).  ``bb`` exists only when the zoo model has bottom biases
    (mlp).  The result owns its tensors (the top leaves are copied), so
    training it in place leaves ``params`` as they were."""
    ws = [bp["w"] for bp in params["bottoms"]]
    m = len(ws)
    mp = max(m, m_pad)
    o = ws[0].shape[1]
    dev = ws[0].device
    with torch.no_grad():
        w = torch.zeros((mp, d_max, o), dtype=torch.float32, device=dev)
        for i, wm in enumerate(ws):
            w[i, :wm.shape[0], :] = wm
        packed = {"bw": w, "top": tree_map(
            lambda t: t.detach().float().clone(), params["top"])}
        if "b" in params["bottoms"][0]:
            bb = torch.zeros((mp, o), dtype=torch.float32, device=dev)
            bb[:m] = torch.stack([bp["b"] for bp in params["bottoms"]])
            packed["bb"] = bb
    return packed


def unpack_slab_params(packed, feature_dims: Sequence[int]):
    """Slab-form params → model-zoo params (exact slices, detached
    copies; the inverse of ``pack_slab_params`` for the real clients)."""
    own = lambda t: t.detach().clone()
    bottoms = []
    for i, d in enumerate(feature_dims):
        bp = {"w": own(packed["bw"][i, :d, :])}
        if "bb" in packed:
            bp["b"] = own(packed["bb"][i])
        bottoms.append(bp)
    return {"bottoms": bottoms, "top": tree_map(own, packed["top"])}


# ------------------------------------------------------------ slab forward


def _bottom_acts(packed, cfg, m: Optional[int], x_slab, bottom_impl, idx,
                 quant, x_int8=None):
    """The first ``m`` clients' bottom activations (all of them, dummy
    clients included, where ``m`` is None)."""
    w = packed["bw"]
    b = packed.get("bb")
    if b is None:     # bias-free models: a constant zero, no phantom param
        b = torch.zeros((w.shape[0], w.shape[2]), dtype=torch.float32,
                        device=w.device)
    acts = splitnn_bottom(x_slab, w, b, cfg.model == "mlp", bottom_impl, idx,
                          quant, x_int8)        # the wire rounding included
    return acts[:m]                              # drop dummy-client padding


def _top_mlp(top, acts: torch.Tensor) -> torch.Tensor:
    m, bsz, o = acts.shape
    # (M, B, o) -> (B, M*o): the layout of concatenating per-client acts
    h = acts.transpose(0, 1).reshape(bsz, m * o)
    h = torch.relu(h @ top["w1"] + top["b1"])
    return h @ top["w2"] + top["b2"]


def forward_slab_packed(packed, cfg, m: int, x_slab: torch.Tensor, *,
                        bottom_impl: Optional[str] = None,
                        idx: Optional[torch.Tensor] = None,
                        quant: Optional[str] = None,
                        x_int8=None,
                        model_axis: Optional[MeshAxis] = None
                        ) -> torch.Tensor:
    """SplitNN forward from slab-form params.  ``x_slab`` is the
    (M, B, d_max) batch slab — or, with ``idx`` (B,) int32, the FULL
    (M, N, d_max) slab whose minibatch gather fuses into the bottom pass
    (K2; K10 under int8).  Matches ``splitnn_forward`` on the per-client
    slices up to GEMM summation order.  ``quant`` applies the wire
    rounding to the bottom pass's output, inside the pass; ``x_int8`` is
    ``int8_rows(x_slab)`` where the caller has it.  ``model_axis`` names
    the mesh dim the clients are sharded over: ``packed`` and ``x_slab``
    then hold this rank's block of clients, and the activation send is
    one all-gather over it (quantized under ``quant``); dummy clients
    are dropped after it."""
    acts = _bottom_acts(packed, cfg, None, x_slab, bottom_impl, idx, quant,
                        x_int8)
    if model_axis is not None:
        acts = (gather_rows(acts, model_axis) if quant is None
                else all_gather_quantized(acts, model_axis, quant))
    acts = acts[:m]                              # drop dummy-client padding
    if cfg.model in ("lr", "linreg"):
        return acts.sum(0) + packed["top"]["b"]
    return _top_mlp(packed["top"], acts)


def forward_slab_eval(packed, cfg, m: int, x_slab: torch.Tensor, *,
                      bottom_impl: Optional[str] = None,
                      quant: Optional[str] = None) -> torch.Tensor:
    """Serving/eval slab forward: the same bottom pass (K1; K9 under
    int8) and the same wire rounding as quantized training, with the
    lr/linreg client sum unrolled left to right as
    ``splitnn_forward``'s ``sum`` folds it."""
    acts = _bottom_acts(packed, cfg, m, x_slab, bottom_impl, None, quant)
    if cfg.model in ("lr", "linreg"):
        out = acts[0]
        for i in range(1, m):
            out = out + acts[i]
        return out + packed["top"]["b"]
    return _top_mlp(packed["top"], acts)


def make_score_step(params, cfg, feature_dims: Sequence[int], *,
                    bottom_impl: Optional[str] = None,
                    quant: Optional[str] = None):
    """``TrainReport.params`` (model-zoo form) → ``(packed,
    score_step)``: the slab-params handoff for serving.  ``packed``
    reuses ``pack_slab_params``, so serving and training share one
    parameter layout.  ``score_step(packed, x_slab)`` maps an (M, B,
    d_max) slab on the params' device to (B, o) outputs, without
    autograd; ``score_step.bottom_impl`` names the implementation it
    runs (``None`` picks by that device).  The kernel's tile is its own,
    so the reference's ``block_b`` is gone.  ``quant`` scores under the
    wire rounding a model trained with that ``quant`` saw
    (``score_step.quant`` holds the resolved dtype)."""
    quant = resolve_quant(quant)
    fd = tuple(int(d) for d in feature_dims)
    packed = pack_slab_params(params, max(fd))
    impl = resolve_impl(bottom_impl, resolve_device(packed["bw"].device))
    m = len(fd)

    def score_step(packed, x_slab: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return forward_slab_eval(packed, cfg, m, x_slab,
                                     bottom_impl=impl, quant=quant)
    score_step.bottom_impl = impl
    score_step.quant = quant
    return packed, score_step


# ------------------------------------------------------------- scheduling


def epoch_schedule(order: np.ndarray, n: int, bs: int, steps: int,
                   padded_bs: int) -> Tuple[np.ndarray, np.ndarray]:
    """(idx (steps, padded_bs) i32, mask (steps, padded_bs) f32) for one
    epoch's permutation ``order``.  Rows past n point at row 0 with mask
    0 — they are gathered and forwarded but weighted out of every loss
    sum and gradient, which is how the remainder batch trains without a
    second step shape."""
    idx = np.zeros((steps * bs,), np.int32)
    idx[:n] = order
    mask = np.zeros((steps * bs,), np.float32)
    mask[:n] = 1.0
    idx = idx.reshape(steps, bs)
    mask = mask.reshape(steps, bs)
    if padded_bs > bs:
        pad = padded_bs - bs
        idx = np.concatenate(
            [idx, np.zeros((steps, pad), np.int32)], axis=1)
        mask = np.concatenate(
            [mask, np.zeros((steps, pad), np.float32)], axis=1)
    return idx, mask


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device, without a sync on CUDA (pinned staging, so
    the copy queues behind the work already launched)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _labels(partition, cfg, device) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(partition.labels),
        dtype=torch.float32 if cfg.n_classes == 0 else torch.int64,
        device=device)


# ---------------------------------------------------------- epoch engine


def _loss_sums(out: torch.Tensor, cfg, y: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized Eq.(2) pieces (Σ w·l_i, Σ w) of a rank's rows, with
    the losses' own per-sample terms: their all-reduced quotient is the
    unsharded loss up to reassociation."""
    if cfg.n_classes == 0:
        li = squared_error_terms(out[:, 0:1], y[:, None])
    elif cfg.n_classes == 2 and out.shape[-1] == 1:
        li = binary_xent_terms(out[:, 0], y)
    else:
        li = softmax_xent_terms(out, y)
    w = w.float()
    return (w * li).sum(), w.sum()


def _sharded_step_grads(out, cfg, y, w, leaves, n_bottom: int,
                        data_axis: Optional[MeshAxis],
                        model_axis: Optional[MeshAxis]):
    """(loss, grads) of a sharded step: the rank's unnormalized sums and
    their gradients, all-reduced in one flat buffer (the bottom leaves,
    the first ``n_bottom``, over ``data``; the rest, S and W over
    ``data`` and ``model``), then divided by max(W, 1e-12)."""
    s, wsum = _loss_sums(out, cfg, y, w)
    if model_axis is not None and model_axis.rank != 0:
        # the label owner is model rank 0: the other ranks' copies are
        # 0.0, so the gather's transpose carries rank 0's cotangent only
        s, wsum = s * 0.0, wsum * 0.0
    grads = torch.autograd.grad(s, leaves)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [s.detach().reshape(1), wsum.detach().reshape(1)])
    if data_axis is not None:
        all_reduce_sum(flat, data_axis)
    if model_axis is not None:
        all_reduce_sum(flat[sum(t.numel() for t in leaves[:n_bottom]):],
                       model_axis)
    wtot = flat[-1].clamp_min(1e-12)
    parts = torch.split(flat[:-2] / wtot, [t.numel() for t in leaves])
    return flat[-2] / wtot, [g.view_as(t) for g, t in zip(parts, leaves)]


def train_scan(partition, cfg, *, sample_weights: Optional[np.ndarray] = None,
               bandwidth: float = 10e9 / 8, latency: float = 2e-4,
               options: Optional[EngineOptions] = None,
               verbose: bool = False) -> TrainReport:
    """Mini-batch Adam training to the paper's convergence criterion —
    one epoch-function call and one host sync per EPOCH.

    ``options.bottom_impl``: ``"kernel"`` (the CUDA kernels, K2 in
    training), ``"ref"`` (their plain versions), ``"loop"`` (per-client
    GEMMs on the zoo params, the parity oracle for the slab layout);
    ``None`` picks ``"kernel"`` on CUDA and ``"ref"`` on the CPU.
    ``fuse_gather`` fuses the step's ``slab[:, idx]`` gather into the
    bottom pass (bitwise-equal to ``False``, which gathers first).
    ``options.quant`` ("int8"|"fp8") narrows the activation send (module
    docstring); it needs the slab bottom path.  ``options.device`` places
    everything (default CUDA); ``options.mesh``/``shard_axis`` shard the
    batch over ``data`` and the clients over ``model`` (module
    docstring; ``"loop"`` cannot take a ``model`` dim and raises)."""
    from repro_torch.core import splitnn as models

    options = options or EngineOptions()
    device = resolve_device(options.device)
    impl = resolve_bottom_impl(options.bottom_impl, device)
    use_slab = impl != "loop"
    fuse = use_slab and bool(options.fuse_gather)
    quant = resolve_quant(options.quant)
    mesh, data_name, n_data, model_name, n_model = resolve_train_mesh(
        options.mesh, options.shard_axis)
    if n_model > 1 and not use_slab:
        raise ValueError(
            "model-axis sharding needs the slab bottom path "
            "(bottom_impl='kernel'|'ref'), not 'loop'")
    if quant is not None and not use_slab:
        raise ValueError(
            "quantized activations need the slab bottom path "
            "(bottom_impl='kernel'|'ref'), not 'loop'")
    data_axis = MeshAxis(mesh, data_name) if n_data > 1 else None
    model_axis = MeshAxis(mesh, model_name) if n_model > 1 else None

    n = partition.n_samples
    m = partition.n_clients
    feature_dims = [f.shape[1] for f in partition.client_features]
    # this rank's clients: all of them, or its block of the model dim
    m_pad = padded_rows(m, n_model)
    mine = model_axis.block(m_pad) if model_axis else slice(0, m_pad)

    zoo = models.init_splitnn(cfg, feature_dims, device=device)
    if use_slab:
        params = pack_slab_params(zoo, max(feature_dims), m_pad)
        if model_axis is not None:
            params = {k: v if k == "top" else v[mine].clone()
                      for k, v in params.items()}
    else:
        params = zoo
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    n_bottom = len(tree_leaves({k: v for k, v in params.items()
                                if k != "top"}))
    opt = adam_init(params)

    y_all = _labels(partition, cfg, device)
    w_np = (np.asarray(sample_weights, np.float32)
            if sample_weights is not None else np.ones(n, np.float32))
    w_all = torch.as_tensor(w_np, device=device)
    if use_slab:
        data = [torch.as_tensor(
            pack_slab(partition.client_features, m_pad)[mine], device=device)]
    else:
        data = [torch.as_tensor(np.asarray(f, np.float32), device=device)
                for f in partition.client_features]

    bs = min(cfg.batch_size, n)
    steps_per_epoch = -(-n // bs)
    padded_bs = padded_rows(bs, n_data)
    # this rank's columns of every step
    cols = data_axis.block(padded_bs) if data_axis else slice(0, padded_bs)
    # the slab's int8 rows and their scales, once per run (loop-invariant)
    x_int8 = int8_rows(data[0]) if fuse and quant == "int8" else None

    def step_out(ib: torch.Tensor) -> torch.Tensor:
        if not use_slab:
            return models.splitnn_forward(
                params, cfg, [x.index_select(0, ib) for x in data])
        if fuse:
            return forward_slab_packed(params, cfg, m, data[0],
                                       bottom_impl=impl, idx=ib, quant=quant,
                                       x_int8=x_int8, model_axis=model_axis)
        return forward_slab_packed(params, cfg, m,
                                   data[0].index_select(1, ib),
                                   bottom_impl=impl, quant=quant,
                                   model_axis=model_axis)

    def step_grads(ib: torch.Tensor, mb: torch.Tensor):
        y = y_all.index_select(0, ib)
        w = w_all.index_select(0, ib) * mb
        out = step_out(ib)
        if mesh is None:
            loss = models._loss_from_out(out, cfg, y, w)
            return loss, torch.autograd.grad(loss, leaves)
        return _sharded_step_grads(out, cfg, y, w, leaves, n_bottom,
                                   data_axis, model_axis)

    rng = np.random.default_rng(cfg.seed)
    # the forward activation ships in the wire dtype; a quantized
    # payload's exponent bytes are per STEP (they scale with row blocks)
    per_sample = models.activation_bytes_per_sample(cfg, m, quant)
    per_epoch_bytes = (per_sample * n
                       + steps_per_epoch * scale_bytes_per_step(bs, m, quant))
    stats = EngineStats(shards=n_data, steps_per_epoch=steps_per_epoch,
                        padded_batch=padded_bs, engine="scan",
                        bottom_impl=impl, model_shards=n_model,
                        fused_gather=fuse, quant=quant or "none",
                        gather_payload_bytes=payload_bytes(
                            models.activation_width(cfg), bs, m, quant))
    losses: List[float] = []
    comm_bytes = 0
    total_steps = 0
    epoch = 0
    t0 = time.perf_counter()
    for epoch in range(1, cfg.max_epochs + 1):
        order = rng.permutation(n)
        idx, mask = epoch_schedule(order, n, bs, steps_per_epoch, padded_bs)
        # the epoch span brackets the ONE epoch call + ONE host sync; it
        # reads the host clock only, so the counts are the same traced
        # or not
        with span("train.epoch", epoch=epoch, engine="scan",
                  steps=steps_per_epoch, comm_bytes=per_epoch_bytes) as sp:
            with span("train.copy"):
                idx_d = _to_device(idx, device)
                mask_d = _to_device(mask, device)
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for s in range(steps_per_epoch):
                with span("train.grads"):
                    loss, grads = step_grads(idx_d[s, cols],
                                             mask_d[s, cols])
                with span("train.adam"):
                    params, opt = adam_update(params, grads, opt, lr=cfg.lr)
                acc = acc + loss.detach()
            stats.dispatches += 1
            with span("train.sync"):
                losses.append(float(acc / steps_per_epoch))  # the one sync
            stats.host_syncs += 1
            sp.set(loss=losses[-1])
        total_steps += steps_per_epoch
        comm_bytes += per_epoch_bytes   # every row trains, remainder too
        if verbose and epoch % 10 == 0:
            print(f"  epoch {epoch}: loss {losses[-1]:.5f}")
        wlen = cfg.convergence_window
        if len(losses) > wlen:
            if abs(losses[-1 - wlen] - losses[-1]) < cfg.convergence_eps:
                break
    train_seconds = time.perf_counter() - t0
    sim_comm = comm_bytes / bandwidth + latency * 2 * total_steps * m
    if model_axis is not None:          # whole params on every rank
        params = {k: v if k == "top" else all_gather_rows(v.detach(),
                                                          model_axis)
                  for k, v in params.items()}
    out_params = (unpack_slab_params(params, feature_dims) if use_slab
                  else tree_map(lambda t: t.detach().clone(), params))
    return TrainReport(losses=losses, epochs=epoch, steps=total_steps,
                       train_seconds=train_seconds, comm_bytes=comm_bytes,
                       simulated_comm_seconds=sim_comm, params=out_params,
                       engine_stats=stats)


# ----------------------------------------------------------- legacy loop


def train_loop(partition, cfg, *, sample_weights: Optional[np.ndarray] = None,
               bandwidth: float = 10e9 / 8, latency: float = 2e-4,
               verbose: bool = False, device=None) -> TrainReport:
    """Per-minibatch host loop: one blocking sync per step, per-client
    GEMMs on the zoo params.  The epoch engine's parity oracle; every
    row trains (the last ``n mod bs`` rows as a short batch) and
    ``comm_bytes`` counts the rows actually shipped.  It communicates
    f32 only (``train_splitnn`` refuses a quant for it)."""
    from repro_torch.core import splitnn as models

    device = resolve_device(device)
    n = partition.n_samples
    m = partition.n_clients
    feature_dims = [f.shape[1] for f in partition.client_features]
    params = models.init_splitnn(cfg, feature_dims, device=device)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = adam_init(params)

    y_all = _labels(partition, cfg, device)
    xs_all = [torch.as_tensor(np.asarray(f, np.float32), device=device)
              for f in partition.client_features]
    w_all = (torch.as_tensor(np.asarray(sample_weights, np.float32),
                             device=device)
             if sample_weights is not None else None)

    rng = np.random.default_rng(cfg.seed)
    bs = min(cfg.batch_size, n)
    per_sample = models.activation_bytes_per_sample(cfg, m, None)
    stats = EngineStats(steps_per_epoch=-(-n // bs), padded_batch=bs,
                        engine="loop", bottom_impl="loop",
                        gather_payload_bytes=payload_bytes(
                            models.activation_width(cfg), bs, m, None))
    losses: List[float] = []
    comm_bytes = 0
    total_steps = 0
    t0 = time.perf_counter()
    epoch = 0
    for epoch in range(1, cfg.max_epochs + 1):
        order = rng.permutation(n)
        ep_loss, nb = 0.0, 0
        with span("train.epoch", epoch=epoch, engine="loop") as sp:
            for s in range(0, n, bs):
                idx = torch.as_tensor(order[s:s + bs], device=device)
                with span("train.grads"):
                    xs = [x.index_select(0, idx) for x in xs_all]
                    w = (w_all.index_select(0, idx) if w_all is not None
                         else None)
                    loss = models._loss_fn(params, cfg, xs,
                                           y_all.index_select(0, idx), w)
                    grads = torch.autograd.grad(loss, leaves)
                with span("train.adam"):
                    params, opt = adam_update(params, grads, opt, lr=cfg.lr)
                stats.dispatches += 1
                ep_loss += float(loss.detach())  # blocking sync EVERY step
                stats.host_syncs += 1
                nb += 1
                total_steps += 1
                comm_bytes += per_sample * int(idx.shape[0])
            sp.set(steps=nb)
        losses.append(ep_loss / max(nb, 1))
        if verbose and epoch % 10 == 0:
            print(f"  epoch {epoch}: loss {losses[-1]:.5f}")
        wlen = cfg.convergence_window
        if len(losses) > wlen:
            if abs(losses[-1 - wlen] - losses[-1]) < cfg.convergence_eps:
                break
    train_seconds = time.perf_counter() - t0
    sim_comm = comm_bytes / bandwidth + latency * 2 * total_steps * m
    return TrainReport(losses=losses, epochs=epoch, steps=total_steps,
                       train_seconds=train_seconds, comm_bytes=comm_bytes,
                       simulated_comm_seconds=sim_comm,
                       params=tree_map(lambda t: t.detach().clone(), params),
                       engine_stats=stats)
