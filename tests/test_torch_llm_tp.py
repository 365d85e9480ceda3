"""Tensor and context parallelism for the ssm, hybrid, vlm and audio
families, and the ``pod`` batch axis (``repro_torch.sharding.LMLayout``,
``models.attention.layer_attention``/``context_attention``,
``models.ssm``'s mixer on a rank's heads, ``models.encdec``), on gloo
worlds of spawned CPU ranks, held against the reference's single-device
steps (GSPMD keeps the values), started from the same params through
``interop``, with ``tests/test_torch_llm_sharded.py``'s tolerances
(``_check_train``).

Two worlds, each spawned once for the file: 2 ranks ((1, 2)) and 4
ranks ((2, 2), and (2, 1, 2) named ``("pod", "data", "model")``).
Their results are shared with the other test workers through a file
under the run's temp dir.  Stores are ``file://``, every world is joined
within ``WORLD_TIMEOUT`` seconds, and no process group is made in the
test process.  The rank side is ``tests/_torch_llm_tp_ranks.py``.

The configs: reduced hymba-1.5b (its 4 q heads and 16 SSM heads divide
``model``: tensor parallelism everywhere), internvl2-1b, mamba2-1.3b and
whisper-large-v3, under ``"2d"`` and ``"fsdp"``; and three variants of
reduced hymba, built with ``dataclasses.replace`` in both packages:
``cp`` (5 q heads of 32 over 4 meta tokens + 16 positions, which
``model`` divides: context parallelism), ``neither`` (the same heads
over 4 + 15 positions: attention replicated), ``split`` (d_inner 768 in
3 SSM heads of 256: a rank's block of 384 channels splits a head, so
the mixer is gathered whole).

Besides the values, each case holds three things to formulas written
here: each stack's kept leaves (and the shapes ``gather_layer`` hands a
layer: the kept leaves their ``model`` block, whole over ``data``);
the bytes of one layer's gather (the ``data`` shards of every sharded
leaf, the ``model`` shards only of those not kept); and the collectives
of one train step (``_step_calls``)."""
import dataclasses
import fcntl
import functools
import math
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_llm_tp_ranks as ranks
from repro.configs import get_config as ref_get_config
from repro.kernels.flash_attention import ref as ref_fa
from repro.models import api as ref_api
from repro.train import steps as ref_steps
from repro.train.optimizer import adam_init as ref_adam_init
from repro.train.optimizer import adam_update as ref_adam_update
from repro_torch import sharding
from repro_torch.data.pipeline import token_batch_iterator
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import api
from test_torch_llm_sharded import (_check_metrics_and_grads, _check_train,
                                    _losses)

WORLD_TIMEOUT = 240.0       # seconds a world may take, spawn to join
B, S, LR = 4, 16, 1e-3
ODD_S = 15                  # + hymba's 4 meta tokens: 19, odd
HYMBA = "hymba-1.5b-reduced"
FIVE_HEADS = {"n_heads": 5, "head_dim": 32, "n_kv_heads": 1}
#: name: (arch, ArchConfig fields replaced, SSMConfig fields replaced, S)
CASES = {
    "hymba": (HYMBA, {}, {}, S),
    "internvl2": ("internvl2-1b-reduced", {}, {}, S),
    "mamba2": ("mamba2-1.3b-reduced", {}, {}, S),
    "whisper": ("whisper-large-v3-reduced", {}, {}, S),
    "hymba-cp": (HYMBA, FIVE_HEADS, {}, S),
    "hymba-neither": (HYMBA, FIVE_HEADS, {}, ODD_S),
    "hymba-split": (HYMBA, {}, {"expand": 3, "head_dim": 256}, S),
}
FAMILIES = ["hymba", "internvl2", "mamba2", "whisper"]
VARIANTS = ["hymba-cp", "hymba-neither", "hymba-split"]
#: the variants' param rule: the strict rule but within one Adam step
#: (LR) where the first gradient is within this many gradient atols of
#: zero (``_check_variant``)
VARIANT_WIDE = 5
POD = (2, 1, 2)
POD_CASES = [("hymba", "2d"), ("hymba", "fsdp"), ("hymba-cp", "2d")]
LAUNCH = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1"]
MAMBA = ("mamba/wz", "mamba/wx", "mamba/conv_x", "mamba/out_proj",
         "mamba/gate_norm/scale")
STACKS = ranks.STACKS


# ------------------------------------------------------------ the inputs

def _ref_config(name):
    arch, over, ssm_over, _ = CASES[name]
    cfg = ref_get_config(arch)
    over = dict(over)
    if ssm_over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **ssm_over)
    return dataclasses.replace(cfg, **over) if over else cfg


def _config(name):
    arch, over, ssm_over, _ = CASES[name]
    return ranks.config(arch, over, ssm_over)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference params as numpy, numpy batch): the reference's
    ``init_params`` at key 0; the pipeline's batch of B × S at seed 3,
    weights 1 + rank/B."""
    cfg = _ref_config(name)
    rp = jax.tree_util.tree_map(np.asarray, jax.jit(
        ref_api.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    batch = next(token_batch_iterator(
        B, CASES[name][3], cfg.vocab, seed=3, d_model=cfg.d_model,
        frames=cfg.enc_seq if cfg.family == "audio" else 0,
        patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
        weights=True))
    batch["weights"] = (1.0 + np.arange(B) / B).astype(np.float32)
    return rp, batch


def _train_kw(name, profile):
    arch, over, ssm_over, _ = CASES[name]
    params, batch = _setup(name)
    return dict(arch=arch, over=over, ssm_over=ssm_over, params=params,
                batch=batch, steps=2, lr=LR, profile=profile)


def _plans(ckpt):
    cases = [(f, p) for f in FAMILIES for p in ("2d", "fsdp")]
    cases += [(v, "2d") for v in VARIANTS]
    plan = [(f"{n}-{p}", "train", _train_kw(n, p)) for n, p in cases]
    pod = [(f"{n}-{p}", "train", _train_kw(n, p)) for n, p in POD_CASES]
    pod += [("launch", "launch", dict(argv=LAUNCH + [
        "--mesh", ",".join(map(str, POD)), "--ckpt", ckpt]))]
    return {2: {(1, 2): plan}, 4: {(2, 2): plan, POD: pod}}


def _single_device(name):
    """The reference's first gradients, two steps' metrics and the params
    after them, on one device (make_train_step's two halves)."""
    cfg = _ref_config(name)
    params, batch = _setup(name)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(lambda q: ref_steps.lm_loss(q, cfg, b),
                                    has_aux=True))
    upd = jax.jit(functools.partial(ref_adam_update, lr=LR))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = ref_adam_init(p)
    metrics, g1 = [], None
    for _ in range(2):
        (loss, (ce, aux)), g = vg(p)
        g1 = jax.tree_util.tree_map(np.asarray, g) if g1 is None else g1
        p, opt = upd(p, g, opt)
        metrics.append({"loss": float(loss), "ce": float(ce),
                        "aux": float(aux)})
    return {"grads": g1, "params": jax.tree_util.tree_map(np.asarray, p),
            "metrics": metrics}


def _unsharded_launch(root):
    """The launcher's log without a mesh."""
    import contextlib
    import io

    from repro_torch.launch.train import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(LAUNCH + ["--ckpt", str(root / "llm_tp_launch_unsharded.npz")])
    return buf.getvalue()


def _build(root):
    """The worlds' results, the reference's single-device steps and the
    launcher's unsharded log."""
    worlds = {}
    ckpt = str(root / "llm_tp_launch_pod.npz")

    def run_worlds():
        for n, plans in _plans(ckpt).items():
            try:
                worlds[n] = run_ranks(ranks.world, n, (plans,),
                                      device="cpu", timeout=WORLD_TIMEOUT,
                                      workdir=str(root))
            except Exception as e:          # raised below, in the test
                worlds[n] = e

    # the worlds wait in a thread while this one runs the reference
    thread = threading.Thread(target=run_worlds)
    thread.start()
    try:
        ref = {name: _single_device(name) for name in CASES}
        launch = _unsharded_launch(root)
    finally:
        thread.join()
    for w in worlds.values():
        if isinstance(w, Exception):
            raise w
    return {"worlds": worlds, "ref": ref, "launch": launch}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """``_build()``'s result, computed by the first test worker to ask
    and read from the run's temp dir by the others."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "torch_llm_tp.pkl"
    with open(root / "torch_llm_tp.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = _build(root)
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, path)
        with open(path, "rb") as f:
            return pickle.load(f)


def _ranks(shared, size, mesh, key):
    """Every rank's result, after checking that none failed, that their
    gathered params are bitwise the same and that their blocks have the
    shapes their specs give."""
    per = [r[mesh][key] for r in shared["worlds"][size]]
    for rank, r in enumerate(per):
        assert not isinstance(r, Exception), f"rank {rank}: {r}"
        assert not r["faults"], r["faults"]
    assert len({r["digest"] for r in per}) == 1, "ranks differ"
    return per


# --------------------------------------------------------- the formulas

def _specs(cfg, sizes, profile):
    """{path: spec} of ``cfg``'s params on a mesh of ``sizes`` under
    ``profile`` (the reference's rules: ``test_torch_llm_sharded.py``
    holds them leaf for leaf), and {path: whole shape}."""
    shapes = dict(sharding.flat_tree(api.param_shapes(cfg)))
    mesh = sharding.MeshShape(tuple(sizes), tuple(sizes.values()))
    sharding.set_profile(profile)
    try:
        specs = sharding.flat_specs(sharding.param_shardings(
            api.param_shapes(cfg), mesh))
    finally:
        sharding.set_profile("2d")
    return specs, {k: tuple(v) for k, v in shapes.items()}


def _kept(stack, cfg, sizes, profile):
    """The leaves of one layer of ``stack`` that keep their ``model``
    shards: none without a ``model`` axis to run on or under
    ``"fsdp"``; else attention's q heads and ``wo`` (and k/v where the
    kv heads divide ``model``) where the q heads divide it, the MLP's
    d_ff leaves, and the Mamba mixer's d_inner leaves where a rank's
    block of d_inner is whole SSM heads."""
    m = sizes["model"]
    if profile != "2d" or m == 1:
        return set()
    keep = set()
    attns = ("attn", "cross_attn") if stack == "dec_layers" else ("attn",)
    if cfg.family != "ssm" and cfg.n_heads % m == 0:
        for a in attns:
            keep |= {f"{a}/wq", f"{a}/wo"}
            if cfg.n_kv_heads % m == 0:
                keep |= {f"{a}/wk", f"{a}/wv"}
    if cfg.family == "audio":
        keep |= {"mlp/wi", "mlp/bi", "mlp/wo"}
    elif cfg.family != "ssm":
        keep |= {"mlp/wi_gate", "mlp/wi_up", "mlp/wo"}
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        if d_inner // m % cfg.ssm.head_dim == 0:
            keep |= set(MAMBA)
    return keep


def _layer_specs(specs, shapes, stack):
    """One layer's {path within it: (spec, shape)} (the stacked leading
    axis dropped)."""
    n = len(stack) + 1
    return {k[n:]: (specs[k][1:], shapes[k][1:]) for k in specs
            if k.startswith(stack + "/")}


def _gather_bytes(layer, sizes, kept):
    """The bytes a rank puts into one layer's gather (f32): each
    ``data``-sharded leaf's block into the ``data`` gather, and each
    ``model``-sharded leaf that is not kept, whole over ``data``, into
    the ``model`` gather; a kept leaf moves only its ``data`` shard."""
    data, model = sizes["data"], sizes["model"]
    total = 0
    for k, (spec, shape) in layer.items():
        block = math.prod(shape)
        for e in spec:
            block //= sizes[e] if e else 1
        if data > 1 and "data" in spec:
            total += 4 * block
        if model > 1 and "model" in spec and k not in kept:
            total += 4 * block * (data if "data" in spec else 1)
    return total


def _step_calls(name, sizes, profile):
    """The collectives of one train step (f32, remat on).

    - The loss's two sums and the gradients of the params resting whole
      on a batch axis: one all-reduce each, on each batch axis of more
      than one rank (``pod`` and ``data``; under ``"fsdp"`` ``model``
      too; every batch axis has such params, the norms).
    - The non-layer params: one ``data`` gather and its reduce-scatter
      in the backward; under tensor parallelism one ``model`` gather of
      the leaves not kept (whisper's vocab and positions, internvl2's
      ``vision_proj``) and, for a decoder-only family, the vocab: the
      embedding's sum, the logits' gather and their input's copy (its
      sum in the backward).
    - Each layer: its ``data`` gather and ``model`` gather (of leaves
      not kept) twice (the forward and the checkpoint's recompute) and
      the ``data`` gather's reduce-scatter; then for each block it runs
      tensor- or context-parallel: its forward collectives twice, but
      for the sum that is the layer's last op (after it no op saves a
      tensor, so the recompute stops before it), and one collective for
      each ``copy_to_model`` in the backward:
      - attention with the rank's heads: the output's sum; the copies of
        x, of the memory (cross-attention) and of the replicated params
        its heads read (biases, whole kv heads: one bundle);
      - context-parallel attention: the rows' gather; the copies of x,
        of the memory and of every param (one bundle);
      - the Mamba mixer: the gated norm's sum of squares (forward and
        backward), the output's sum; the copies of x and of ``wB``,
        ``wC``, ``wdt``, ``A_log``, ``D``, ``dt_bias`` (one bundle);
      - an MLP: the output's sum (the layer's last); the copy of x."""
    cfg = _config(name)
    specs, shapes = _specs(cfg, sizes, profile)
    data, model = sizes["data"], sizes["model"]
    axes = [sizes.get("pod", 1), data] + ([model] if profile == "fsdp"
                                           else [])
    calls = 2 * sum(n > 1 for n in axes)
    tp = profile == "2d" and model > 1
    dg = int(data > 1)

    def mg(items, kept):
        return int(tp and any("model" in s for k, (s, _) in items.items()
                              if k not in kept))

    top = {k: (s, shapes[k]) for k, s in specs.items()
           if k.split("/")[0] not in STACKS}
    vocab = set() if cfg.family == "audio" else {"embed", "lm_head"}
    calls += 2 * dg + mg(top, vocab) + 3 * int(tp and bool(vocab))
    # each stack's attention rows: the frames, the decoder's tokens, or
    # the prepended patches and meta tokens and the tokens
    seqs = {"enc_layers": cfg.enc_seq, "dec_layers": CASES[name][3],
            "layers": (cfg.hybrid_meta_tokens + cfg.vision_tokens
                       + CASES[name][3])}
    for stack, n_layers in (("layers", cfg.n_layers),
                            ("enc_layers", cfg.enc_layers),
                            ("dec_layers", cfg.n_layers)):
        if not any(k.startswith(stack + "/") for k in specs) or (
                stack == "layers" and cfg.family == "audio"):
            continue
        layer = _layer_specs(specs, shapes, stack)
        kept = _kept(stack, cfg, sizes, profile)
        per = 3 * dg + 2 * mg(layer, kept)
        if tp:
            s_q = seqs[stack]
            for a in ("attn", "cross_attn"):
                if f"{a}/wq" not in layer:
                    continue
                cross = int(a == "cross_attn")
                if f"{a}/wq" in kept:
                    bundle = int(cfg.qkv_bias or cfg.n_kv_heads % model > 0)
                    per += 2 + 1 + cross + bundle
                elif s_q % model == 0:
                    per += 2 + 1 + cross + 1
            if set(MAMBA) <= kept:
                last = cfg.family == "ssm"
                per += 2 + (1 if last else 2) + 3
            if "mlp/wo" in kept:
                per += 1 + 1
        calls += n_layers * per
    return calls


# ------------------------------------------------------------- the tests

def _check_variant(got, ref):
    """A variant's run against the reference's two steps by
    ``_check_train``, its param rule widened (``VARIANT_WIDE``) from the
    gradient tolerance.  On these configs the strict rule is
    ill-conditioned: at elements whose first gradient is near the
    gradient check's atol (which admits an error of a fifth of such a
    gradient), f32 rounding moves Adam's second step by up to half a
    step; the reference's own f32 run misses the strict rule against
    its float64 run at such elements, while in float64 the port and the
    reference agree within 1e-9 (``tests/llm_tp_f64_witness.py``,
    ROADMAP.md §3 R12)."""
    _check_train(got, ref, wide=VARIANT_WIDE)


TRAIN_CASES = ([(2, (1, 2), f, p) for f in FAMILIES for p in ("2d", "fsdp")]
               + [(4, (2, 2), f, p) for f in FAMILIES
                  for p in ("2d", "fsdp")]
               + [(size, mesh, v, "2d") for size, mesh in ((2, (1, 2)),
                                                           (4, (2, 2)))
                  for v in VARIANTS]
               + [(4, POD, n, p) for n, p in POD_CASES])


@pytest.mark.parametrize("size,mesh,name,profile", TRAIN_CASES, ids=[
    f"{'x'.join(map(str, m))}-{n}-{p}" for _, m, n, p in TRAIN_CASES])
def test_train_matches_single_device_reference(shared, size, mesh, name,
                                               profile):
    """Two steps under ``use_mesh`` against the reference's single-device
    steps; each stack's kept leaves are the rule's and ``gather_layer``
    hands them over as their ``model`` block, every other leaf whole;
    one layer's gather moves the bytes ``_gather_bytes`` counts; one
    train step makes ``_step_calls`` collectives."""
    per = _ranks(shared, size, mesh, f"{name}-{profile}")
    if name in VARIANTS:
        _check_variant(per[0], shared["ref"][name])
    else:
        _check_train(per[0], shared["ref"][name])
    cfg = _config(name)
    names = ("pod", "data", "model") if len(mesh) == 3 else ("data",
                                                             "model")
    sizes = dict(zip(names, mesh))
    specs, shapes = _specs(cfg, sizes, profile)
    for r in per:
        assert r["step_calls"] == _step_calls(name, sizes, profile)
        for stack, probe in r["probes"].items():
            kept = _kept(stack, cfg, sizes, profile)
            assert set(probe["kept"]) == kept, stack
            layer = _layer_specs(specs, shapes, stack)
            for k, (spec, shape) in layer.items():
                want = [n // sizes["model"] if e == "model" and k in kept
                        else n for n, e in zip(shape, spec)]
                assert list(probe["shapes"][k]) == want, (stack, k)
            assert probe["bytes"] == _gather_bytes(layer, sizes, kept)


@pytest.mark.parametrize("name", ["hymba", "mamba2"])
def test_tp_layer_keeps_its_mixer_shards(shared, name):
    """On (2, 2) under ``"2d"`` a hymba and a mamba2 layer keep their
    Mamba mixer's ``model`` shards: their gather moves less than the
    layer whose mixer is gathered whole would (by the mixer's ``model``
    shards), and the mixer's leaves reach the layer as their blocks."""
    per = _ranks(shared, 4, (2, 2), f"{name}-2d")
    cfg = _config(name)
    sizes = {"data": 2, "model": 2}
    specs, shapes = _specs(cfg, sizes, "2d")
    layer = _layer_specs(specs, shapes, "layers")
    kept = _kept("layers", cfg, sizes, "2d")
    assert set(MAMBA) <= kept
    whole_mixer = _gather_bytes(layer, sizes, kept - set(MAMBA))
    mixer = sum(4 * math.prod(shape) // 2 for k, (_, shape) in
                layer.items() if k in MAMBA)
    for r in per:
        probe = r["probes"]["layers"]
        assert probe["bytes"] == whole_mixer - mixer
        assert probe["shapes"]["mamba/wz"][1] == \
            cfg.ssm.expand * cfg.d_model // 2


def test_variants_take_their_attention_route(shared):
    """The variants' layers on (2, 2): ``cp`` keeps no attention shard
    and gathers ``wo`` whole (context parallelism runs on the whole
    params), ``neither`` the same (attention replicated), ``split``
    gathers the Mamba mixer whole but keeps attention's heads; their
    collectives differ from hymba's by the routes' counts."""
    got = {n: _ranks(shared, 4, (2, 2), f"{n}-2d")[0] for n in
           ["hymba"] + VARIANTS}
    kept = {n: set(r["probes"]["layers"]["kept"]) for n, r in got.items()}
    assert {"attn/wq", "attn/wo"} <= kept["hymba"]
    assert not any(k.startswith("attn/") for k in kept["hymba-cp"])
    assert kept["hymba-cp"] == kept["hymba-neither"]
    assert not set(MAMBA) & kept["hymba-split"]
    assert "attn/wq" in kept["hymba-split"]
    # per layer (2 layers): cp's gather of wo twice and its route's
    # collectives (4) where hymba's heads take 4; neither: no route
    calls = {n: r["step_calls"] for n, r in got.items()}
    assert calls["hymba-cp"] - calls["hymba"] == 2 * 2
    assert calls["hymba-cp"] - calls["hymba-neither"] == 2 * 4


def test_launch_train_on_a_pod_mesh(shared):
    """``launch.train --mesh 2,1,2`` on a 4-rank world: rank 0 logs the
    unsharded run's losses, the others none; its checkpoint loads back
    into every rank's blocks bitwise."""
    per = [r[POD]["launch"] for r in shared["worlds"][4]]
    for rank, r in enumerate(per):
        assert not isinstance(r, Exception), f"rank {rank}: {r}"
        assert r["blocks_reload_bitwise"] and r["whole_equals_ckpt"]
    assert len(_losses(per[0]["log"])) == 2
    assert not any(_losses(r["log"]) for r in per[1:])
    np.testing.assert_allclose(_losses(per[0]["log"]),
                               _losses(shared["launch"]), atol=2e-4)


def test_launch_refuses_a_mesh_of_other_rank():
    """``--mesh`` takes two or three sizes whose product is the world."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="D,M or P,D,M"):
        main(LAUNCH + ["--mesh", "2"])
    with pytest.raises(ValueError, match="needs a world of 4"):
        main(LAUNCH + ["--mesh", "2,1,2"])


def test_no_process_group_in_the_test_process(shared):
    assert not dist.is_initialized()


# ------------------------------------- the decomposition, on one process

#: (causal, window, prefix, logit cap)
MASKS = [(True, 0, 0, 0.0), (True, 16, 4, 0.0), (True, 16, 0, 30.0),
         (False, 0, 0, 0.0)]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("mask", MASKS, ids=[
    f"{'causal' if c else 'full'}-w{w}-p{p}-cap{int(cap)}"
    for c, w, p, cap in MASKS])
def test_context_parallel_decomposition(mask, model):
    """K11's plain version on each rank's block of the q rows against
    the keys truncated to the block's end (causal; every key otherwise)
    gives the whole attention's rows (the reference's plain K11 on the
    whole sequence), and the rank pieces' gradients of q, k and v,
    summed over the ranks, its gradients (``jax.grad``), with the
    suffix alignment placing each rank's rows at their true positions
    under the window and the prefix: 5 q heads on one kv head, S = 48."""
    causal, window, prefix, cap = mask
    rng = np.random.default_rng(7)
    b, s, h, kv, dh = 2, 48, 5, 1, 32
    q, k, v, do = (rng.normal(0, 1, shape).astype(np.float32) for shape in
                   ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                    (b, s, h, dh)))
    kw = dict(causal=causal, window=window, prefix=prefix, logit_cap=cap)

    def whole(q, k, v):
        return jnp.sum(ref_fa.flash_attention(q, k, v, **kw) * do)

    want = np.asarray(ref_fa.flash_attention(q, k, v, **kw))
    wq, wk, wv = (np.asarray(g) for g in jax.grad(whole, (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n = s // model
    rows, loss = [], 0
    for r in range(model):
        r0, r1 = r * n, (r + 1) * n
        end = r1 if causal else s
        out = fa_ref.flash_attention(tq[:, r0:r1], tk[:, :end],
                                     tv[:, :end], **kw)
        rows.append(out.detach().numpy())
        loss = loss + (out * torch.from_numpy(do[:, r0:r1])).sum()
    loss.backward()
    np.testing.assert_allclose(np.concatenate(rows, 1), want, rtol=1e-5,
                               atol=1e-5)
    for got, w in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_context_attention_refuses_unaligned_rows():
    """``context_attention`` raises where a mask reads positions and the
    rank's q rows would not be the suffix of its keys (non-causal
    attention under a window keeps every key)."""
    from repro_torch.models.attention import context_attention

    class Axis:             # rank 0 of 2: not the last block
        size, rank = 2, 0

    cfg = _config("hymba-cp")
    params = {"wq": torch.zeros(cfg.d_model, 5, 32),
              "wk": torch.zeros(cfg.d_model, 1, 32),
              "wv": torch.zeros(cfg.d_model, 1, 32),
              "wo": torch.zeros(160, cfg.d_model)}
    x = torch.zeros(1, 8, cfg.d_model)
    with pytest.raises(ValueError, match="not the suffix"):
        context_attention(params, x, cfg, Axis(),
                          positions=torch.arange(8), causal=False,
                          window=4)
