"""The training slice: threefry shaped draws, Eq.(2) losses, Adam, the
slab packing and epoch schedule, and the epoch engine against the
reference on the same seeded data (the reference's bottom layer on its
Pallas kernels in interpret mode, the port's on its plain versions).

Tolerances: f32 training runs are not bitwise across backends (GEMM and
reduction orders differ, ROADMAP.md R2), and Adam's normalised step
carries an ulp-level gradient difference into every parameter; over a
few epochs of a few steps each, the epoch losses stay within rtol 1e-4
and the parameters within 1e-4 + 1e-3·|p|.  Losses and one Adam update
on identical inputs agree to rtol 1e-6 (a few ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cls_partition
from repro.config import EngineOptions as JaxEngine
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import init_splitnn as jax_init
from repro.train import losses as jax_losses
from repro.train import optimizer as jax_opt
from repro.train import vfl as jax_vfl
from repro_torch import rng
from repro_torch.config import (EngineOptions, resolve_bottom_impl,
                                resolve_device)
from repro_torch.core import splitnn as models
from repro_torch.core.splitnn import SplitNNConfig, train_splitnn
from repro_torch.data.vertical import VerticalPartition
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.train import losses, optimizer
from repro_torch.train import vfl

MODELS = [("lr", 2), ("mlp", 4), ("linreg", 0)]


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _port_part(part):
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


def _cfgs(model, n_classes, **kw):
    kw = {**dict(model=model, n_classes=n_classes, lr=0.02, batch_size=64,
                 max_epochs=3), **kw}
    return JaxConfig(**kw), SplitNNConfig(**kw)


@pytest.fixture
def same_init(monkeypatch):
    """Start the port from the reference's initial params, carried
    across exactly (the port's own draws may differ by an ulp)."""
    monkeypatch.setattr(models, "init_splitnn", lambda cfg, fd, device=None:
                        params_from_jax(jax_init(cfg, list(fd)), device))


# ------------------------------------------------------------------- rng

@pytest.mark.parametrize("shape", [(11, 8), (5, 1), (33, 64), (4000,)])
def test_shaped_draws_match_jax_random(shape):
    """bits and uniform bitwise; normal within 2 ulps (XLA's f32
    erf_inv/log1p/log are emulated in numpy float32; the emulated log
    rounds differently on ~2 of 100,000 inputs)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for seed in (0, 1, 7, 2 ** 31 - 1):
        jk, k = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        assert np.array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
            rng.random_bits(k, shape))
        assert np.array_equal(
            np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0)),
            rng.uniform(k, shape, lo, 1.0))
        np.testing.assert_array_max_ulp(
            np.asarray(jax.random.normal(jk, shape, jnp.float32)),
            rng.normal(k, shape), maxulp=2)


@pytest.mark.parametrize("model,n_classes", MODELS + [("lr", 3)])
def test_init_splitnn_matches_reference(model, n_classes):
    jcfg, cfg = _cfgs(model, n_classes, seed=5)
    want = jax_init(jcfg, [11, 11, 10])
    got = params_to_numpy(models.init_splitnn(cfg, [11, 11, 10],
                                              device="cpu"))
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(got))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert a.shape == b.shape
        np.testing.assert_array_max_ulp(np.asarray(a), b, maxulp=2)


# ------------------------------------------------------- losses and Adam

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["softmax", "mse", "binary"])
def test_losses_match_reference(kind, weighted):
    g = np.random.default_rng(1)
    w = g.uniform(0, 3, 40).astype(np.float32) if weighted else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    if kind == "softmax":
        logits = g.normal(size=(40, 4)).astype(np.float32)
        y = g.integers(0, 4, 40)
        want = jax_losses.weighted_softmax_xent(j(logits), j(y), j(w))
        got = losses.weighted_softmax_xent(t(logits), t(y), t(w))
    elif kind == "mse":
        p = g.normal(size=(40, 1)).astype(np.float32)
        y = g.normal(size=(40, 1)).astype(np.float32)
        want = jax_losses.weighted_mse(j(p), j(y), j(w))
        got = losses.weighted_mse(t(p), t(y), t(w))
    else:
        logits = g.normal(size=40).astype(np.float32)
        y = g.integers(0, 2, 40)
        want = jax_losses.weighted_binary_xent(j(logits), j(y), j(w))
        got = losses.weighted_binary_xent(t(logits), t(y), t(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adam_update_matches_reference():
    g = np.random.default_rng(2)
    tree = lambda: {"bw": g.normal(size=(3, 5, 4)).astype(np.float32),
                    "top": {"b": g.normal(size=(4,)).astype(np.float32)}}
    p0 = tree()
    jp, js = {k: jax.tree_util.tree_map(jnp.asarray, v)
              for k, v in p0.items()}, None
    js = jax_opt.adam_init(jp)
    tp = params_from_jax(p0, "cpu")
    ts = optimizer.adam_init(tp)
    for _ in range(4):
        gr = tree()
        jp, js = jax_opt.adam_update(jp, jax.tree_util.tree_map(
            jnp.asarray, gr), js, lr=0.05)
        tp, ts = optimizer.adam_update(tp, params_from_jax(gr, "cpu"), ts,
                                       lr=0.05)
    assert ts.step == int(js.step) == 4
    for a, b in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        np.testing.assert_allclose(_flat(params_to_numpy(b)), _flat(a),
                                   rtol=1e-6, atol=1e-9)


# -------------------------------------------------- schedule and packing

@pytest.mark.parametrize("n,bs", [(192, 64), (230, 64), (7, 7)])
def test_epoch_schedule_exact(n, bs):
    order = np.random.default_rng(n).permutation(n)
    steps = -(-n // bs)
    for padded in (bs, bs + 3):
        want = jax_vfl.epoch_schedule(order, n, bs, steps, padded)
        got = vfl.epoch_schedule(order, n, bs, steps, padded)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("model,n_classes", MODELS)
def test_pack_unpack_slab_params_exact(model, n_classes):
    jcfg, _ = _cfgs(model, n_classes)
    fd = [4, 6, 5]
    zoo = jax_init(jcfg, fd)
    want = jax_vfl.pack_slab_params(zoo, 6, m_pad=4)
    got = vfl.pack_slab_params(params_from_jax(zoo, "cpu"), 6, m_pad=4)
    assert sorted(want) == sorted(got)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(params_to_numpy(got))):
        assert np.array_equal(np.asarray(a), b)
    back = params_to_numpy(vfl.unpack_slab_params(got, fd))
    for a, b in zip(jax.tree_util.tree_leaves(jax_vfl.unpack_slab_params(
            want, fd)), jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    feats = [np.ones((3, d), np.float32) * d for d in fd]
    assert np.array_equal(jax_vfl.pack_slab(feats, 4),
                          vfl.pack_slab(feats, 4))


# ------------------------------------------------------------ the engine

_REF = {}


def _ref_scan(model, n_classes, n, fuse, bottom_impl="pallas"):
    key = (model, n_classes, n, fuse, bottom_impl)
    if key not in _REF:
        part = make_cls_partition(n=n, d=11, classes=max(n_classes, 2),
                                  seed=1)
        jcfg, _ = _cfgs(model, n_classes)
        _REF[key] = (part, jax_vfl.train_scan(part, jcfg, options=JaxEngine(
            bottom_impl=bottom_impl, fuse_gather=fuse)))
    return _REF[key]


def _check_report(got, want):
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    gp = _flat(params_to_numpy(got.params))
    wp = _flat(want.params)
    assert (np.abs(gp - wp) <= 1e-4 + 1e-3 * np.abs(wp)).all()
    assert (got.epochs, got.steps, got.comm_bytes) == (
        want.epochs, want.steps, want.comm_bytes)
    for f in ("dispatches", "host_syncs", "steps_per_epoch", "padded_batch",
              "gather_payload_bytes"):
        assert getattr(got.engine_stats, f) == getattr(want.engine_stats, f)


@pytest.mark.parametrize("n", [192, 230])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("model,n_classes", MODELS)
def test_train_scan_matches_reference(same_init, model, n_classes, fuse, n):
    """n = 230 with batches of 64 leaves a 38-row remainder step that
    trains through the mask."""
    part, want = _ref_scan(model, n_classes, n, fuse)
    _, cfg = _cfgs(model, n_classes)
    got = vfl.train_scan(_port_part(part), cfg, options=EngineOptions(
        device="cpu", fuse_gather=fuse))
    _check_report(got, want)
    assert got.engine_stats.fused_gather == fuse
    assert got.engine_stats.bottom_impl == "ref"


@pytest.mark.parametrize("model,n_classes", MODELS)
def test_loop_oracles_match_reference(same_init, model, n_classes):
    """``bottom_impl="loop"`` (per-client GEMMs inside the epoch
    engine) and the per-step ``train_loop`` against the reference's."""
    part, want = _ref_scan(model, n_classes, 230, False, "loop")
    _, cfg = _cfgs(model, n_classes)
    got = vfl.train_scan(_port_part(part), cfg, options=EngineOptions(
        device="cpu", bottom_impl="loop"))
    _check_report(got, want)
    jcfg, _ = _cfgs(model, n_classes)
    want = jax_vfl.train_loop(part, jcfg)
    got = train_splitnn(_port_part(part), cfg, options=EngineOptions(
        device="cpu", train_engine="loop"))
    _check_report(got, want)
    assert got.engine_stats.host_syncs == got.steps


def test_scan_one_sync_per_epoch_and_weights():
    """The engine's contract: one epoch call and one host sync per
    epoch; zero sample weights train nothing (Eq. 2)."""
    part = _port_part(make_cls_partition(n=150, d=9, seed=2))
    _, cfg = _cfgs("lr", 2, max_epochs=4)
    rep = train_splitnn(part, cfg, options=EngineOptions(device="cpu"))
    st = rep.engine_stats
    assert st.dispatches == st.host_syncs == rep.epochs == 4
    assert rep.steps == 4 * st.steps_per_epoch
    w = np.zeros(150, np.float32)
    frozen = train_splitnn(part, cfg, sample_weights=w,
                           options=EngineOptions(device="cpu"))
    init = params_to_numpy(models.init_splitnn(cfg, [3, 3, 3],
                                               device="cpu"))
    assert np.array_equal(_flat(params_to_numpy(frozen.params)),
                          _flat(init))


# ------------------------------------------------------------ the repairs

def test_bottom_impl_resolves_by_device():
    """``EngineOptions().bottom_impl`` is None: the kernel on a CUDA
    device (resolved without a launch), the plain version on the CPU;
    the reference's "pallas" means the kernel; "kernel" on the CPU
    raises where the kernel is reached."""
    default = EngineOptions().bottom_impl
    assert default is None
    assert resolve_bottom_impl(default, torch.device("cuda")) == "kernel"
    assert resolve_bottom_impl(default, torch.device("cpu")) == "ref"
    assert resolve_bottom_impl("pallas", torch.device("cpu")) == "kernel"
    assert resolve_bottom_impl("loop", torch.device("cuda")) == "loop"
    with pytest.raises(ValueError, match="impl"):
        resolve_bottom_impl("fused", torch.device("cpu"))
    part = _port_part(make_cls_partition(n=40, d=6, seed=0))
    _, cfg = _cfgs("lr", 2, max_epochs=1)
    with pytest.raises(ValueError, match="CUDA"):
        train_splitnn(part, cfg, options=EngineOptions(
            device="cpu", bottom_impl="kernel"))


def test_cuda_device_turns_tf32_off():
    """Every entry point resolves its device through ``resolve_device``,
    which turns TF32 off for matmuls and cuDNN on a CUDA device (the
    device object needs no card)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        resolve_device("cpu")
        assert torch.backends.cudnn.allow_tf32
        assert resolve_device(None) == torch.device("cuda")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_quant_waits_for_the_quant_slice():
    """The quant slice has come: ``quant="int8"`` trains on the CPU and
    reports its wire dtype; an unknown wire dtype raises."""
    part = _port_part(make_cls_partition(n=40, d=6, seed=0))
    _, cfg = _cfgs("mlp", 2, max_epochs=1)
    rep = train_splitnn(part, cfg, options=EngineOptions(device="cpu",
                                                         quant="int8"))
    assert rep.engine_stats.quant == "int8" and np.isfinite(rep.losses[0])
    with pytest.raises(ValueError, match="quant"):
        train_splitnn(part, cfg, options=EngineOptions(device="cpu",
                                                       quant="int4"))
