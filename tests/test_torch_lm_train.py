"""The port's LLM training slice (``repro_torch.train.steps``,
``launch.train``) against the JAX package's ``repro.train.steps`` on the
same params and batches.

Both sides start from the reference's ``init_params`` (carried across
with ``interop.params_from_jax``) and the same seeded numpy batch
(``data.pipeline.token_batch_iterator``, with Eq.(2) weights that are
not uniform), on every reduced config (f32 compute).  On the CPU the
port's attention is the plain full attention and its scan the plain
``ssd_chunked``, as the reference's ``attn_impl="auto"`` and jnp scan
are.  Tolerances:

- ``lm_loss``'s loss, ce and aux within 1e-5 relative (f32 sums in
  other orders; measured <= 4e-7);
- every gradient leaf within rtol 1e-4 of ``jax.grad`` of the
  reference's ``lm_loss``, atol 1e-4·max|leaf| + 1e-6·max|any leaf|
  (elements near zero come from cancelling sums; a key bias's gradient
  is zero in exact arithmetic, softmax being blind to a row's shift, so
  that leaf holds rounding noise of the model's gradient size alone:
  measured 6e-10 against 0.22);
- params after 2 Adam steps within 1e-4 + 1e-3·|p|, as N4 holds the
  SplitNN's, but where the reference's first gradient is rounding noise
  (0 < |g| <= 1e-5·max|leaf| or 1e-6·max|any leaf|, as above; under 1%
  of the elements): an Adam step moves
  an element by about lr whatever its gradient's size, so there the two
  sides may step lr in opposite directions, within 4·lr over 2 steps;
- ``make_eval_step`` as ``lm_loss`` (the reference's eval step is its
  ``lm_loss`` without remat: the same value);
- ``remat`` on and off give bitwise-equal gradients (the recompute
  repeats the same ops on the same inputs).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.train import steps as ref_steps
from repro.train.optimizer import adam_init as ref_adam_init
from repro.train.optimizer import adam_update as ref_adam_update
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import token_batch_iterator
from repro_torch.interop import params_from_jax
from repro_torch.train import steps
from repro_torch.train.optimizer import adam_init, tree_leaves

ARCHS = [f"{a}-reduced" for a in ARCH_IDS]
IDS = [a.split("-")[0] for a in ARCH_IDS]
B, S = 2, 24
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    """(reference config, reference params as numpy, numpy batch): the
    batch from the pipeline at seed 3, weights 1 + rank/B."""
    cfg = ref_get_config(arch)
    rp = jax.tree_util.tree_map(np.asarray, jax.jit(
        ref_api.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    batch = next(token_batch_iterator(
        B, S, cfg.vocab, seed=3, d_model=cfg.d_model,
        frames=cfg.enc_seq if cfg.family == "audio" else 0,
        patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
        weights=True))
    batch["weights"] = (1.0 + np.arange(B) / B).astype(np.float32)
    return cfg, rp, batch


def _port(arch: str):
    """Fresh port params (f32 tensors, CPU) and the torch batch."""
    _, rp, batch = _setup(arch)
    return (params_from_jax(rp, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _ref_batch(arch: str):
    return {k: jnp.asarray(v) for k, v in _setup(arch)[2].items()}


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch: str):
    """The reference's jitted ``value_and_grad`` of ``lm_loss`` on the
    batch: params -> ((loss, (ce, aux)), grads)."""
    cfg = _setup(arch)[0]
    batch = _ref_batch(arch)
    return jax.jit(jax.value_and_grad(
        lambda p: ref_steps.lm_loss(p, cfg, batch), has_aux=True))


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch: str):
    (loss, (ce, aux)), grads = _ref_value_and_grad(arch)(
        jax.tree_util.tree_map(jnp.asarray, _setup(arch)[1]))
    return (float(loss), float(ce), float(aux),
            jax.tree_util.tree_map(np.asarray, grads))


_ref_adam_update = jax.jit(functools.partial(ref_adam_update, lr=LR))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread while this module runs: the
    models are small, and the driver's parallel workers already fill the
    cores (threads contending for them cost this file twice its time)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def arch(request):
    """Module-scoped, so pytest runs the tests of one config together."""
    return request.param


def _port_grads(arch: str, remat: bool = True):
    params, batch = _port(arch)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, (ce, aux) = steps.lm_loss(params, get_config(arch), batch,
                                    remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, ce, aux, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _ref_leaves(tree):
    """The reference tree's leaves in the port's order (dict keys sorted,
    as ``jax.tree_util`` orders them too)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_matches_reference(arch):
    """One config against the reference, in the order a worker can reuse
    the reference's compiled functions: ``lm_loss`` (loss, ce, aux) and
    ``make_eval_step``; every leaf of ``torch.autograd`` of the port's
    ``lm_loss`` (K11's plain version under remat, the plain scan) against
    ``jax.grad`` of the reference's; then two ``make_train_step`` steps
    (in place) against two of the reference's (its ``value_and_grad``,
    then its ``adam_update``), from the same params and batch."""
    cfg = get_config(arch)
    want_loss, want_ce, want_aux, want_grads = _ref_loss_and_grads(arch)
    want = (want_loss, want_ce, want_aux)
    params, batch = _port(arch)
    with torch.no_grad():
        loss, (ce, aux) = steps.lm_loss(params, cfg, batch)
    got = (float(loss), float(ce), float(aux))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                               err_msg="lm_loss")
    assert (got[2] == 0.0) == (cfg.moe is None)
    ev = steps.make_eval_step(cfg)(params, batch)
    assert not ev["loss"].requires_grad
    np.testing.assert_allclose([float(ev[k]) for k in ("loss", "ce", "aux")],
                               want, rtol=1e-5, atol=1e-7,
                               err_msg="make_eval_step")

    want_grads = _ref_leaves(want_grads)
    got = _port_grads(arch)[3]
    assert len(got) == len(want_grads)
    top = max(float(np.abs(w).max()) for w in want_grads)
    for g, w in zip(got, want_grads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max())
                                   + 1e-6 * top, err_msg="gradient")

    rparams = jax.tree_util.tree_map(jnp.asarray, _setup(arch)[1])
    ropt = ref_adam_init(rparams)
    params, pbatch = _port(arch)
    opt = adam_init(params)
    step = steps.make_train_step(cfg, lr=LR)
    for _ in range(2):
        (rloss, _), rgrads = _ref_value_and_grad(arch)(rparams)
        rparams, ropt = _ref_adam_update(rparams, rgrads, ropt)
        params, opt, m = step(params, opt, pbatch)
        np.testing.assert_allclose(float(m["loss"]), float(rloss),
                                   rtol=1e-5, err_msg="train step loss")
    assert opt.step == 2
    n_noise = 0
    for g, w, g1 in zip(tree_leaves(params), _ref_leaves(rparams),
                        want_grads):
        w = np.asarray(w, np.float64)
        err = np.abs(g.detach().numpy() - w)
        noise = (np.abs(g1) <= max(1e-5 * np.abs(g1).max(), 1e-6 * top)
                 ) & (g1 != 0)
        lim = np.where(noise, 4 * LR, 1e-4 + 1e-3 * np.abs(w))
        assert bool((err <= lim).all()), float((err - lim).max())
        n_noise += int(noise.sum())
    assert n_noise < 0.01 * sum(g.size for g in want_grads)


def test_remat_gives_bitwise_equal_gradients(arch):
    """Under ``torch.use_deterministic_algorithms``: the CPU's
    accumulating index-put (the embedding's backward) adds in an order
    that varies from run to run otherwise (CUDA's sorts its indices)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        on, off = _port_grads(arch, True), _port_grads(arch, False)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[3], off[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-reduced",
                                  "whisper-large-v3-reduced"],
                         ids=["tinyllama", "whisper"])
def test_weights_scale_loss(arch):
    """Eq.(2), as tests/test_models_smoke.py::test_weights_scale_loss
    holds the reference: doubling every weight leaves the normalized loss
    as it was, zeroing one changes it; and a zero weight removes that
    sequence's gradient: the loss's gradients are then those of the
    other sequence alone."""
    cfg = get_config(arch)
    params, batch = _port(arch)
    grads = {}
    for name, w in (("w", batch["weights"]), ("2w", batch["weights"] * 2),
                    ("w0", torch.tensor([1.0, 0.0])),
                    ("w1", torch.tensor([1.0, 1.0]))):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        b = dict(batch, weights=w)
        if name == "w1":          # sequence 0 alone
            b = {k: v[:1] for k, v in b.items()}
        loss, _ = steps.lm_loss(params, cfg, b)
        grads[name] = (float(loss.detach()), torch.autograd.grad(
            loss, leaves, allow_unused=True))
    assert grads["w"][0] == pytest.approx(grads["2w"][0], rel=1e-5)
    assert grads["w0"][0] != pytest.approx(grads["w"][0], rel=1e-6)
    assert grads["w0"][0] == pytest.approx(grads["w1"][0], rel=1e-5)
    for a, b in zip(grads["w0"][1], grads["w1"][1]):
        if a is None or b is None:
            assert a is None and b is None
            continue
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale + 1e-12)


def test_launch_train_runs_and_checkpoint_loads(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu``: two
    steps logged as the reference logs them, and its checkpoint loads
    into a tree of the config's params."""
    ckpt = str(tmp_path / "tiny.npz")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt", ckpt],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    assert "loss" in lines[0] and "ce" in lines[0] and "tok/s" in lines[0]
    params, _ = steps.init_train_state(1, get_config("tinyllama-1.1b")
                                       .reduced(), device="cpu")
    got, meta = load_checkpoint(ckpt, params)
    assert meta["step"] == 2
    assert all(torch.isfinite(t).all() for t in tree_leaves(got))
    assert not torch.equal(tree_leaves(got)[0], tree_leaves(params)[0])
