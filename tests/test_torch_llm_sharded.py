"""LLM training on a ``(data, model)`` mesh (the LLM half of
``repro_torch.sharding``, tensor-parallel attention/MLP/vocab,
``models.moe.moe_forward_ep``, ``launch.train --mesh``) on gloo worlds
of spawned CPU ranks, held against the reference: its parameter rules
leaf for leaf, its single-device step where GSPMD keeps the values, and
its own sharded step where the values depend on the mesh (an MoE that
drops tokens computes capacity from each shard's tokens).

Two worlds, each spawned once for the file (2 ranks: a ``("data",)``
mesh and a ``(1, 2)`` one; 4 ranks: ``(2, 2)``), and one JAX subprocess
(4 virtual CPU devices, ``make_train_mesh``; never ``jax.make_mesh``,
ROADMAP R10) running the reference's sharded computations while the
worlds run (the single-device ones run in the test process meanwhile).
Their results are shared with the other test workers through a file
under the run's temp dir.  Stores are ``file://``, every world is joined
within ``WORLD_TIMEOUT`` seconds, and no process group is made in the
test process.  The rank side is ``tests/_torch_llm_sharded_ranks.py``.

Tolerances: losses, ce and aux within rtol 1e-4 (the all-reduces sum in
other orders); the first step's gradients, gathered whole, as
``test_torch_lm_train.py`` holds the unsharded port's (rtol 1e-4, atol
1e-4·max|leaf| + 1e-6·max|any leaf|); the params after two Adam steps as
that file holds the unsharded port's (1e-4 + 1e-3·|p|; within 4·lr where
the reference's first gradient is rounding noise, since an Adam step
moves an element by about lr whatever its gradient's size: a small
gradient's relative error, within the gradient bound, becomes the
step's);
``moe_forward_ep``'s y within 1e-5 and aux within 1e-6.  Every rank's
gathered params are bitwise the same, and each block has the shape its
spec gives.
"""
import fcntl
import functools
import os
import pickle
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import _torch_llm_sharded_ranks as ranks
from repro import sharding as ref_sharding
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.train import steps as ref_steps
from repro.train.optimizer import adam_init as ref_adam_init
from repro.train.optimizer import adam_update as ref_adam_update
from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.data.pipeline import token_batch_iterator
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models import api
from repro_torch.models.moe import uses_ep

WORLD_TIMEOUT = 120.0       # seconds a world may take, spawn to join
B, S, LR = 4, 16, 1e-3
ODD_S = 15                  # model (2) does not divide it: EP scheme B
DENSE = ["tinyllama-1.1b-reduced", "gemma2-9b-reduced"]
GENERIC = ["mamba2-1.3b-reduced", "whisper-large-v3-reduced"]
MOE = "olmoe-1b-7b-reduced"
ARCHS = DENSE + GENERIC + [MOE]
D_MODEL, D_FF = 32, 64      # the moe_forward_ep cases' layer
# (x's (B, S), capacity factor, REPRO_MOE_DISPATCH, slabs gathered inside)
EP_CASES = [((2, 8), 64.0, "cumsum", True), ((2, 8), 1.25, "cumsum", True),
            ((4, 1), 64.0, "cumsum", True), ((4, 1), 1.25, "cumsum", True),
            ((2, 8), 1.25, "top_k", False), ((4, 1), 1.25, "top_k", False)]
LAUNCH = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1"]


# ------------------------------------------------------------ the inputs

@functools.lru_cache(maxsize=None)
def _setup(arch: str, seq: int = S):
    """(reference params as numpy, numpy batch): the reference's
    ``init_params`` at key 0; the pipeline's batch of B × ``seq`` at
    seed 3, weights 1 + rank/B."""
    cfg = ref_get_config(arch)
    rp = jax.tree_util.tree_map(np.asarray, jax.jit(
        ref_api.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    batch = next(token_batch_iterator(
        B, seq, cfg.vocab, seed=3, d_model=cfg.d_model,
        frames=cfg.enc_seq if cfg.family == "audio" else 0,
        patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
        weights=True))
    batch["weights"] = (1.0 + np.arange(B) / B).astype(np.float32)
    return rp, batch


def _moe_params():
    from repro.configs.base import MoEConfig as RefMoE
    from repro.models import moe as ref_moe
    p = ref_moe.init_moe(jax.random.PRNGKey(1), D_MODEL, D_FF,
                         RefMoE(num_experts=4, top_k=2), jnp.float32)
    rng = np.random.default_rng(0)
    xs = [rng.normal(0, 1, c[0] + (D_MODEL,)).astype(np.float32)
          for c in EP_CASES]
    return jax.tree_util.tree_map(np.asarray, p), xs


def _train_kw(arch, profile, seq=S, **extra):
    params, batch = _setup(arch, seq)
    return dict(arch=arch, params=params, batch=batch, steps=2, lr=LR,
                profile=profile, want_grads=True, **extra)


def _plans(ckpt):
    moe_params, xs = _moe_params()
    two = [(f"{a}-{p}", "train", _train_kw(a, p)) for a in DENSE
           for p in ("2d", "fsdp")]
    four = two + [(f"{MOE}-{p}", "train", _train_kw(MOE, p))
                  for p in ("2d", "fsdp")]
    four += [(f"{a}-2d", "train", _train_kw(a, "2d")) for a in GENERIC]
    four += [(f"{MOE}-2d-outside", "train", _train_kw(
        MOE, "2d", env={"REPRO_MOE_GATHER_INSIDE": "0"})),
        (f"{MOE}-2d-odd", "train", _train_kw(MOE, "2d", seq=ODD_S))]
    params, batch = _setup(DENSE[0])
    four += [("bf16", "bf16", dict(arch=DENSE[0], params=params,
                                   batch=batch))]
    four += [("moe_ep", "moe_ep", dict(params=moe_params, cases=[
        (x,) + c[1:] for x, c in zip(xs, EP_CASES)])),
        ("launch", "launch", dict(argv=LAUNCH + ["--mesh", "2,2", "--ckpt",
                                                 ckpt]))]
    return {2: {(2,): two, (1, 2): two}, 4: {(2, 2): four}}


# The reference's sharded side, in a subprocess with 4 virtual devices:
# olmoe's sharded step on make_train_mesh(2, 2) under both profiles (the
# step's value_and_grad, then adam_update, twice; params placed by
# param_shardings), moe_forward_ep on the cases, and which meshes
# moe_forward sends to moe_forward_ep.
SCRIPT = r'''
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import sharding
from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_train_mesh
from repro.models import moe as moe_mod
from repro.train import steps
from repro.train.optimizer import adam_init, adam_update

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {"train": {}}
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
for key, (arch, profile, params, batch, lr, mesh) in inp["train"].items():
    sharding.set_profile(profile)
    cfg = get_config(arch)
    mesh = make_train_mesh(*mesh)
    with sharding.use_mesh(mesh):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        p = jax.device_put(p, sharding.param_shardings(p, mesh))
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        # make_train_step's two halves: value_and_grad, then adam_update
        vg = jax.jit(jax.value_and_grad(
            lambda q: steps.lm_loss(q, cfg, b, unroll=True), has_aux=True))
        upd = jax.jit(functools.partial(adam_update, lr=lr))
        opt = adam_init(p)
        metrics, g1 = [], None
        for _ in range(2):
            (loss, (ce, aux)), g = vg(p)
            g1 = np_tree(g) if g1 is None else g1
            p, opt = upd(p, g, opt)
            metrics.append({"loss": float(loss), "ce": float(ce),
                            "aux": float(aux)})
    out["train"][key] = {"grads": g1, "params": np_tree(p),
                         "metrics": metrics}
sharding.set_profile("2d")

params = jax.tree_util.tree_map(jnp.asarray, inp["moe_params"])
mesh = make_train_mesh(2, 2)
out["moe_ep"] = []
with sharding.use_mesh(mesh):
    for x, cf, dispatch, inside in inp["moe_cases"]:
        os.environ["REPRO_MOE_DISPATCH"] = dispatch
        os.environ["REPRO_MOE_GATHER_INSIDE"] = str(int(inside))
        cfg = MoEConfig(num_experts=4, top_k=2, capacity_factor=cf)
        y, aux = jax.jit(lambda pp, xx: moe_mod.moe_forward_ep(
            pp, xx, cfg, mesh))(params, jnp.asarray(x))
        out["moe_ep"].append((np.asarray(y), float(aux)))
os.environ.pop("REPRO_MOE_DISPATCH")
os.environ.pop("REPRO_MOE_GATHER_INSIDE")

# which meshes moe_forward sends to moe_forward_ep (traced, not run)
taken = []
real_ep = moe_mod.moe_forward_ep
moe_mod.moe_forward_ep = lambda *a: (taken.append(1), real_ep(*a))[1]
decisions = {}
x = jax.ShapeDtypeStruct((4, 4, 8), jnp.float32)
for shape in ((2, 2), (2, 1), (1, 4), (4, 1), (4,), (1,)):
    names = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)
    for profile in ("2d", "fsdp"):
        sharding.set_profile(profile)
        for e in (4, 3):
            cfg = MoEConfig(num_experts=e, top_k=2, capacity_factor=64.0)
            p = jax.eval_shape(lambda: moe_mod.init_moe(
                jax.random.PRNGKey(0), 8, 16, cfg, jnp.float32))
            taken.clear()
            with sharding.use_mesh(mesh):
                jax.eval_shape(lambda pp, xx: moe_mod.moe_forward(
                    pp, xx, cfg), p, x)
            decisions[(names, shape, profile, e)] = bool(taken)
sharding.set_profile("2d")
out["decisions"] = decisions
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''


def _single_device(arch: str):
    """The reference's first gradients, two steps' metrics and the params
    after them, on one device (make_train_step's two halves)."""
    cfg = ref_get_config(arch)
    params, batch = _setup(arch)
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


def _reference_inputs():
    moe_params, xs = _moe_params()
    train = {}
    for p in ("2d", "fsdp"):
        params, batch = _setup(MOE)
        train[f"{MOE}-{p}"] = (MOE, p, params, batch, LR, (2, 2))
    params, batch = _setup(MOE, ODD_S)
    train[f"{MOE}-2d-odd"] = (MOE, "2d", params, batch, LR, (2, 2))
    return {"train": train, "moe_params": moe_params,
            "moe_cases": [(x,) + c[1:] for x, c in zip(xs, EP_CASES)]}


def _unsharded_launch(root):
    """The launcher's log and checkpoint without a mesh."""
    import contextlib
    import io

    from repro_torch.launch.train import main
    path = str(root / "llm_sharded_launch_unsharded.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(LAUNCH + ["--ckpt", path])
    return buf.getvalue(), path


def _build(root):
    """Everything the tests read: the worlds' results, the reference's,
    the launcher's unsharded run."""
    inp, out = root / "llm_sharded_ref_in.pkl", root / "llm_sharded_ref.pkl"
    with open(inp, "wb") as f:
        pickle.dump(_reference_inputs(), f)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, str(inp),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    worlds = {}

    def run_worlds():
        for n, plans in _plans(ckpt).items():
            try:
                worlds[n] = run_ranks(ranks.world, n, (plans,),
                                      device="cpu", timeout=WORLD_TIMEOUT,
                                      workdir=str(root))
            except Exception as e:          # raised below, in the test
                worlds[n] = e

    # the worlds wait in a thread while this one runs the reference's
    # single-device steps and the launcher's unsharded run
    ckpt = str(root / "llm_sharded_launch_mesh.npz")
    thread = threading.Thread(target=run_worlds)
    thread.start()
    try:
        single = {arch: _single_device(arch) for arch in DENSE + GENERIC}
        launch = _unsharded_launch(root)
        _, err = proc.communicate(timeout=2 * WORLD_TIMEOUT)
    finally:
        thread.join()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for n, w in worlds.items():
        if isinstance(w, Exception):
            raise w
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    ref["train"].update(single)
    return {"worlds": worlds, "ref": ref, "launch": launch, "ckpt": ckpt}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """``_build()``'s result, computed by the first test worker to ask
    and read from the run's temp dir by the others."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "torch_llm_sharded.pkl"
    with open(root / "torch_llm_sharded.lock", "w") as lock:
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
    """Rank 0's result, after checking that no rank failed and that every
    rank's gathered params are bitwise rank 0's."""
    per = [r[mesh][key] for r in shared["worlds"][size]]
    for rank, r in enumerate(per):
        assert not isinstance(r, Exception), f"rank {rank}: {r}"
    if isinstance(per[0], dict) and "digest" in per[0]:
        assert len({r["digest"] for r in per}) == 1, "ranks differ"
        for r in per:
            assert not r["faults"], r["faults"]
    return per[0]


def _flat_ref(tree):
    return {ref_sharding._path_str(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_metrics_and_grads(got, want):
    """``got``'s metrics and first gradients against ``want``'s; returns
    ``want``'s flat gradients and its largest gradient element."""
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    wg = _flat_ref(want["grads"])
    assert sorted(got["grads"]) == sorted(wg)
    top = max(float(np.abs(w).max()) for w in wg.values())
    for k, w in wg.items():
        np.testing.assert_allclose(
            got["grads"][k], w, rtol=1e-4, atol=_grad_atol(w, top),
            err_msg=f"gradient {k}")
    return wg, top


def _grad_atol(w, top):
    """The first gradients' atol for leaf ``w`` (``top``: the largest
    gradient element of any leaf)."""
    return 1e-4 * float(np.abs(w).max()) + 1e-6 * top


def _check_train(got, want, wide: float = 0.0):
    """``got`` (a world's rank 0) against ``want`` (the reference's):
    metrics, first gradients, params after two steps.  ``wide`` > 0
    widens the param rule from the gradient tolerance: an element whose
    first gradient lies within ``wide`` times its leaf's gradient atol
    of zero is held within ``LR``, one Adam step, of ``want``'s."""
    wg, top = _check_metrics_and_grads(got, want)
    wp = _flat_ref(want["params"])
    n_noise = 0
    for k, w in wg.items():
        p, q = got["params"][k], wp[k].astype(np.float64)
        noise = (np.abs(w) <= max(1e-5 * np.abs(w).max(), 1e-6 * top)
                 ) & (w != 0)
        lim = np.where(noise, 4 * LR, 1e-4 + 1e-3 * np.abs(q))
        if wide:
            near = ~noise & (np.abs(w) <= wide * _grad_atol(w, top))
            lim = np.where(near, np.maximum(lim, LR), lim)
        err = np.abs(p - q)
        assert bool((err <= lim).all()), (k, float((err - lim).max()))
        n_noise += int(noise.sum())
    assert n_noise < 0.01 * sum(w.size for w in wg.values())


TRAIN_CASES = ([(2, (2,), a, p) for a in DENSE for p in ("2d", "fsdp")]
               + [(2, (1, 2), a, p) for a in DENSE for p in ("2d", "fsdp")]
               + [(4, (2, 2), a, p) for a in DENSE for p in ("2d", "fsdp")]
               + [(4, (2, 2), a, "2d") for a in GENERIC])


@pytest.mark.parametrize("size,mesh,arch,profile", TRAIN_CASES, ids=[
    f"{'x'.join(map(str, m))}-{a.split('-')[0]}-{p}"
    for _, m, a, p in TRAIN_CASES])
def test_train_matches_single_device_reference(shared, size, mesh, arch,
                                               profile):
    """Two steps under ``use_mesh`` against the reference's single-device
    steps (GSPMD keeps the values): dense models under tensor
    parallelism (tinyllama's one kv head replicated on ``model``;
    gemma2's tied embeddings, softcaps and window) and FSDP, the ssm and
    audio families through the generic per-layer gather."""
    got = _ranks(shared, size, mesh, f"{arch}-{profile}")
    _check_train(got, shared["ref"]["train"][arch])


@pytest.mark.parametrize("profile", ["2d", "fsdp", "2d-outside", "2d-odd"])
def test_moe_train_matches_reference_sharded_step(shared, profile):
    """olmoe on (2, 2) against the reference's own sharded step: under
    ``"2d"`` both take ``moe_forward_ep`` (scheme A: capacity from each
    shard's tokens, so the config's capacity factor drops other tokens
    than one device does), the expert slabs gathered inside it or, with
    ``REPRO_MOE_GATHER_INSIDE=0``, by the layer (the same values); at S
    = 15, which ``model`` does not divide, scheme B (each model rank its
    experts' share of every token; its inputs' gradients summed over
    ``model``); under ``"fsdp"`` the single-device path over the sharded
    batch, capacity and selection over all tokens."""
    got = _ranks(shared, 4, (2, 2), f"{MOE}-{profile}")
    want = shared["ref"]["train"][
        f"{MOE}-{profile.replace('-outside', '')}"]
    assert got["metrics"][0]["aux"] > 0
    _check_train(got, want)


def test_bf16_gradients_match_unsharded(shared):
    """tinyllama in its bf16 compute on (2, 2) (the f32 masters gathered
    cast to bf16 and moved as bytes, the TP sums over bf16 activations):
    the first gradient, gathered whole, each leaf at most twice as far
    from the unsharded f32 gradient as the unsharded bf16 one is (plus
    1e-6 of the largest leaf's norm; a leaf moved to the wrong rank or
    dims lands as far away as the gradient is large); the loss within
    bf16's precision, 2^-8, of the unsharded bf16 loss (one scalar: its
    distance from f32, about 1e-3 either way, varies with the rounding
    from batch to batch, so it is not held to twice the unsharded one's)."""
    got = _ranks(shared, 4, (2, 2), "bf16")
    ls, l16, l32 = got["losses"]
    assert abs(ls - l16) <= 2 ** -8 * abs(l16)
    top = max(got["norm"].values())
    assert all(got["unsharded"][k] > 0 for k in got["norm"])
    for k, d in got["sharded"].items():
        assert d <= 2 * got["unsharded"][k] + 1e-6 * top, (
            k, d, got["unsharded"][k], got["norm"][k])


@pytest.mark.parametrize("case", range(len(EP_CASES)), ids=[
    f"{'A' if s[1] > 1 else 'B'}-{s[0]}x{s[1]}-cf{cf}-{d}-"
    f"{'inside' if i else 'outside'}" for s, cf, d, i in EP_CASES])
def test_moe_forward_ep_matches_reference(shared, case):
    """``moe_forward_ep`` on (2, 2): scheme A (S = 8: tokens over
    ``model``, two ``all_to_all``s) and scheme B (S = 1: each rank its
    experts, an f32 sum), without drops (capacity factor 64) and with
    (1.25), under ``REPRO_MOE_DISPATCH`` ``cumsum`` and ``top_k``, the
    slabs' ``data`` shards gathered inside or whole already; each rank's
    y is the reference's at its data rows."""
    want_y, want_aux = shared["ref"]["moe_ep"][case]
    per = [r[(2, 2)]["moe_ep"] for r in shared["worlds"][4]]
    for rank, r in enumerate(per):
        assert not isinstance(r, Exception), f"rank {rank}: {r}"
        y, aux = r[case]
        rows = want_y.shape[0] // 2
        d = rank // 2
        np.testing.assert_allclose(y, want_y[d * rows:(d + 1) * rows],
                                   rtol=0, atol=1e-5)
        assert abs(aux - want_aux) <= 1e-6


def test_moe_dispatch_condition_matches_reference(shared):
    """``moe_forward`` takes ``moe_forward_ep`` on exactly the meshes the
    reference's does: a ``model`` dim, ``"2d"``, more than one device,
    ``model`` dividing the experts ((2, 1) included)."""
    got = {}
    try:
        for key in shared["ref"]["decisions"]:
            names, shape, profile, e = key
            sharding.set_profile(profile)
            got[key] = uses_ep(sharding.MeshShape(names, shape),
                               MoEConfig(num_experts=e, top_k=2))
    finally:
        sharding.set_profile("2d")
    assert got == shared["ref"]["decisions"]
    dm = ("data", "model")
    assert got[(dm, (2, 1), "2d", 4)] and not got[(dm, (2, 2), "fsdp", 4)]
    assert not got[(dm, (2, 2), "2d", 3)]


def _losses(log):
    return [float(m[1]) for m in re.finditer(r"loss (\S+)", log)]


def test_launch_train_on_a_mesh(shared):
    """``launch.train --mesh 2,2`` on a 4-rank world: rank 0 logs the
    unsharded run's losses, and its checkpoint (rank 0 wrote the whole
    params) holds the unsharded save's keys and shapes, loads into
    unsharded params equal to the world's gathered ones, and loads back
    into every rank's blocks."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import init_train_state

    per = [r[(2, 2)]["launch"] for r in shared["worlds"][4]]
    for rank, r in enumerate(per):
        assert not isinstance(r, Exception), f"rank {rank}: {r}"
        assert r["blocks_reload_bitwise"] and r["whole_equals_ckpt"]
    log, path = shared["launch"]
    assert len(_losses(per[0]["log"])) == 2
    assert not any(_losses(r["log"]) for r in per[1:])
    np.testing.assert_allclose(_losses(per[0]["log"]), _losses(log),
                               atol=2e-4)
    with np.load(shared["ckpt"]) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    like, _ = init_train_state(1, get_config("tinyllama-1.1b").reduced(),
                               device="cpu")
    got, meta = load_checkpoint(shared["ckpt"], like)
    want, _ = load_checkpoint(path, like)
    assert meta["step"] == 2
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=4 * 3e-4)


def test_no_process_group_in_the_test_process(shared):
    assert not dist.is_initialized()


# ------------------------------------------------------ rules, no world

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    cfg = ref_get_config(arch)
    tree = jax.eval_shape(lambda: ref_api.init_params(
        jax.random.PRNGKey(0), cfg))
    return [(ref_sharding._path_str(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _nest(pairs):
    """{"a/b": x} -> {"a": {"b": x}}."""
    out = {}
    for path, leaf in pairs:
        *head, last = path.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_match_reference(arch):
    """For the config and its reduced variant, under both profiles, on
    (1, 1), (2, 2), (16, 16) and (2, 16, 16) with ``pod``: the port's
    ``param_shardings``/``spec_for_param``/``filter_spec``/
    ``check_divisible`` and ``batch_shardings`` give the reference's
    ``PartitionSpec``s leaf for leaf, from the same (path, shape) list;
    the port's params have the reference's paths and shapes."""
    for name in (arch, f"{arch}-reduced"):
        pairs = _ref_shapes(name)
        ours = [(k, tuple(v)) for k, v in sharding.flat_tree(
            api.param_shapes(get_config(name)))]
        assert ours == pairs, name
        cfg = ref_get_config(name)
        batch = {"tokens": (512, 64), "labels": (512, 64), "weights": (8,),
                 "frames": (512, cfg.enc_seq or 1, cfg.d_model)}
        for shape, names in MESHES.values():
            ref_mesh = AbstractMesh(shape, names)
            mesh = sharding.MeshShape(names, shape)
            for profile in ("2d", "fsdp"):
                ref_sharding.set_profile(profile)
                sharding.set_profile(profile)
                try:
                    want = ref_sharding.param_specs_abstract(
                        _nest([(k, jax.ShapeDtypeStruct(s, jnp.float32))
                               for k, s in pairs]), ref_mesh)
                    want = {ref_sharding._path_str(p): tuple(v.spec)
                            for p, v in jax.tree_util.tree_flatten_with_path(
                                want)[0]}
                    got = sharding.flat_specs(sharding.param_shardings(
                        _nest([(k, torch.Size(s)) for k, s in pairs]), mesh))
                    assert got == want, (name, shape, profile)
                    for k, s in pairs:
                        spec = sharding.check_divisible(sharding.filter_spec(
                            sharding.spec_for_param(k, len(s)), mesh), s,
                            mesh)
                        assert spec == want[k]
                    wb = ref_sharding.batch_shardings(
                        {k: jax.ShapeDtypeStruct(v, jnp.int32)
                         for k, v in batch.items()}, ref_mesh)
                    gb = sharding.batch_shardings(
                        {k: torch.Size(v) for k, v in batch.items()}, mesh)
                    assert {k: tuple(v.spec) for k, v in wb.items()} == gb
                    assert sharding.dp_spec(mesh) == \
                        ref_sharding.dp_spec(ref_mesh)
                finally:
                    ref_sharding.set_profile("2d")
                    sharding.set_profile("2d")


def test_size_one_mesh_is_the_unsharded_step():
    """Under a mesh whose dims all have size 1 (the host mesh of a
    process that is no rank) the step is the unsharded one, bit for
    bit, and ``shard_act``/``shard_attn_act`` change nothing."""
    arch = "tinyllama-1.1b-reduced"
    params, batch = _setup(arch)
    plain = ranks.train("cpu", None, **_train_kw(arch, "2d"))
    mesh = make_host_mesh()
    assert isinstance(mesh, sharding.MeshShape)
    host = ranks.train("cpu", mesh, **_train_kw(arch, "2d"))
    assert plain["digest"] == host["digest"]
    assert plain["metrics"] == host["metrics"]
    x = torch.ones(2, 3, 4, 5)
    assert sharding.shard_act(x, "data", None) is x
    assert sharding.shard_attn_act(x) is x


def test_use_mesh_restores_the_outer_mesh():
    """A nested ``use_mesh`` makes its mesh active and, on exit, the
    outer one again; leaving the outer one leaves none."""
    outer = sharding.MeshShape(("data", "model"), (1, 1))
    inner = sharding.MeshShape(("data",), (1,))
    assert sharding.active_mesh() is None
    with sharding.use_mesh(outer):
        with sharding.use_mesh(inner):
            assert sharding.active_mesh() is inner
        assert sharding.active_mesh() is outer
    assert sharding.active_mesh() is None
