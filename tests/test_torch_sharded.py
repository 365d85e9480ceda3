"""The sharded pipeline on ``torch.distributed``: the PSI rounds, the
coreset fit and the SplitNN engine of the port on gloo worlds of spawned
CPU ranks, held against the reference's single-device results (the
claim of its own ``tests/test_sharded.py``: sharded equals unsharded)
and against the port's unsharded run.

Three worlds, each spawned once for the whole file (the first test that
needs one runs it; the results are shared through a file under the
run's temp dir, so parallel test workers do not spawn it again): 2 ranks
on a ``("data",)`` mesh, 3 ranks (odd: the pairs and clients do not
divide), 8 ranks on a ``(data 2, model 4)`` grid (and an 8-way
``("data",)`` mesh).  Stores are ``file://`` under the temp dir (no TCP
port), and every world is joined within ``WORLD_TIMEOUT`` seconds, so a
hung collective fails its tests instead of the run.  No process group
is ever made in the test process.  The rank side is
``tests/_torch_sharded_ranks.py``, which imports the port only.

Tolerances, as the reference states its own:
- PSI intersections and modeled costs, coreset indices, weights and the
  local clusterings: bitwise (each rank runs the unsharded per-pair and
  per-client program).
- Training: the all-reduce sums the loss and gradients in another order
  than one device does, so epoch losses are held within rtol 1e-4, atol
  1e-6, accuracy within 0.02 (the pipeline's within 0.03), counters
  (steps, comm_bytes, gather_payload_bytes, one host sync an epoch)
  exactly.  Under the int8/fp8 wire the same: a batch of 64 splits into
  blocks of 32 rows, whole blocks of the wire's 8 rows, so the wire
  rounds the same rows together as one device does (ROADMAP R3).
- Every rank returns the same bits; fused and unfused gathers train
  bitwise the same (the plain K2 gathers first either way).
"""
import fcntl
import os
import pickle

import jax
import numpy as np
import pytest

import _torch_sharded_ranks as ranks
from conftest import make_cls_partition
from repro.config import AlignOptions as JaxAlign
from repro.config import EngineOptions as JaxEngine
from repro.core.coreset import cluster_coreset as jax_coreset
from repro.core.mpsi import MPSI as JAX_MPSI
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import evaluate as jax_evaluate
from repro.core.splitnn import init_splitnn as jax_init
from repro.core.splitnn import train_splitnn as jax_train
from repro.core.treecss import run_pipeline as jax_pipeline
from repro.data.synthetic import make_id_universe
from repro.psi import engine as jax_engine
from repro_torch.launch.mesh import run_ranks

WORLD_TIMEOUT = 110.0       # seconds a world may take, spawn to join


# ------------------------------------------------------------ the inputs

def _raw(part):
    return ([np.asarray(f) for f in part.client_features],
            np.asarray(part.labels), list(part.feature_slices))


def _pair_batch(npairs, base_n, seed):
    """The reference test's pair batches (``tests/test_sharded.py``)."""
    rng = np.random.default_rng(seed)
    senders, receivers, seeds = [], [], []
    for i in range(npairs):
        a = np.unique(rng.integers(0, 2**55, base_n + 211 * i,
                                   dtype=np.int64))
        b = np.unique(rng.integers(0, 2**55, base_n, dtype=np.int64))
        b = np.unique(np.concatenate([a[:base_n // 3], b]))
        senders.append(a)
        receivers.append(b)
        seeds.append((int(rng.integers(0, 2**32)),
                      int(rng.integers(0, 2**32))))
    return senders, receivers, seeds


def _split(n, seed, rows_seed, n_train):
    full = make_cls_partition(n=n, d=12, seed=seed)
    rows = np.random.default_rng(rows_seed).permutation(n)
    return full.take(rows[:n_train]), full.take(rows[n_train:])


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


LR = dict(model="lr", n_classes=2, lr=0.05, max_epochs=8)
MLP = dict(model="mlp", n_classes=4, lr=0.01, batch_size=64, max_epochs=5)
PIPE_LR = dict(model="lr", n_classes=2, lr=0.05, batch_size=64,
               max_epochs=15)
KNN = dict(model="knn", n_classes=2)


def _inputs():
    """Every scenario's arguments (numpy only) and the reference data
    they came from."""
    tr_lr = make_cls_partition(n=420, d=12, seed=6)
    te_lr = make_cls_partition(n=200, d=12, seed=6)
    tr_mlp = make_cls_partition(n=256, d=12, classes=4, seed=7)
    pipe_tr, pipe_te = _split(640, 3, 2, 480)
    knn_tr, knn_te = _split(700, 0, 1, 520)
    fused = {n: make_cls_partition(n=n, d=11, seed=9) for n in (256, 230)}
    sets, core = make_id_universe(10, 600, 0.7, seed=23)
    # RSA's blind signatures are host bigint work: a smaller universe
    rsa_sets, rsa_core = make_id_universe(4, 300, 0.7, seed=23)
    init = lambda cfg, part: _numpy_tree(jax_init(
        JaxConfig(**cfg), [f.shape[1] for f in part.client_features]))
    kw = {}
    for sort in ("host", "device"):
        for npairs in (5, 8):
            kw[f"oprf-{sort}-{npairs}"] = ("oprf", dict(
                batch=_pair_batch(npairs, 1500, npairs), sort=sort))
    kw["match"] = ("match", dict(batch=_pair_batch(3, 900, 17)))
    kw["tree_mpsi-rsa"] = ("tree_mpsi", dict(sets=rsa_sets, protocol="rsa"))
    kw["tree_mpsi-oprf"] = ("tree_mpsi", dict(sets=sets, protocol="oprf"))
    kw["coreset"] = ("coreset", dict(
        part=_raw(make_cls_partition(n=420, d=12, clients=3, seed=4)), k=6,
        seed=1))
    kw["coreset-ragged"] = ("coreset", dict(
        part=_raw(make_cls_partition(n=330, d=11, clients=3, seed=8)), k=5,
        seed=2))
    for bs in (64, 60):
        cfg = dict(LR, batch_size=bs)
        kw[f"train-lr-{bs}"] = ("train", dict(
            tr=_raw(tr_lr), te=_raw(te_lr), cfg=cfg, init=init(cfg, tr_lr)))
    kw["train-mlp"] = ("train", dict(tr=_raw(tr_mlp), te=None, cfg=MLP,
                                     init=init(MLP, tr_mlp)))
    for quant in ("int8", "fp8"):
        kw[f"train-mlp-{quant}"] = ("train", dict(
            tr=_raw(tr_mlp), te=None, cfg=MLP, init=init(MLP, tr_mlp),
            quant=quant))
    for n, part in fused.items():
        cfg = dict(LR, batch_size=64, max_epochs=4)
        for fuse in (True, False):
            kw[f"fused-{n}-{fuse}"] = ("train", dict(
                tr=_raw(part), te=None, cfg=cfg, init=init(cfg, part),
                fuse_gather=fuse))
    kw["pipeline-lr"] = ("pipeline", dict(
        tr=_raw(pipe_tr), te=_raw(pipe_te), cfg=PIPE_LR,
        init=init(PIPE_LR, pipe_tr)))
    kw["pipeline-knn"] = ("pipeline", dict(
        tr=_raw(knn_tr), te=_raw(knn_te), cfg=KNN, init=None,
        psi_backend="device"))
    kw["refusals"] = ("refusals", dict(
        tr=_raw(make_cls_partition(n=128, d=9, seed=1)),
        cfg=dict(LR, batch_size=64, max_epochs=2)))
    kw["resolve"] = ("resolve", {})
    data = dict(tr_lr=tr_lr, te_lr=te_lr, tr_mlp=tr_mlp, pipe=(pipe_tr,
                pipe_te), knn=(knn_tr, knn_te),
                core={"rsa": rsa_core, "oprf": core})
    return kw, data


def _plan(kw, keys):
    return [(key,) + kw[key] for key in keys]


ONE_D = ["oprf-host-5", "oprf-host-8", "oprf-device-5", "oprf-device-8",
         "match", "tree_mpsi-oprf", "coreset", "coreset-ragged",
         "train-lr-64", "train-lr-60", "train-mlp", "pipeline-knn",
         "resolve"]
WORLDS = {
    2: {"data": ONE_D + ["tree_mpsi-rsa", "pipeline-lr"],
        "one": ["oprf-host-5", "coreset", "train-lr-60", "resolve",
                "refusals"],
        "host": ["resolve"]},
    3: {"data": ONE_D},
    8: {"2x4": ["train-lr-64", "train-lr-60", "train-mlp",
                "train-mlp-int8", "train-mlp-fp8",
                "fused-256-True", "fused-256-False", "fused-230-True",
                "fused-230-False", "pipeline-lr", "refusals", "resolve"],
        "data": ["train-lr-64", "train-lr-60", "resolve"]},
}


# ------------------------------------------------- shared, computed once

def _shared(tmp_path_factory, name, build):
    """``build()``'s result, computed by the first test worker to ask
    and read from the run's temp dir by the others."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"torch_sharded_{name}.pkl"
    with open(root / f"torch_sharded_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = build(root)
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, path)
        with open(path, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _world(tmp_path_factory, inputs, size):
    kw, _ = inputs

    def build(root):
        plans = {mesh: _plan(kw, keys) for mesh, keys in WORLDS[size].items()}
        return run_ranks(ranks.world, size, (plans,), device="cpu",
                         timeout=WORLD_TIMEOUT, workdir=str(root))
    return _shared(tmp_path_factory, f"world{size}", build)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    cache = {}

    def get(size):
        if size not in cache:
            cache[size] = _world(tmp_path_factory, inputs, size)
        return cache[size]
    return get


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory, inputs):
    """The port's own unsharded run of every scenario (mesh=None)."""
    kw, _ = inputs
    keys = sorted({k for plans in WORLDS.values() for ks in plans.values()
                   for k in ks} - {"refusals", "resolve"})
    return _shared(tmp_path_factory, "unsharded", lambda root: ranks.run(
        "cpu", None, _plan(kw, keys)))


def _jax_reference(inputs):
    kw, data = inputs
    ref = {}
    for key in ("oprf-host-5", "oprf-host-8", "oprf-device-5",
                "oprf-device-8"):
        s, r, sd = kw[key][1]["batch"]
        ref[key] = jax_engine.oprf_round(s, r, sd, options=JaxAlign(
            impl="pallas", sort=kw[key][1]["sort"])).intersections
    s, r, _ = kw["match"][1]["batch"]
    ref["match"] = jax_engine.match_round(
        [x & jax_engine.TAG_MASK for x in r], r,
        [x & jax_engine.TAG_MASK for x in s],
        options=JaxAlign(impl="pallas")).intersections
    for protocol in ("rsa", "oprf"):
        st = JAX_MPSI["tree"](kw[f"tree_mpsi-{protocol}"][1]["sets"],
                              use_he=False, options=JaxAlign(
                                  protocol=protocol, psi_backend="device"))
        ref[f"tree_mpsi-{protocol}"] = dict(
            intersection=st.intersection, total_bytes=st.total_bytes,
            total_messages=st.total_messages, rounds=st.rounds,
            device_dispatches=st.device_dispatches)
    for key in ("coreset", "coreset-ragged"):
        a = kw[key][1]
        part = ranks.partition(a["part"])
        res = jax_coreset(part, a["k"], seed=a["seed"])
        ref[key] = dict(indices=res.indices, weights=res.weights,
                        assign=[c.assign for c in res.local],
                        sq_dist=[c.sq_dist for c in res.local],
                        centroids=[np.asarray(c.centroids)
                                   for c in res.local])
    for key in ("train-lr-64", "train-lr-60", "train-mlp",
                "train-mlp-int8", "train-mlp-fp8"):
        a = kw[key][1]
        cfg = JaxConfig(**a["cfg"])
        part = ranks.partition(a["tr"])
        rep = jax_train(part, cfg, options=JaxEngine(quant=a.get("quant")))
        ref[key] = dict(
            losses=np.asarray(rep.losses), epochs=rep.epochs,
            steps=rep.steps, comm_bytes=rep.comm_bytes,
            gather_payload_bytes=rep.engine_stats.gather_payload_bytes,
            metric=None if a["te"] is None else jax_evaluate(
                rep.params, cfg, ranks.partition(a["te"])))
    for key, backend in (("pipeline-lr", "host"), ("pipeline-knn",
                                                   "device")):
        tr, te = data["pipe" if key == "pipeline-lr" else "knn"]
        rep = jax_pipeline(tr, te, JaxConfig(**kw[key][1]["cfg"]),
                           variant="treecss", clusters_per_client=4, seed=0,
                           align=JaxAlign(psi_backend=backend))
        ref[key] = dict(intersection=rep.mpsi.intersection,
                        total_bytes=rep.mpsi.total_bytes,
                        n_train=rep.n_train, indices=rep.coreset.indices,
                        weights=rep.coreset.weights, metric=rep.metric,
                        losses=np.asarray(rep.train.losses),
                        epochs=rep.train.epochs)
    return ref


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    """The reference's single-device result of every scenario."""
    return _shared(tmp_path_factory, "reference",
                   lambda root: _jax_reference(inputs))


# --------------------------------------------------------------- checks

def _same(a, b):
    """Equal bits (arrays of any dtype, lists of them, numbers)."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _ranks(world, mesh, key):
    """The result of ``key`` on ``mesh``, after checking that every rank
    returned the same bits."""
    got = [rank[mesh][key] for rank in world]
    for r, other in enumerate(got[1:], 1):
        assert _same(got[0], other), f"rank {r} differs from rank 0"
    return got[0]


def _close_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _check_train(got, want, shards, model_shards=1):
    assert got["shards"] == shards
    assert got["model_shards"] == model_shards
    assert got["padded_batch"] % shards == 0
    assert got["epochs"] == want["epochs"]
    _close_losses(got["losses"], want["losses"])
    assert got["steps"] == want["steps"]
    assert got["comm_bytes"] == want["comm_bytes"]
    assert got["gather_payload_bytes"] == want["gather_payload_bytes"]
    assert got["host_syncs"] == got["epochs"] == got["dispatches"]
    if want.get("metric") is not None:
        assert abs(got["metric"] - want["metric"]) <= 0.02


# ------------------------------------------------------------- PSI engine

@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("sort", ["host", "device"])
@pytest.mark.parametrize("npairs", [5, 8])
def test_oprf_round_sharded_byte_identical(worlds, unsharded, reference,
                                           size, sort, npairs):
    key = f"oprf-{sort}-{npairs}"
    got = _ranks(worlds(size), "data", key)
    assert got["shards"] == size
    assert got["dispatches"] == (1 if sort == "device" else 2)
    assert unsharded[key]["shards"] == 1
    assert len(got["inters"]) == npairs
    assert _same(got["inters"], unsharded[key]["inters"])
    assert _same(got["inters"], [np.asarray(x) for x in reference[key]])


@pytest.mark.parametrize("size", [2, 3])
def test_match_round_sharded_byte_identical(worlds, unsharded, reference,
                                            size):
    got = _ranks(worlds(size), "data", "match")
    assert got["shards"] == size
    assert _same(got["inters"], unsharded["match"]["inters"])
    assert _same(got["inters"], [np.asarray(x) for x in reference["match"]])


@pytest.mark.parametrize("size,protocol", [(2, "rsa"), (2, "oprf"),
                                           (3, "oprf")])
def test_tree_mpsi_sharded_matches_single_device(worlds, unsharded,
                                                 reference, inputs, size,
                                                 protocol):
    key = f"tree_mpsi-{protocol}"
    got = _ranks(worlds(size), "data", key)
    assert _same(got, unsharded[key])
    want = reference[key]
    assert np.array_equal(got["intersection"], want["intersection"])
    assert np.array_equal(got["intersection"], inputs[1]["core"][protocol])
    for f in ("total_bytes", "total_messages", "rounds",
              "device_dispatches"):
        assert got[f] == want[f], f


# ---------------------------------------------------------------- coreset

def _check_coreset(got, unsharded, want, shards):
    assert got["batched"] and got["shards"] == shards
    assert unsharded["shards"] == 1
    for f in ("indices", "weights", "assign", "sq_dist", "centroids"):
        assert _same(got[f], unsharded[f]), f
    assert np.array_equal(got["indices"], want["indices"])
    assert np.array_equal(got["weights"], want["weights"])   # f32 bits
    for g, w in zip(got["assign"], want["assign"]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("size", [2, 3])
def test_coreset_sharded_byte_identical(worlds, unsharded, reference, size):
    """Same-shape clients: the client batch shards over ``data``."""
    _check_coreset(_ranks(worlds(size), "data", "coreset"),
                   unsharded["coreset"], reference["coreset"], size)


@pytest.mark.parametrize("size", [2, 3])
def test_coreset_sharded_ragged_byte_identical(worlds, unsharded, reference,
                                               size):
    """Ragged widths (11 features / 3 clients) through pad-and-mask and
    the mesh shard at once."""
    _check_coreset(_ranks(worlds(size), "data", "coreset-ragged"),
                   unsharded["coreset-ragged"], reference["coreset-ragged"],
                   size)


# ----------------------------------------------------------------- train

@pytest.mark.parametrize("size", [2, 3, 8])
@pytest.mark.parametrize("batch_size", [64, 60])   # divisible + padded
def test_train_sharded_matches_single_device(worlds, unsharded, reference,
                                             size, batch_size):
    """The step's batch columns shard over ``data``: the all-reduced
    loss and gradient sums match one device within reassociation."""
    key = f"train-lr-{batch_size}"
    got = _ranks(worlds(size), "data", key)
    _check_train(got, reference[key], size)
    _check_train(got, unsharded[key], size)
    assert unsharded[key]["shards"] == 1


@pytest.mark.parametrize("size", [2, 3])
def test_train_sharded_mlp(worlds, unsharded, reference, size):
    got = _ranks(worlds(size), "data", "train-mlp")
    _check_train(got, reference["train-mlp"], size)
    _check_train(got, unsharded["train-mlp"], size)


@pytest.mark.parametrize("batch_size", [64, 60])
def test_train_2d_mesh_matches_single_device(worlds, unsharded, reference,
                                             batch_size):
    """The M = 3 bottom blocks shard over a 4-way ``model`` dim (one
    dummy client pads), the activation send is one all-gather a step,
    and the result matches one device and the 8-way ``data`` mesh."""
    key = f"train-lr-{batch_size}"
    w8 = worlds(8)
    got = _ranks(w8, "2x4", key)
    _check_train(got, reference[key], 2, 4)
    _check_train(got, unsharded[key], 2, 4)
    _close_losses(got["losses"], _ranks(w8, "data", key)["losses"])


def test_train_2d_mesh_mlp(worlds, unsharded, reference):
    """mlp on the 2-D mesh: the all-gather feeds the concat top model."""
    got = _ranks(worlds(8), "2x4", "train-mlp")
    assert got["fused_gather"]
    _check_train(got, reference["train-mlp"], 2, 4)
    _check_train(got, unsharded["train-mlp"], 2, 4)


@pytest.mark.parametrize("n", [256, 230])           # divisible + remainder
def test_train_2d_gather_fused_bitwise(worlds, n):
    """On the same 2-D mesh, fusing the schedule gather into the bottom
    pass changes no bit of the losses or the trained params."""
    w8 = worlds(8)
    fused = _ranks(w8, "2x4", f"fused-{n}-True")
    plain = _ranks(w8, "2x4", f"fused-{n}-False")
    assert fused["fused_gather"] and not plain["fused_gather"]
    assert _same(fused["losses"], plain["losses"])
    assert _same(fused["params"], plain["params"])


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_train_2d_quantized(worlds, unsharded, reference, quant):
    """The quantized wire on the 2-D mesh: one all-gather of each rank's
    int8 payload (values and exponents) a step."""
    key = f"train-mlp-{quant}"
    got = _ranks(worlds(8), "2x4", key)
    _check_train(got, reference[key], 2, 4)
    _check_train(got, unsharded[key], 2, 4)


def test_train_2d_requires_slab_path(worlds):
    """bottom_impl='loop' keeps ragged per-client params: it cannot take
    the model dim and raises; so does the loop engine on any mesh."""
    got = _ranks(worlds(8), "2x4", "refusals")
    assert "model-axis" in got["loop_on_model_axis"]
    assert "does not shard" in got["loop_engine_on_mesh"]


def test_pipeline_2d_mesh_end_to_end(worlds, unsharded, reference):
    """One 2-D mesh through run_pipeline: alignment and coreset shard
    over ``data`` (byte-identical), training over both dims."""
    got = _ranks(worlds(8), "2x4", "pipeline-lr")
    want = reference["pipeline-lr"]
    assert np.array_equal(got["indices"], want["indices"])
    assert np.array_equal(got["weights"], want["weights"])
    assert got["coreset_shards"] == 2
    assert (got["shards"], got["model_shards"]) == (2, 4)
    assert got["epochs"] == want["epochs"]
    assert got["host_syncs"] == got["epochs"]
    _close_losses(got["losses"], want["losses"])
    _close_losses(got["losses"], unsharded["pipeline-lr"]["losses"])
    assert abs(got["metric"] - want["metric"]) <= 0.03


@pytest.mark.parametrize("size", [2, 3, 8])
def test_resolve_train_mesh_shapes(worlds, size):
    """1-D meshes keep data-only semantics; the 2-D mesh exposes the
    model dim; size-1 meshes collapse."""
    w = worlds(size)
    mesh = "2x4" if size == 8 else "data"
    got = _ranks(w, mesh, "resolve")
    if size == 8:
        assert got["train"] == ("data", 2, "model", 4)
        assert got["batch"] == ("data", 2)
        assert _ranks(w, "data", "resolve")["train"] == ("data", 8, None, 1)
    else:
        assert got["train"] == ("data", size, None, 1)
        assert got["batch"] == ("data", size)
    if size == 2:
        for mesh in ("one", "host"):
            one = _ranks(w, mesh, "resolve")
            assert one["train_none"] and one["train"] == (None, 1, None, 1)
            assert one["batch_none"] and one["batch"] == (None, 1)


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("size", [2])
def test_pipeline_mesh_trains_sharded(worlds, unsharded, reference, size):
    """One mesh covers all three stages: with a trainable model the
    train stage runs the sharded engine."""
    got = _ranks(worlds(size), "data", "pipeline-lr")
    want = reference["pipeline-lr"]
    assert np.array_equal(got["indices"], want["indices"])
    assert np.array_equal(got["weights"], want["weights"])
    assert got["shards"] == size and got["coreset_shards"] == size
    assert got["epochs"] == want["epochs"]
    _close_losses(got["losses"], want["losses"])
    _close_losses(got["losses"], unsharded["pipeline-lr"]["losses"])
    assert abs(got["metric"] - want["metric"]) <= 0.03


@pytest.mark.parametrize("size", [2, 3])
def test_pipeline_mesh_knob_end_to_end(worlds, unsharded, reference, size):
    """run_pipeline(mesh=) shards the device-backend alignment and the
    coreset: aligned set, selection and modeled costs byte for byte."""
    got = _ranks(worlds(size), "data", "pipeline-knn")
    want = reference["pipeline-knn"]
    assert np.array_equal(got["intersection"], want["intersection"])
    assert got["total_bytes"] == want["total_bytes"]
    assert got["n_train"] == want["n_train"]
    assert np.array_equal(got["indices"], want["indices"])
    assert np.array_equal(got["weights"], want["weights"])
    assert got["coreset_shards"] == size
    assert got["metric"] == want["metric"]
    assert _same(got, unsharded["pipeline-knn"] | {"coreset_shards": size})


@pytest.mark.parametrize("size,mesh", [(2, "one"), (8, "2x4")])
def test_unknown_shard_axis_raises(worlds, size, mesh):
    """A misspelt shard_axis raises instead of running unsharded."""
    got = _ranks(worlds(size), mesh, "refusals")
    for case in ("batch_axis_typo", "train_axis_typo", "coreset_axis"):
        assert got[case] is not None and "shard_axis" in got[case], case


def test_single_device_mesh_is_a_noop(worlds, unsharded):
    """A size-1 mesh takes the plain path (shards == 1), bit for bit."""
    w = worlds(2)
    rnd = _ranks(w, "one", "oprf-host-5")
    assert rnd["shards"] == 1
    assert _same(rnd["inters"], unsharded["oprf-host-5"]["inters"])
    res = _ranks(w, "one", "coreset")
    assert res["shards"] == 1
    assert _same(res, unsharded["coreset"])
    train = _ranks(w, "one", "train-lr-60")
    assert (train["shards"], train["model_shards"]) == (1, 1)
    assert _same(train, unsharded["train-lr-60"])


# --------------------------------------------------------------- launcher

def test_launcher_fails_when_a_rank_raises(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(ranks.raise_on_rank_1, 2, device="cpu", timeout=60,
                  workdir=str(tmp_path))


def test_launcher_stops_a_hung_world(tmp_path):
    """A world that outlives its timeout raises, and no rank is left."""
    with pytest.raises(TimeoutError):
        run_ranks(ranks.hang, 2, device="cpu", timeout=5,
                  workdir=str(tmp_path))
    assert not list(tmp_path.iterdir())     # the world's directory went
