"""The production shapes of the port (``launch/specs``, ``launch/dryrun``,
``launch/mesh.make_production_mesh``, ``analysis/roofline``) against the
JAX package's.

The reference lays its abstract inputs out on a production mesh of 256
or 512 devices.  Here its ``build_*`` run on a ``jax.sharding.AbstractMesh``
(no devices; ``_RefMesh`` gives it the ``devices`` shape that its cache
rule reads) and the port's on ``sharding.MeshShape``, and every
placement is compared leaf for leaf, exactly.  The reference's
layer-scanned caches (its ``uniform_decode`` archs) carry a leading
layer axis, never sharded; the port's per-layer caches are compared
with that entry dropped.  Shapes, dtypes, ``supports`` and its reasons,
``model_flops_for`` and ``roofline_terms`` (given the same ``Hardware``
numbers) are compared exactly too.  ``dryrun.run_one``'s per-rank bytes
must equal the sum of each leaf's block under the reference's specs
(the reference's Adam step is an int32 scalar on the device, the port's
a host int: it is left out of that sum).
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.analysis import roofline as ref_roofline
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.sharding import _path_str
from repro_torch import sharding
from repro_torch.analysis import roofline
from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, transformer

ARCHS = sorted(REF_ARCH_IDS)
# the (arch, shape) combinations both packages run (``supports``)
RUNS = [(a, s) for a in ARCHS for s in INPUT_SHAPES
        if specs.supports(get_config(a), INPUT_SHAPES[s])[0]]
DECODES = [(a, s) for a, s in RUNS if INPUT_SHAPES[s].kind == "decode"]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _RefMesh(AbstractMesh):
    """An ``AbstractMesh`` with the ``devices`` shape that the reference's
    ``_cache_spec_tree`` reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _meshes(name):
    shape, names = MESHES[name]
    return _RefMesh(shape, names), sharding.MeshShape(names, shape)


def _ref_flat(tree):
    """{path: spec tuple} of a tree of ``NamedSharding``s."""
    return {_path_str(p): tuple(v.spec)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, prefix=""):
    """{path: spec tuple} of the port's placement tree (dicts, lists and
    an ``AdamState`` of spec tuples)."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return {prefix: tree}
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _cache_specs_as_port(ref_caches, cfg, n_layers):
    """The reference's cache placements in the port's per-layer paths:
    scanned ones without their layer entry."""
    flat = _ref_flat(ref_caches)
    if not (cfg.family != "audio" and transformer_uniform(cfg)):
        return flat
    kind = "ssm" if cfg.family == "ssm" else "attn"
    return {f"{i}/{kind}/{k}": spec[1:] for i in range(n_layers)
            for k, spec in flat.items()}


def transformer_uniform(cfg):
    from repro.models import transformer as ref_tr
    return ref_tr.uniform_decode(cfg)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_supports_and_batch_specs_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert specs.supports(cfg, INPUT_SHAPES[shape]) == \
        ref_specs.supports(rcfg, REF_SHAPES[shape])
    for labels in (False, True):
        got = specs.batch_specs(cfg, INPUT_SHAPES[shape], with_labels=labels)
        want = ref_specs.batch_specs(rcfg, REF_SHAPES[shape],
                                     with_labels=labels)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype)


def test_long_context_archs():
    assert specs.LONG_CONTEXT_OK == ref_specs.LONG_CONTEXT_OK
    ok = [a for a in ARCHS
          if specs.supports(get_config(a), INPUT_SHAPES["long_500k"])[0]]
    assert ok == ["gemma2-9b", "hymba-1.5b", "mamba2-1.3b"]


@functools.lru_cache(maxsize=None)
def _ref_abstract_params(arch):
    return ref_specs.abstract_params(ref_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    """Shapes and dtypes of every param (``jax.eval_shape`` of the
    reference's ``init_params``); the port's Adam moments as its
    ``adam_init`` makes them."""
    want = {_path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(_ref_abstract_params(arch))[0]}
    aparams = specs.abstract_params(get_config(arch))
    got = dict(sharding.flat_tree(aparams))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    opt = specs.abstract_opt(aparams)
    assert opt.step == 0
    assert dict(sharding.flat_tree(opt.mu)) == got == \
        dict(sharding.flat_tree(opt.nu))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", RUNS)
def test_placements_match_reference(arch, shape, mesh):
    """Every in placement of the step ``build_dryrun`` builds, leaf for
    leaf: params, Adam moments and batch (train), params and batch
    (prefill), params, caches, the index and the tokens (decode);
    decode's out placement of the caches too."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    ref_mesh, port_mesh = _meshes(mesh)
    _, rargs, rin, rout = ref_specs.build_dryrun(rcfg, REF_SHAPES[shape],
                                                 ref_mesh)
    _, args, pin, pout = specs.build_dryrun(cfg, INPUT_SHAPES[shape],
                                            port_mesh)
    kind = INPUT_SHAPES[shape].kind
    assert _flat(pin[0]) == _ref_flat(rin[0])                    # params
    if kind == "train":
        assert pin[1].step == () == tuple(rin[1].step.spec)
        assert _flat(pin[1].mu) == _ref_flat(rin[1].mu)
        assert _flat(pin[1].nu) == _ref_flat(rin[1].nu)
        assert _flat(pin[2]) == _ref_flat(rin[2])                 # batch
        assert pout[:2] == pin[:2] and pout[2] is None
    elif kind == "prefill":
        assert _flat(pin[1]) == _ref_flat(rin[1])
        assert pout is None and rout is None
    else:
        want = _cache_specs_as_port(rin[1], rcfg, cfg.n_layers)
        assert _flat(pin[1]) == want
        assert _flat(pout[1]) == want and pout[0] is None
        assert pin[2] == () == tuple(rin[2].spec)                 # index
        assert pin[3] == tuple(rin[3].spec)                       # tokens
        assert args[2] == INPUT_SHAPES[shape].seq_len - 1
        assert args[3].shape == rargs[3].shape


@pytest.mark.parametrize("arch,shape", DECODES)
def test_decode_caches_match_reference(arch, shape):
    """The decode caches' shapes and dtypes: the reference's per-layer
    ``init_decode_state`` (what its non-scanned ``build_decode`` lays
    out) with ``force_window`` as ``build_decode`` sets it, or whisper's
    caches from its own ``build_decode``."""
    from repro.models import transformer as ref_tr

    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sh = INPUT_SHAPES[shape]
    ref_mesh, port_mesh = _meshes("pod16x16")
    if cfg.family == "audio":
        want = ref_specs.build_dryrun(rcfg, REF_SHAPES[shape], ref_mesh)[1][1]
    else:
        want = jax.eval_shape(lambda: ref_tr.init_decode_state(
            rcfg, sh.global_batch, sh.seq_len, force_window=(
                shape == "long_500k" and cfg.family != "ssm")))
    want = {_path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    _, args, _, _ = specs.build_dryrun(cfg, sh, port_mesh)
    got = dict(sharding.flat_tree(args[1]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k


def test_production_mesh_shapes_and_names():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert (one.mesh_dim_names, tuple(one.shape)) == (("data", "model"),
                                                      (16, 16))
    assert (two.mesh_dim_names, tuple(two.shape)) == (
        ("pod", "data", "model"), (2, 16, 16))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops_for(get_config(arch), INPUT_SHAPES[shape]) \
        == ref_roofline.model_flops_for(ref_get_config(arch),
                                        REF_SHAPES[shape])


@pytest.mark.parametrize("terms", [
    dict(flops_per_device=3.2e14, bytes_per_device=1.1e10,
         collective_bytes_per_device=4.0e9, model_flops_global=5.5e16,
         chips=256),
    dict(flops_per_device=1e9, bytes_per_device=7.3e10,
         collective_bytes_per_device=0.0, model_flops_global=2e11,
         chips=512),
    dict(flops_per_device=0.0, bytes_per_device=1.0,
         collective_bytes_per_device=9e12, model_flops_global=1.0,
         chips=1)])
def test_roofline_terms_match_reference(terms):
    """The same numbers in both ``Hardware``s (the port's defaults):
    every term equal; the port's defaults are the H100 SXM's."""
    hw = roofline.HW
    ref_hw = ref_roofline.Hardware(peak_flops=hw.peak_flops,
                                   hbm_bw=hw.hbm_bw, ici_link_bw=hw.link_bw,
                                   ici_links=hw.links)
    assert roofline.roofline_terms(**terms) == \
        ref_roofline.roofline_terms(**terms, hw=ref_hw)
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.links) == (
        989e12, 3.35e12, 25e9, 18)


def test_roofline_without_collectives():
    """An uncounted collective term (``None``) stays out of the bound."""
    got = roofline.roofline_terms(
        flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
        collective_bytes_per_device=None, model_flops_global=1.0, chips=1)
    assert got["collective_s"] is None
    assert got["dominant"] == "memory_s" and got["bound_s"] == 2.0


def _ref_rank_bytes(tree, shardings, sizes):
    total = 0
    for (_, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(shardings)[0]):
        n = np.dtype(leaf.dtype).itemsize
        for i, d in enumerate(leaf.shape):
            entry = sh.spec[i] if i < len(sh.spec) else None
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                d //= sizes[a]
            n *= d
        total += n
    return total


def test_dryrun_records(tmp_path):
    """Two supported combos and a skipped one: status, the reference's
    reason, the per-rank bytes against the reference's specs, the FLOP
    count and the roofline fields; the record is the file written."""
    rec = dryrun.run_one("tinyllama-1.1b", "long_500k", multi_pod=False,
                         out_dir=str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_specs.supports(
        ref_get_config("tinyllama-1.1b"), REF_SHAPES["long_500k"])[1]
    for arch, shape, mesh in (("tinyllama-1.1b", "train_4k", "pod16x16"),
                              ("gemma2-9b", "long_500k", "pod2x16x16")):
        rec = dryrun.run_one(arch, shape, multi_pod=mesh == "pod2x16x16",
                             out_dir=str(tmp_path))
        with open(os.path.join(tmp_path, f"{arch}__{shape}__{mesh}.json")) \
                as f:
            assert json.load(f) == json.loads(json.dumps(rec, default=str))
        assert rec["status"] == "ok", rec.get("error")
        ref_mesh, _ = _meshes(mesh)
        sizes = dict(zip(ref_mesh.axis_names, ref_mesh.axis_sizes))
        _, rargs, rin, _ = ref_specs.build_dryrun(
            ref_get_config(arch), REF_SHAPES[shape], ref_mesh)
        held = rec["resident_bytes_per_device"]
        assert held["params"] == _ref_rank_bytes(rargs[0], rin[0], sizes)
        if shape == "train_4k":
            assert held["adam"] == _ref_rank_bytes(
                (rargs[1].mu, rargs[1].nu), (rin[1].mu, rin[1].nu), sizes)
            assert held["batch"] == _ref_rank_bytes(rargs[2], rin[2], sizes)
        else:
            assert held["caches"] == _ref_rank_bytes(rargs[1], rin[1], sizes)
            assert held["batch"] == _ref_rank_bytes(rargs[3], rin[3], sizes)
        assert held["total"] == sum(v for k, v in held.items()
                                    if k != "total")
        assert rec["chips"] == int(np.prod(ref_mesh.axis_sizes))
        assert rec["collective_bytes_per_device"] is None
        assert rec["roofline"]["collective_s"] is None
        assert rec["cost"]["flops_per_device"] * rec["chips"] == \
            pytest.approx(rec["cost"]["flops_global"])
        assert rec["cost"]["flops_global"] > 0
        assert rec["fits_hbm"] is True


def test_dryrun_decode_caches_are_o_window():
    """gemma2-9b at long_500k: its 42 ring caches of 4,096 slots, bf16,
    on one rank of a one-device 'mesh' hold 1.41 GB — not the ~90 GB a
    full-context cache of its 21 global layers would."""
    cfg = get_config("gemma2-9b")
    mesh = sharding.MeshShape(("data", "model"), (1, 1))
    _, args, pin, _ = specs.build_decode(cfg, INPUT_SHAPES["long_500k"], mesh)
    got = dryrun.rank_bytes(args[1], pin[1], {"data": 1, "model": 1})
    assert got == 42 * (2 * 4096 * 8 * 256 * 2 + 4096 * 4)


def test_chunked_and_full_count_the_same_flops():
    """The dry run counts train and prefill steps in the ``"full"`` form:
    ``"chunked"`` (the reference's default past 8,192 tokens) computes
    the same score blocks, so the same FLOPs, at a shape where it runs
    several blocks of queries and keys."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config("gemma2-9b-reduced")
    shape = ShapeConfig("probe", 2048, 2, "prefill")
    counts = []
    for form in ("full", "chunked"):
        fn, aargs, _, _ = specs.build_prefill(
            cfg, shape, sharding.MeshShape(("data", "model"), (1, 1)),
            attn_impl=form)
        mode = specs._fake_mode()
        args = specs.fake_args(aargs, mode)
        counter = FlopCounterMode(display=False)
        with mode, counter, torch.no_grad():
            fn(*args)
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] > 0


def test_use_form_sets_and_restores_the_attention_form():
    q = torch.zeros(1, 8, 2, 4)
    calls = []
    orig = attention.full_attention, attention.chunked_attention

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    pos = torch.arange(8, dtype=torch.int32)
    try:
        attention.full_attention = spy("full", orig[0])
        attention.chunked_attention = spy("chunked", orig[1])
        attention.attend(q, q, q, q_pos=pos, k_pos=pos)
        with attention.use_form("chunked"):
            attention.attend(q, q, q, q_pos=pos, k_pos=pos)
            with attention.use_form("full"):
                attention.attend(q, q, q, q_pos=pos, k_pos=pos)
            attention.attend(q, q, q, q_pos=pos, k_pos=pos)
        attention.attend(q, q, q, q_pos=pos, k_pos=pos)
    finally:
        attention.full_attention, attention.chunked_attention = orig
    assert calls == ["full", "chunked", "full", "chunked", "full"]
    with pytest.raises(ValueError):
        with attention.use_form("sparse"):
            pass


def test_build_train_defaults(monkeypatch):
    """remat on, and no attention form fixed by default: inside the step
    ``attention.attend`` keeps its own rule (K11 on the card; off it
    ``"chunked"`` at seq_len >= 8,192, else ``"full"``: the reference's
    environment defaults); a form that is given holds inside the step
    and is gone after it."""
    cfg = get_config("tinyllama-1.1b-reduced")
    mesh = sharding.MeshShape(("data", "model"), (1, 1))
    forms, made = [], []

    def step_of(cfg, **kw):
        made.append(kw)
        return lambda *args: forms.append(attention._FORM)

    monkeypatch.setattr(specs, "make_train_step", step_of)
    for s, form in ((4096, None), (8192, None), (8192, "auto"),
                    (8192, "full")):
        fn, aargs, _, _ = specs.build_train(
            cfg, ShapeConfig("t", s, 1, "train"), mesh, attn_impl=form)
        fn(*aargs)
    assert forms == [None, None, None, "full"]
    assert attention._FORM is None
    assert made == [{"lr": 1e-4, "remat": True}] * 4


def test_build_prefill_fixes_no_form_by_default(monkeypatch):
    """The prefill step, as the train step: attend's own rule unless a
    form is given (the dry run's ``"full"``)."""
    cfg = get_config("gemma2-9b-reduced")
    mesh = sharding.MeshShape(("data", "model"), (1, 1))
    forms = []
    monkeypatch.setattr(transformer, "prefill",
                        lambda *a, **kw: forms.append(attention._FORM))
    for form in (None, "full"):
        fn, aargs, _, _ = specs.build_prefill(
            cfg, ShapeConfig("p", 8192, 1, "prefill"), mesh, attn_impl=form)
        fn(None, {"tokens": None})
    fn, _, _, _ = specs.build_dryrun(cfg, INPUT_SHAPES["prefill_32k"], mesh,
                                     attn_impl=dryrun.ATTENTION)
    fn(None, {"tokens": None})
    assert forms == [None, "full", "full"]
