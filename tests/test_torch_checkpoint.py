"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the same flat keys letter for letter,
and a file written by either side loads into the other, bit for bit
(bf16 leaves through their u16 view, lists, tuples, ``AdamState`` with
its step), with ``__meta__``'s ``step`` and ``extra``.  A key the file
lacks raises ``KeyError`` on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.train.optimizer import AdamState as RefAdamState
from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.train.optimizer import AdamState, adam_init, tree_leaves
from repro_torch.train.steps import init_train_state


def _numpy_tree(seed: int = 0):
    """A tree with every kind of node and a bf16 leaf, as numpy (f32,
    bf16 as f32 values that bf16 holds exactly, int32)."""
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {"w": rng.normal(size=(4, 2)).astype(np.float32), "bf": bf,
            "layers": [{"a": rng.normal(size=(2,)).astype(np.float32)},
                       (rng.integers(0, 9, (3,)).astype(np.int32),)]}


def _ref_tree(t):
    return {"w": jnp.asarray(t["w"]), "bf": jnp.asarray(t["bf"], jnp.bfloat16),
            "layers": [{"a": jnp.asarray(t["layers"][0]["a"])},
                       (jnp.asarray(t["layers"][1][0]),)]}


def _port_tree(t):
    return {"w": torch.from_numpy(t["w"]),
            "bf": torch.from_numpy(np.array(t["bf"])).to(torch.bfloat16),
            "layers": [{"a": torch.from_numpy(t["layers"][0]["a"])},
                       (torch.from_numpy(t["layers"][1][0]),)]}


def _state(tree_fn, adam_cls, step, t):
    return (tree_fn(t), adam_cls(step=step, mu=tree_fn(_numpy_tree(1)),
                                 nu=tree_fn(_numpy_tree(2))))


def _bits(x) -> np.ndarray:
    """A leaf's bits as numpy (bf16 through its u16 view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_keys_match_reference_letter_for_letter(tmp_path):
    t = _numpy_tree()
    ref_ckpt.save_checkpoint(str(tmp_path / "ref.npz"),
                             _state(_ref_tree, RefAdamState,
                                    jnp.asarray(7, jnp.int32), t), step=7)
    checkpoint.save_checkpoint(str(tmp_path / "port.npz"),
                               _state(_port_tree, AdamState, 7, t), step=7)
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as p:
        assert list(r.keys()) == list(p.keys())
        assert "1/.step" in r and "1/.mu/layers/1/0" in r
        for k in r.keys():
            assert r[k].dtype == p[k].dtype and r[k].shape == p[k].shape, k
            assert np.array_equal(r[k], p[k]), k


def test_reference_file_loads_into_port(tmp_path):
    t = _numpy_tree()
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save_checkpoint(path, _state(_ref_tree, RefAdamState,
                                          jnp.asarray(3, jnp.int32), t),
                             step=3, extra={"arch": "x"})
    like = (_port_tree(_numpy_tree(5)), adam_init(_port_tree(_numpy_tree(5))))
    (params, opt), meta = checkpoint.load_checkpoint(path, like)
    assert meta["step"] == 3 and meta["extra"] == {"arch": "x"}
    assert isinstance(opt, AdamState) and opt.step == 3
    assert isinstance(opt.step, int)
    assert params["bf"].dtype == torch.bfloat16
    assert isinstance(params["layers"], list)
    assert isinstance(params["layers"][1], tuple)
    want = _state(_port_tree, AdamState, 3, t)
    for got_leaf, want_leaf in zip(tree_leaves([params, opt.mu, opt.nu]),
                                   tree_leaves([want[0], want[1].mu,
                                                want[1].nu])):
        assert got_leaf.dtype == want_leaf.dtype
        assert np.array_equal(_bits(got_leaf), _bits(want_leaf))


def test_port_file_loads_into_reference(tmp_path):
    t = _numpy_tree()
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, _state(_port_tree, AdamState, 4, t),
                               step=4)
    like = _state(_ref_tree, RefAdamState, jnp.asarray(0, jnp.int32),
                  _numpy_tree(5))
    (params, opt), meta = ref_ckpt.load_checkpoint(path, like)
    assert meta["step"] == 4
    assert np.asarray(opt.step).dtype == np.int32 and int(opt.step) == 4
    assert np.asarray(params["bf"]).dtype.name == "bfloat16"
    want = _state(_ref_tree, RefAdamState, jnp.asarray(4, jnp.int32), t)
    for g, w in zip(jax.tree_util.tree_leaves((params, opt)),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3",
                                  "hymba-1.5b"])
def test_lm_train_state_round_trips_both_ways(tmp_path, arch):
    """A reduced config's params and Adam state, the params in bf16:
    port -> file -> port bitwise, and the reference's own params and
    state -> file -> port -> file -> reference bitwise."""
    cfg = get_config(arch).reduced()
    params, opt = init_train_state(0, cfg, device="cpu")
    params = dict(params, embed=params["embed"].to(torch.bfloat16))
    opt = AdamState(step=5, mu=opt.mu, nu=opt.nu)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, (params, opt), step=5)
    (p2, o2), _ = checkpoint.load_checkpoint(path, (params, opt))
    assert o2.step == 5
    for a, b in zip(tree_leaves((params, o2.mu)), tree_leaves((p2, o2.mu))):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))

    rcfg = ref_get_config(f"{arch}-reduced")
    rp = jax.jit(ref_api.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), rcfg)
    rstate = (rp, RefAdamState(step=jnp.asarray(9, jnp.int32),
                               mu=jax.tree_util.tree_map(jnp.zeros_like, rp),
                               nu=jax.tree_util.tree_map(jnp.ones_like, rp)))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref.npz"), rstate, step=9)
    (pp, po), _ = checkpoint.load_checkpoint(str(tmp_path / "ref.npz"),
                                             (p2, o2))
    assert po.step == 9
    checkpoint.save_checkpoint(str(tmp_path / "back.npz"), (pp, po), step=9)
    back, _ = ref_ckpt.load_checkpoint(str(tmp_path / "back.npz"), rstate)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(rstate)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("side", ["port", "reference"])
def test_missing_key_raises(tmp_path, side):
    path = str(tmp_path / "small.npz")
    checkpoint.save_checkpoint(path, {"a": torch.zeros(2)})
    if side == "port":
        with pytest.raises(KeyError, match="'b'"):
            checkpoint.load_checkpoint(path, {"a": torch.zeros(2),
                                              "b": torch.zeros(1)})
    else:
        with pytest.raises(KeyError, match="'b'"):
            ref_ckpt.load_checkpoint(path, {"a": jnp.zeros(2),
                                            "b": jnp.zeros(1)})


def test_loads_onto_the_device_of_like(tmp_path):
    """Each tensor comes back on its ``like`` leaf's device (the card in
    ``chip_smoke.py``; here the CPU) in the dtype it was saved in, and a
    leaf of another shape is refused."""
    path = str(tmp_path / "x.npz")
    checkpoint.save_checkpoint(path, [torch.arange(6.0).reshape(2, 3)])
    got, _ = checkpoint.load_checkpoint(path, [torch.empty(2, 3,
                                                           device="meta")])
    assert got[0].device.type == "meta"
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_checkpoint(path, [torch.zeros(3, 2)])
