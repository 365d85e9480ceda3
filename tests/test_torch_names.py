"""Names of ported modules that the reference has and the port lacked:
``sgd_init``/``sgd_update`` and ``adam_update(weight_decay=)``
(``repro/train/optimizer.py``), ``weighted_softmax_xent(label_mask=)``
(``repro/train/losses.py``) and ``kmeans(batch=)``/
``kmeans_minibatch_fit(batch=)`` (``repro/core/kmeans.py``), each held
against the reference on the same inputs.

Tolerances: SGD's ``p - lr·g`` is one rounding of each of two f32
operations on both sides, bitwise; Adam and the softmax cross-entropy
agree to rtol 1e-6 (a few ulps: XLA and torch evaluate sqrt/exp/log in
their own ways), as ``test_torch_train.py`` holds them; the minibatch
fit to the k-means tolerances of ``test_torch_minibatch.py`` (XLA may
contract the Sculley update into FMAs, ROADMAP N5)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import losses as jax_losses
from repro.train import optimizer as jax_opt
from repro_torch import rng
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.train import losses, optimizer
from test_torch_kmeans import assert_same_assign, assert_sqd_close

jax_kmeans = importlib.import_module("repro.core.kmeans")
kmeans = importlib.import_module("repro_torch.core.kmeans")


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _tree(g):
    return {"bw": g.normal(size=(3, 5, 4)).astype(np.float32),
            "top": {"b": g.normal(size=(4,)).astype(np.float32)}}


def test_sgd_matches_reference_bitwise():
    g = np.random.default_rng(3)
    p0 = _tree(g)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jax_opt.sgd_init(jp)
    tp = params_from_jax(p0, "cpu")
    ts = optimizer.sgd_init(tp)
    for _ in range(3):
        gr = _tree(g)
        jp, js = jax_opt.sgd_update(jp, jax.tree_util.tree_map(
            jnp.asarray, gr), js, lr=0.07, b1=0.5)
        tp, ts = optimizer.sgd_update(tp, params_from_jax(gr, "cpu"), ts,
                                      lr=0.07, b1=0.5)
    assert ts == int(js) == 3
    assert np.array_equal(_flat(params_to_numpy(tp)), _flat(jp))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_weight_decay_matches_reference(weight_decay):
    g = np.random.default_rng(4)
    p0 = _tree(g)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jax_opt.adam_init(jp)
    tp = params_from_jax(p0, "cpu")
    ts = optimizer.adam_init(tp)
    for _ in range(4):
        gr = _tree(g)
        jp, js = jax_opt.adam_update(jp, jax.tree_util.tree_map(
            jnp.asarray, gr), js, lr=0.05, weight_decay=weight_decay)
        tp, ts = optimizer.adam_update(tp, params_from_jax(gr, "cpu"), ts,
                                       lr=0.05, weight_decay=weight_decay)
    for a, b in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        np.testing.assert_allclose(_flat(params_to_numpy(b)), _flat(a),
                                   rtol=1e-6, atol=1e-9)


def test_adam_weight_decay_moves_the_params():
    """Decay changes the step by exactly ``lr·wd·p`` on zero moments'
    first step with a zero gradient."""
    p = {"w": torch.tensor([2.0, -4.0])}
    g = {"w": torch.zeros(2)}
    optimizer.adam_update(p, g, optimizer.adam_init(p), lr=0.1,
                          weight_decay=0.5)
    assert torch.allclose(p["w"], torch.tensor([2.0 - 0.1, -4.0 + 0.2]))


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_xent_label_mask_matches_reference(weighted):
    g = np.random.default_rng(5)
    logits = g.normal(size=(6, 9, 7)).astype(np.float32)
    labels = g.integers(0, 7, (6, 9))
    mask = (g.uniform(size=(6, 9)) > 0.3).astype(np.float32)
    w = g.uniform(0, 2, 6).astype(np.float32) if weighted else None
    want = jax_losses.weighted_softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), label_mask=jnp.asarray(mask))
    got = losses.weighted_softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w),
        label_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    unmasked = losses.weighted_softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w))
    assert float(got) != float(unmasked)


def _blobs(n, d, k, seed):
    g = np.random.default_rng(seed)
    centers = g.normal(size=(k, d)) * 4
    return (centers[g.integers(0, k, n)]
            + g.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("batch", [256, 700])
def test_minibatch_fit_batch_matches_reference(batch):
    x = _blobs(2000, 5, 6, seed=batch)
    wc, wa, ws = (np.asarray(v) for v in jax_kmeans.kmeans_minibatch_fit(
        jax.random.PRNGKey(1), jnp.asarray(x), 6, iters=9, batch=batch,
        impl="ref"))
    gc, ga, gs = kmeans.kmeans_minibatch_fit(
        rng.PRNGKey(1), torch.from_numpy(x), 6, iters=9, batch=batch)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=1e-5, atol=1e-5)
    assert_same_assign(ga.numpy(), wa, x, wc)
    assert_sqd_close(gs.numpy(), ws, x, wc, wa)


@pytest.mark.parametrize("n", [600, 300])     # above and below the batch
def test_kmeans_batch_matches_reference(n):
    """``kmeans(batch=)`` takes the minibatch fit only past ``batch``
    rows, as the reference."""
    x = _blobs(n, 4, 5, seed=n)
    wc, wa, _ = jax_kmeans.kmeans(x, 5, seed=2, iters=8, impl="ref",
                                  algo="minibatch", batch=400)
    gc, ga, _ = kmeans.kmeans(x, 5, seed=2, iters=8, algo="minibatch",
                              batch=400, device="cpu")
    np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-5)
    assert_same_assign(ga, wa, x, wc)
