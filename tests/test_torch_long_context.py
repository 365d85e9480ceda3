"""The long_500k serving path (``force_window``) of the port against the
JAX package on the same params and prompts.

``force_window`` puts every attention layer on a ring cache of its
window: gemma2's global layers and hymba's ``hybrid_global_layers`` take
``sliding_window`` (``transformer.layer_windows``), so a request decodes
at a context of 524,288 with O(window) keys a layer.  Both sides start
from the reference's ``init_lm`` params (``interop.lm_params_from_jax``)
on the reduced configs (window 16, hymba's 4 meta tokens, f32) and the
same seeded numpy prompts of 40 tokens, longer than every window.  The
reference runs with ``force_window=True`` and its ``"flash"`` prefill
(the Pallas kernel in interpret mode).

Tolerances (ROADMAP §3 N7): logits and caches within rtol 1e-4 / atol
1e-4, over the prefill, 8 decode steps from it and 8 steps at positions
524,280 … 524,287 (the last a long_500k request reaches).  Rotary angles
there lie near 5.2e5 rad: both packages form ``pos · inv_freq`` in f32,
which is the same product wherever the two ``inv_freq`` agree, and both
CPUs' cos/sin of it lie within 4e-8 of float64's
(``test_rope_far_positions``, ROADMAP §3 N11).  Greedy tokens are equal
wherever the reference's top-2 margin is above twice the logit
tolerance.  ``force_window=False`` is bitwise the call without it, and
``force_window=True`` bitwise that where it changes no window.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tr
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import api, attention, layers, transformer
from repro_torch.serve import greedy_decode, make_prefill_step, \
    make_serve_step

RTOL = ATOL = 1e-4
LONG = ("gemma2-9b-reduced", "hymba-1.5b-reduced", "mamba2-1.3b-reduced")
S = 40                          # the prompt: longer than every window (16)
CONTEXT = 524_288               # long_500k's seq_len
FAR = CONTEXT - 8               # 8 steps at 524,280 ... 524,287
N_STEPS = 8
DECODER_ARCHS = sorted(a for a in REF_ARCH_IDS if a != "whisper-large-v3")


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    cfg = ref_get_config(arch)
    rp = jax.tree_util.tree_map(np.asarray,
                                ref_tr.init_lm(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)
    return cfg, rp, lm_params_from_jax(rp, device="cpu"), toks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def _caches_close(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for kind in w:
            for name in w[kind]:
                assert tuple(g[kind][name].shape) == w[kind][name].shape
                if name == "pos":
                    np.testing.assert_array_equal(g[kind][name].numpy(),
                                                  np.asarray(w[kind][name]))
                else:
                    _close(g[kind][name], w[kind][name])


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch: str):
    cfg, rp, _, toks = _setup(arch)
    return ref_tr.prefill(rp, cfg, jnp.asarray(toks), context_len=CONTEXT,
                          force_window=True, attn_impl="flash")


def _port_prefill(arch: str, **kw):
    _, _, pp, toks = _setup(arch)
    return transformer.prefill(pp, get_config(arch), torch.from_numpy(toks),
                               context_len=CONTEXT, **kw)


@pytest.mark.parametrize("force_window", [False, True])
@pytest.mark.parametrize("arch", sorted(REF_ARCH_IDS))
def test_layer_windows_match_reference(arch, force_window):
    for name in (arch, arch + "-reduced"):
        assert transformer.layer_windows(
            get_config(name), force_window=force_window) == \
            ref_tr.layer_windows(ref_get_config(name),
                                 force_window=force_window)


def test_force_window_windows():
    """gemma2's odd layers and hymba's global layers take the window; a
    config with no window keeps 0."""
    g = get_config("gemma2-9b")
    assert transformer.layer_windows(g) == [4096, 0] * 21
    assert transformer.layer_windows(g, force_window=True) == [4096] * 42
    h = get_config("hymba-1.5b")
    assert transformer.layer_windows(h)[0] == 0
    assert transformer.layer_windows(h, force_window=True) == [1024] * 32
    t = get_config("tinyllama-1.1b")
    assert transformer.layer_windows(t, force_window=True) == [0] * 22


@pytest.mark.parametrize("force_window", [False, True])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_init_decode_state_shapes_match_reference(arch, force_window):
    """Every cache leaf's shape and dtype at long_500k's context (the
    reference's ``eval_shape``, the port's on fake tensors), for the
    full configs: under ``force_window`` gemma2's 42 caches hold 4,096
    slots each."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    want = jax.eval_shape(lambda: ref_tr.init_decode_state(
        ref_get_config(arch), 1, CONTEXT, force_window=force_window))
    with FakeTensorMode():
        got = transformer.init_decode_state(get_config(arch), 1, CONTEXT,
                                            force_window=force_window,
                                            device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for kind in w:
            assert g[kind].keys() == w[kind].keys()
            for name in w[kind]:
                assert tuple(g[kind][name].shape) == w[kind][name].shape
                assert str(g[kind][name].dtype).split(".")[-1] == \
                    str(w[kind][name].dtype)
    if arch == "gemma2-9b":
        caps = {e["attn"]["k"].shape[1] for e in got}
        assert caps == ({4096} if force_window else {4096, CONTEXT})


@pytest.mark.parametrize("arch", LONG)
def test_prefill_matches_reference(arch):
    """Prefill logits and every cache (k, v, the slot map ``pos``, the
    SSM state and conv window) under ``force_window``; every ring holds
    the pinned prefix and the window's last positions where
    ``attention.cache_slot`` puts them."""
    cfg = ref_get_config(arch)
    want, want_caches, want_next = _ref_prefill(arch)
    got, caches, nxt = _port_prefill(arch, force_window=True)
    assert nxt == int(want_next) == S + cfg.hybrid_meta_tokens
    _close(got, want)
    _caches_close(caches, want_caches)
    prefix = cfg.hybrid_meta_tokens
    for e in caches:
        if "attn" in e:
            pos, cap = e["attn"]["pos"], e["attn"]["pos"].shape[0]
            assert cap == prefix + cfg.sliding_window
            kept = list(range(prefix)) + list(range(nxt - cap + prefix, nxt))
            for p in kept:
                assert int(pos[attention.cache_slot(p, cap, 16, prefix)]) == p


def _decode_both(arch, start, want_caches, caches, tok):
    """N_STEPS decode steps from ``start`` on both sides, each fed the
    reference's last argmax; logits and caches compared at each."""
    cfg, rp, pp, _ = _setup(arch)
    pcfg = get_config(arch)
    for t in range(N_STEPS):
        want_logits, want_caches = ref_tr.decode_step(
            rp, cfg, want_caches, jnp.asarray(start + t, jnp.int32), tok,
            force_window=True)
        got_logits, caches = api.serve_decode_step(
            pp, pcfg, caches, start + t, torch.from_numpy(np.array(tok)),
            force_window=True)
        assert bool(torch.isfinite(got_logits).all())
        _close(got_logits, want_logits)
        _caches_close(caches, want_caches)
        tok = jnp.argmax(want_logits, -1).astype(jnp.int32)


@pytest.mark.parametrize("arch", LONG)
def test_decode_after_prefill_matches_reference(arch):
    want, want_caches, nxt = _ref_prefill(arch)
    _, caches, _ = _port_prefill(arch, force_window=True)
    _decode_both(arch, int(nxt), want_caches, caches,
                 jnp.argmax(want[:, -1], -1).astype(jnp.int32))


@pytest.mark.parametrize("arch", LONG)
def test_decode_at_far_positions_matches_reference(arch):
    """From the prefill's caches, 8 steps at cur_index 524,280 …
    524,287: the ring's prompt positions fall out of the window, the
    pinned meta tokens stay visible, and rotary runs at ~5.2e5 rad."""
    want, want_caches, _ = _ref_prefill(arch)
    _, caches, _ = _port_prefill(arch, force_window=True)
    _decode_both(arch, FAR, want_caches, caches,
                 jnp.argmax(want[:, -1], -1).astype(jnp.int32))


@pytest.mark.parametrize("arch", LONG)
def test_greedy_decode_matches_reference(arch):
    """``greedy_decode(force_window=True)``'s tokens against the steps the
    reference's ``greedy_decode`` chains (its prefill, then
    ``make_serve_step(force_window=True)``), where the margins allow;
    the engine's steps chained by hand give the same tokens."""
    n_new = 6
    cfg, rp, pp, toks = _setup(arch)
    pcfg = get_config(arch)
    got = greedy_decode(pp, pcfg, torch.from_numpy(toks), n_new,
                        force_window=True)
    context_len = S + n_new + cfg.hybrid_meta_tokens
    logits, caches, nxt = ref_tr.prefill(
        rp, cfg, jnp.asarray(toks), context_len=context_len,
        force_window=True, attn_impl="flash")
    logits = logits[:, -1]
    step = ref_engine.make_serve_step(cfg, force_window=True)
    want = []
    for t in range(n_new):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        tol = 2 * (ATOL + RTOL * float(np.abs(top2).max()))
        assert float((top2[:, 1] - top2[:, 0]).min()) > tol
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(cur))
        _, logits, caches = step(rp, caches,
                                 jnp.asarray(int(nxt) + t, jnp.int32), cur)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    plog, pcaches, pnext = make_prefill_step(
        pcfg, context_len=context_len, force_window=True)(
        pp, {"tokens": torch.from_numpy(toks)})
    cur = torch.argmax(plog[:, -1], -1).to(torch.int32)
    serve = make_serve_step(pcfg, force_window=True)
    chain = []
    for t in range(n_new):
        chain.append(cur)
        cur, _, pcaches = serve(pp, pcaches, pnext + t, cur)
    assert torch.equal(torch.stack(chain, 1), got)


def _serve_run(arch, **kw):
    """Prefill, 3 decode steps, ``greedy_decode``: every output."""
    _, _, pp, toks = _setup(arch)
    pcfg = get_config(arch)
    logits, caches, nxt = transformer.prefill(
        pp, pcfg, torch.from_numpy(toks), context_len=S + 4, **kw)
    outs = [logits] + [t for e in caches for d in e.values()
                       for t in d.values()]
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    for t in range(3):
        lg, caches = api.serve_decode_step(pp, pcfg, caches, nxt + t, tok,
                                           **kw)
        outs.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32)
    outs.append(greedy_decode(pp, pcfg, torch.from_numpy(toks), 3, **kw))
    return outs


@pytest.mark.parametrize("arch", LONG + ("tinyllama-1.1b-reduced",))
def test_force_window_false_is_bitwise_the_default(arch):
    for g, w in zip(_serve_run(arch, force_window=False), _serve_run(arch)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["mamba2-1.3b-reduced",
                                  "tinyllama-1.1b-reduced"])
def test_force_window_changes_nothing_without_global_windows(arch):
    """A config whose windows ``force_window`` leaves as they are (an SSM,
    or dense attention with no window) serves bitwise the same."""
    for g, w in zip(_serve_run(arch, force_window=True), _serve_run(arch)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("head_dim", [64, 256])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_far_positions(head_dim, theta):
    """Rotary at positions 524,256 … 524,287 (angles up to 5.2e5 rad):
    both packages' angles are the f32 product of the same position and
    their own ``inv_freq``, bitwise equal where those agree; each CPU's
    cos/sin of them within 4e-8 of float64's (measured <= 3.6e-8); the
    rotated values within N7's 1e-4 of each other (measured 3.1e-5 at
    Dh 256, where one of XLA's 128 ``inv_freq`` is an ulp off torch's)."""
    half = head_dim // 2
    pos = np.arange(CONTEXT - 32, CONTEXT, dtype=np.int32)
    x = np.random.default_rng(head_dim).normal(
        size=(1, 32, 2, head_dim)).astype(np.float32)
    rf = np.asarray(1.0 / (theta ** (jnp.arange(half, dtype=jnp.float32)
                                     / half)))
    pf = (1.0 / (theta ** (torch.arange(half, dtype=torch.float32)
                           / half))).numpy()
    ra = np.asarray(jnp.asarray(pos)[:, None].astype(jnp.float32) * rf)
    pa = (torch.from_numpy(pos)[:, None].float()
          * torch.from_numpy(pf)).numpy()
    same = rf == pf
    np.testing.assert_array_equal(ra[:, same], pa[:, same])
    a64 = pa.astype(np.float64)
    for fn, f64 in ((torch.cos, np.cos), (torch.sin, np.sin)):
        assert np.abs(fn(torch.from_numpy(pa)).numpy() - f64(a64)).max() \
            <= 4e-8
    r64 = ra.astype(np.float64)
    for fn, f64 in ((jnp.cos, np.cos), (jnp.sin, np.sin)):
        assert np.abs(np.asarray(fn(jnp.asarray(ra))) - f64(r64)).max() \
            <= 4e-8
    got = layers.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy()
    want = np.asarray(ref_layers.rotary_embed(jnp.asarray(x),
                                              jnp.asarray(pos), theta))
    _close(got, want)
