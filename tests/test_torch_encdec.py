"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper's
audio family) and its serving path against the reference's
``repro.models.encdec`` on the same params (``interop.
lm_params_from_jax`` of the reference's ``init_encdec``), seeded numpy
frames and prompts, on ``whisper-large-v3-reduced`` (f32 compute).

Tolerances as ``tests/test_torch_lm.py``'s: rtol/atol 1e-4 on the
memory, logits and the cross K/V (f32 GEMMs and reductions in other
orders); greedy tokens equal at every step whose top-2 logit margin
exceeds twice that; the encoder's position table bitwise.  The
reference takes full attention everywhere on the CPU, as the port's
``attend(None)`` does there (on the card the encoder and the
cross-attention run K11).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import api, encdec, layers
from repro_torch.serve import greedy_decode, make_serve_step

ARCH = "whisper-large-v3-reduced"
RTOL = ATOL = 1e-4
PROMPTS = [3, 8]                      # decoder prompt lengths


@functools.lru_cache(maxsize=None)
def _setup(s: int):
    cfg = ref_get_config(ARCH)
    rp = jax.tree_util.tree_map(np.asarray, ref_encdec.init_encdec(
        jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    frames = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    return cfg, rp, lm_params_from_jax(rp, device="cpu"), toks, frames


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seq,dim", [(16, 256), (1500, 1280), (7, 10)])
def test_sinusoidal_positions_bitwise(seq, dim):
    got = layers.sinusoidal_positions(seq, dim)
    want = ref_layers.sinusoidal_positions(seq, dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", PROMPTS)
def test_encode_matches_reference(s):
    cfg, rp, pp, _, frames = _setup(s)
    want = ref_encdec.encode(rp, cfg, jnp.asarray(frames))
    got = encdec.encode(pp, get_config(ARCH), torch.from_numpy(frames))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("s", PROMPTS)
def test_forward_encdec_matches_reference(s):
    """The teacher-forced forward, whole and ``last_only``, and through
    ``api.forward`` (aux 0, no prefix)."""
    cfg, rp, pp, toks, frames = _setup(s)
    pcfg = get_config(ARCH)
    want = ref_encdec.forward_encdec(rp, cfg, jnp.asarray(toks),
                                     jnp.asarray(frames))
    got, aux, n_prefix = api.forward(pp, pcfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    assert got.shape == want.shape and float(aux) == 0.0 and n_prefix == 0
    _close(got, want)
    last = encdec.forward_encdec(pp, pcfg, torch.from_numpy(toks),
                                 torch.from_numpy(frames), last_only=True)
    _close(last, want[:, -1:])


@pytest.mark.parametrize("s", PROMPTS)
def test_decode_state_and_steps_match_reference(s):
    """``init_decode_state``'s cross K/V of the reference's memory, then
    the prompt and three more tokens through ``decode_step`` from each
    side's caches: logits and self-attention caches."""
    cfg, rp, pp, toks, frames = _setup(s)
    pcfg = get_config(ARCH)
    memory = ref_encdec.encode(rp, cfg, jnp.asarray(frames))
    want = ref_encdec.init_decode_state(rp, cfg, 2, s + 3, memory)
    got = api.init_serve_state(pp, pcfg, 2, s + 3, memory=torch.from_numpy(
        np.array(memory)))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        _close(g["cross_k"], w["cross_k"])
        _close(g["cross_v"], w["cross_v"])
        assert tuple(g["attn"]["k"].shape) == w["attn"]["k"].shape
    feed = np.concatenate([toks, toks[:, :3]], 1)
    for t in range(s + 3):
        tok = feed[:, t]
        want_logits, want = ref_encdec.decode_step(
            rp, cfg, want, jnp.asarray(t, jnp.int32), jnp.asarray(tok))
        got_logits, got = api.serve_decode_step(pp, pcfg, got, t,
                                                torch.from_numpy(tok))
        _close(got_logits, want_logits)
    for g, w in zip(got, want):
        for name in ("k", "v", "pos"):
            _close(g["attn"][name], w["attn"][name])


def test_init_serve_state_needs_memory():
    _, _, pp, _, _ = _setup(3)
    with pytest.raises(ValueError, match="memory"):
        api.init_serve_state(pp, get_config(ARCH), 2, 8)


@pytest.mark.parametrize("s", PROMPTS)
def test_greedy_decode_matches_reference(s):
    """Tokens equal to the reference's ``greedy_decode`` where its top-2
    margin is above twice the logit tolerance (every step at these
    seeds); the port's serve steps, chained by hand from the encoder
    memory, give the same tokens."""
    n_new = 6
    cfg, rp, pp, toks, frames = _setup(s)
    pcfg = get_config(ARCH)
    got = greedy_decode(pp, pcfg, torch.from_numpy(toks), n_new,
                        extra_embeds=torch.from_numpy(frames))
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    want = ref_engine.greedy_decode(rp, cfg, jnp.asarray(toks), n_new,
                                    extra_embeds=jnp.asarray(frames))
    # the reference's margins along its own chain
    memory = ref_encdec.encode(rp, cfg, jnp.asarray(frames))
    caches = ref_encdec.init_decode_state(rp, cfg, 2, s + n_new, memory)
    feed = np.concatenate([toks, np.asarray(want)], 1)
    margins = []
    for t in range(s + n_new - 1):
        logits, caches = ref_encdec.decode_step(
            rp, cfg, caches, jnp.asarray(t, jnp.int32),
            jnp.asarray(feed[:, t]))
        if t >= s - 1:
            top2 = np.sort(np.asarray(logits), -1)[:, -2:]
            tol = 2 * (ATOL + RTOL * float(np.abs(top2).max()))
            margins.append(float((top2[:, 1] - top2[:, 0]).min()) - tol)
    assert min(margins) > 0, margins
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the engine's serve step, chained by hand
    mem = encdec.encode(pp, pcfg, torch.from_numpy(frames))
    pc = api.init_serve_state(pp, pcfg, 2, s + n_new, memory=mem)
    step = make_serve_step(pcfg)
    for t in range(s):
        cur, _, pc = step(pp, pc, t, torch.from_numpy(toks[:, t]))
    chain = []
    for t in range(s, s + n_new):
        chain.append(cur)
        cur, _, pc = step(pp, pc, t, cur)
    assert torch.equal(torch.stack(chain, 1), got)
