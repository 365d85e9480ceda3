"""The port's LLM serving path (``repro_torch.configs``, ``models``,
``serve.engine``) against the JAX package on the same params and prompts.

Both sides start from the reference's ``init_lm`` params (carried across
with ``interop.lm_params_from_jax``) and the same seeded numpy prompts,
on the reduced configs (f32 compute).  Tolerances: logits and caches
within rtol 1e-4 / atol 1e-4 (f32 GEMMs and reductions in other orders;
the measured gap is <= 2.6e-5 at |logits| <= 3.7); greedy tokens equal
at every step whose top-2 logit margin exceeds that tolerance; config
numbers (``param_count``, the reduced configs) exactly.

``forward_lm`` is held against the reference's ``attn_impl="full"``: its
layer-scanned forward raises under ``"flash"`` (ROADMAP §3 R4);
``prefill``, ``decode_step`` and ``greedy_decode`` against its
``"flash"`` (the Pallas kernel in interpret mode, with hymba's meta-token
prefix pinned in its windows), which its Python layer loop runs.  The
vlm case feeds both sides the same seeded numpy patches; the moe cases
(olmoe, dbrx) also compare the load-balance loss.

In bf16 (the configs' own dtype, which the card runs) one output rounded
the other way in a layer moves every later value a little, so whole
forwards of random layers differ by as much as bf16 differs from f32.
The bf16 tests therefore feed each side the same input at each step:
every block of the prefill path gets the reference's input, and every
layer of a decode step the reference's input and cache.  There the port rounds where the
reference rounds: at most 2% of a block's bf16 outputs differ from the
reference's bits (f32 accumulation orders flip a rounding; measured
<= 0.9%), each by at most 2^-6·max|y| (two bf16 steps at the block's
largest value); logits from the reference's final hidden state and
decode's mixers (attention against the cache, the Mamba2 step) held the
same way; logits from the reference's final hidden state within
2^-8·(1 + max|logits|), at most 2% of them not bitwise equal (measured
0.01%).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tr
from repro.serve import engine as ref_engine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import api, transformer
from repro_torch.models.layers import layer_of
from repro_torch.serve import greedy_decode, make_prefill_step, \
    make_serve_step

RTOL = ATOL = 1e-4
# (arch, prompt length): tinyllama (GQA, G = 4), mamba2 (S padded to a
# chunk multiple; S < chunk), gemma2 (windows of 16 with ring caches,
# softcaps, sandwich norms, tied embeddings), hymba (4 meta tokens pinned
# in windows of 16, a global layer 0, attention and Mamba2 side by
# side), olmoe and dbrx (top-k MoE, 4 experts), internvl2 (8 patches
# before the prompt, q/k/v biases)
CASES = [("tinyllama-1.1b-reduced", 40), ("mamba2-1.3b-reduced", 40),
         ("mamba2-1.3b-reduced", 10), ("gemma2-9b-reduced", 40),
         ("hymba-1.5b-reduced", 40), ("olmoe-1b-7b-reduced", 40),
         ("dbrx-132b-reduced", 40), ("internvl2-1b-reduced", 40)]
IDS = [f"{a.split('-')[0]}-S{s}" for a, s in CASES]


@functools.lru_cache(maxsize=None)
def _setup(arch: str, s: int):
    cfg = ref_get_config(arch)
    rp = jax.tree_util.tree_map(np.asarray,
                                ref_tr.init_lm(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)
    return cfg, rp, lm_params_from_jax(rp, device="cpu"), toks


@functools.lru_cache(maxsize=None)
def _patches(arch: str):
    """The vlm's seeded stub patch embeddings (2, vision_tokens, D), or
    None."""
    cfg = ref_get_config(arch)
    if not cfg.vision_tokens:
        return None
    return np.random.default_rng(7).normal(
        size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _ref_extra(arch: str):
    p = _patches(arch)
    return None if p is None else jnp.asarray(p)


def _port_extra(arch: str):
    p = _patches(arch)
    return None if p is None else torch.from_numpy(p)


def _batch(arch: str, toks) -> dict:
    batch = {"tokens": torch.from_numpy(toks)}
    if _patches(arch) is not None:
        batch["patches"] = _port_extra(arch)
    return batch


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _ref_forward(arch: str, s: int):
    cfg, rp, _, toks = _setup(arch, s)
    return ref_tr.forward_lm(rp, cfg, jnp.asarray(toks), _ref_extra(arch),
                             attn_impl="full")


@pytest.mark.parametrize("arch,s", CASES, ids=IDS)
def test_forward_lm_matches_reference(arch, s):
    cfg, _, pp, toks = _setup(arch, s)
    want, want_aux, want_prefix = _ref_forward(arch, s)
    got, aux, n_prefix = api.forward(pp, get_config(arch), _batch(arch, toks))
    assert got.shape == want.shape and n_prefix == want_prefix
    assert n_prefix == cfg.hybrid_meta_tokens + cfg.vision_tokens
    assert (float(aux) == 0.0) == (cfg.moe is None)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch,s", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(arch, s):
    """Prefill logits and caches (the reference's full attention and the
    plain scan here, where the card runs K11 and K12), the ``last_only``
    logits, then three decode steps from each side's caches fed the same
    tokens (the reference's argmax)."""
    cfg, rp, pp, toks = _setup(arch, s)
    pcfg = get_config(arch)
    want, want_caches, want_next = ref_tr.prefill(
        rp, cfg, jnp.asarray(toks), _ref_extra(arch), context_len=s + 4,
        attn_impl="flash")
    got, caches, nxt = transformer.prefill(
        pp, pcfg, torch.from_numpy(toks), _port_extra(arch),
        context_len=s + 4)
    assert nxt == int(want_next) == s + cfg.hybrid_meta_tokens + \
        cfg.vision_tokens
    _close(got, want)
    for g, w in zip(caches, want_caches):
        assert g.keys() == w.keys()
        for kind in w:
            for name in w[kind]:
                assert tuple(g[kind][name].shape) == w[kind][name].shape
                _close(g[kind][name], w[kind][name])
    last, _, _ = transformer.prefill(pp, pcfg, torch.from_numpy(toks),
                                     _port_extra(arch), last_only=True)
    assert last.shape[1] == 1
    _close(last, want[:, -1:])
    tok = jnp.argmax(want[:, -1], -1).astype(jnp.int32)
    for t in range(3):
        want_logits, want_caches = ref_tr.decode_step(
            rp, cfg, want_caches, jnp.asarray(nxt + t, jnp.int32), tok)
        got_logits, caches = api.serve_decode_step(
            pp, pcfg, caches, nxt + t, torch.from_numpy(np.array(tok)))
        _close(got_logits, want_logits)
        tok = jnp.argmax(want_logits, -1).astype(jnp.int32)


@pytest.mark.parametrize("arch,s", CASES, ids=IDS)
def test_greedy_decode_matches_reference(arch, s):
    """Tokens equal to the reference's wherever its top-2 margin is above
    the logit tolerance (every step at these seeds); the engine's prefill
    and serve steps chain to the same tokens as ``greedy_decode``.  The
    reference's tokens come from the steps its ``greedy_decode`` chains
    (``prefill`` with ``"flash"``, then ``make_serve_step``), which also
    give its margins."""
    n_new = 6
    cfg, rp, pp, toks = _setup(arch, s)
    got = greedy_decode(pp, get_config(arch), torch.from_numpy(toks), n_new,
                        extra_embeds=_port_extra(arch))
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    context_len = s + n_new + cfg.vision_tokens + cfg.hybrid_meta_tokens
    logits, caches, nxt = ref_tr.prefill(rp, cfg, jnp.asarray(toks),
                                         _ref_extra(arch),
                                         context_len=context_len,
                                         attn_impl="flash")
    logits = logits[:, -1]
    step = ref_engine.make_serve_step(cfg)
    margins, tols, want = [], [], []
    for t in range(n_new):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        # two logits each within the tolerance of the reference's
        tols.append(2 * (ATOL + RTOL * float(np.abs(top2).max())))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(cur))
        _, logits, caches = step(rp, caches, jnp.asarray(int(nxt) + t,
                                                         jnp.int32), cur)
    want = np.stack(want, 1)
    n_sure = next((t for t, (m, tol) in enumerate(zip(margins, tols))
                   if m <= tol), n_new)
    assert n_sure == n_new, margins
    np.testing.assert_array_equal(got.numpy()[:, :n_sure], want[:, :n_sure])
    # the engine's steps, chained by hand
    pcfg = get_config(arch)
    plog, pcaches, pnext = make_prefill_step(
        pcfg, context_len=context_len)(pp, _batch(arch, toks))
    cur = torch.argmax(plog[:, -1], -1).to(torch.int32)
    serve = make_serve_step(pcfg)
    chain = []
    for t in range(n_new):
        chain.append(cur)
        cur, _, pcaches = serve(pp, pcaches, pnext + t, cur)
    assert torch.equal(torch.stack(chain, 1), got)


BF16_CASES = CASES               # dense (gelu too), ssm, hybrid, moe, vlm
BF16_IDS = IDS
# blocks held step by step (``_block_steps``); gemma2 by its sandwich norms
STEPWISE = ("hymba-1.5b-reduced", "internvl2-1b-reduced")


def _bf16(arch: str):
    return (dataclasses.replace(ref_get_config(arch), dtype="bfloat16"),
            dataclasses.replace(get_config(arch), dtype="bfloat16"))


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _to_port(a) -> torch.Tensor:
    """A reference array as a CPU tensor of its dtype (bf16 kept)."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)
                                  if a.dtype == jnp.bfloat16 else a))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _bf16_close(got, want, *, rel, frac=0.02):
    """Each gap <= rel; a bf16 result's bits equal but for a ``frac``
    share."""
    assert got.dtype == _to_port(want).dtype
    assert tuple(got.shape) == tuple(want.shape)
    gap = np.abs(_np64(got) - _np64(want))
    assert gap.max() <= rel, (gap.max(), rel)
    if got.dtype == torch.bfloat16:
        assert (gap > 0).mean() <= frac, (gap > 0).mean()


def _block_steps(lp, plp, cfg, pcfg, x, y, window):
    """A block in bf16, each step fed the reference's input: the
    attention norm, the q/k/v projections, the attention core with its
    output projection (and gemma2's post-attention norm), hymba's Mamba2
    mixer, and the rest of the block (the MLP half with gemma2's post-MLP
    norm, or hymba's mix of the two mixers and its MLP), each held as a
    whole block is (``_bf16_close``, 2^-6·max, at most 2% of bits).
    Whole blocks of these configs are not: a projection's f32 sum in
    another order flips one rounding (gemma2: 1 of 10,240 k elements at
    layer 1; internvl2: 0.012% of q and 0.016% of v at layer 1), and
    attention spreads it over whole rows (gemma2's post-attention norm
    too: 5.6% of the block's bits; internvl2 2.9%, hymba 2.1% at layer
    0)."""
    from repro.models import attention as ref_attn
    from repro.models import layers as ref_layers
    from repro.models import ssm as ref_ssm
    from repro_torch.models import attention as port_attn
    from repro_torch.models import layers as port_layers
    from repro_torch.models import ssm as port_ssm

    def close(got, want):
        _bf16_close(got, want, rel=2.0 ** -6 * float(np.abs(_np64(want)).max()))

    s, eps, theta = x.shape[1], cfg.norm_eps, cfg.rope_theta
    pos, ppos = jnp.arange(s, dtype=jnp.int32), torch.arange(
        s, dtype=torch.int32)
    kw = dict(causal=True, window=window, prefix=cfg.hybrid_meta_tokens,
              logit_cap=cfg.attn_logit_softcap)
    norm = "input_norm" if cfg.family == "hybrid" else "attn_norm"
    h = ref_layers.rmsnorm(lp[norm], x, eps)
    close(port_layers.rmsnorm(plp[norm], _to_port(x), eps), h)
    q, k, v = ref_attn.qkv_project(lp["attn"], h)
    for got, want in zip(port_attn.qkv_project(plp["attn"], _to_port(h)),
                         (q, k, v)):
        close(got, want)
    a = ref_attn.out_project(lp["attn"], ref_attn.attend(
        ref_attn.rotary_embed(q, pos, theta),
        ref_attn.rotary_embed(k, pos, theta), v, q_pos=pos, k_pos=pos,
        impl="full", **kw))
    pq, pk, pv = map(_to_port, (q, k, v))
    got = port_attn.out_project(plp["attn"], port_attn.attend(
        port_layers.rotary_embed(pq, ppos, theta),
        port_layers.rotary_embed(pk, ppos, theta), pv, q_pos=ppos,
        k_pos=ppos, impl="full", **kw))
    if cfg.family == "hybrid":
        close(got, a)
        m = ref_ssm.mamba_forward(lp["mamba"], h, cfg.ssm)
        close(port_ssm.mamba_forward(plp["mamba"], _to_port(h), pcfg.ssm), m)
        close(transformer._hybrid_mix(plp, _to_port(x), _to_port(a),
                                      _to_port(m), pcfg), y)
        return
    if cfg.sandwich_norms:
        a = ref_layers.rmsnorm(lp["post_attn_norm"], a, eps)
        got = port_layers.rmsnorm(plp["post_attn_norm"], got, eps)
    close(got, a)
    close(transformer._ffn_path(plp, _to_port(x + a), pcfg)[0], y)


@pytest.mark.parametrize("arch,s", BF16_CASES, ids=BF16_IDS)
def test_bf16_blocks_match_reference(arch, s):
    """In bf16, each block of the prefill path from the reference's input
    (its embeddings, then its own block outputs), and the logits from its
    final hidden state (tolerances in the module docstring).  Embeddings
    and meta tokens equal bit for bit; the vlm's projected patches (a
    bf16 GEMM) held as a block is."""
    cfg, pcfg = _bf16(arch)
    _, rp, pp, toks = _setup(arch, s)
    x, n_prefix = ref_tr.embed_inputs(rp, cfg, jnp.asarray(toks),
                                      _ref_extra(arch))
    px, _ = transformer.embed_inputs(pp, pcfg, torch.from_numpy(toks),
                                     _port_extra(arch))
    n_patches = cfg.vision_tokens if _patches(arch) is not None else 0
    assert torch.equal(px[:, n_patches:], _to_port(x[:, n_patches:]))
    if n_patches:
        want = x[:, :n_patches]
        _bf16_close(px[:, :n_patches], want,
                    rel=2.0 ** -6 * float(np.abs(_np64(want)).max()))
    s = x.shape[1]
    pos = jnp.arange(s, dtype=jnp.int32)
    ppos = torch.arange(s, dtype=torch.int32)
    wins = transformer.layer_windows(pcfg)
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], rp["layers"])
        y, _ = ref_tr.block_forward(lp, x, cfg, pos, wins[i], "full")
        plp = layer_of(pp["layers"], i)
        if cfg.sandwich_norms or arch in STEPWISE:
            _block_steps(lp, plp, cfg, pcfg, x, y, wins[i])
        else:
            got, _ = transformer.block_forward(plp, _to_port(x), pcfg, ppos,
                                               wins[i])
            _bf16_close(got, y, rel=2.0 ** -6 * float(np.abs(_np64(y)).max()))
        x = y
    want = ref_tr.lm_logits(rp, cfg, x)
    got = transformer.lm_logits(pp, pcfg, _to_port(x))
    _bf16_close(got, want, rel=2.0 ** -8 * (1 + np.abs(_np64(want)).max()))


def _port_caches(caches):
    return [{kind: {name: _to_port(a) for name, a in c[kind].items()}
             for kind in c} for c in caches]


@pytest.mark.parametrize("arch,s", BF16_CASES, ids=BF16_IDS)
def test_bf16_decode_matches_reference(arch, s):
    """In bf16, one decode step from the reference's prefill caches, layer
    by layer: each layer's mixers (attention against the cache, with
    hymba's pinned meta tokens; the Mamba2 step; both side by side in the
    hybrid) get the reference's input and cache, and their outputs and
    new caches are held to the reference's (tolerances in the module
    docstring; the f32 SSM state within 2^-6·max|state|).  Then the whole
    step, whose logits may differ by one bf16 step at the largest logit
    (2^-7·max|logits|): one flipped rounding in a layer moves every later
    value."""
    from repro.models import layers as ref_layers
    from repro.models import moe as ref_moe
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm as port_ssm

    cfg, pcfg = _bf16(arch)
    _, rp, pp, toks = _setup(arch, s)
    logits, caches, nxt = ref_tr.prefill(rp, cfg, jnp.asarray(toks),
                                         _ref_extra(arch), context_len=s + 1,
                                         attn_impl="flash")
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    idx, eps = int(nxt), cfg.norm_eps
    mine = _port_caches(caches)
    x = jnp.take(rp["embed"], tok, axis=0)[:, None].astype(jnp.bfloat16)
    wins = transformer.layer_windows(pcfg)
    prefix = cfg.hybrid_meta_tokens
    cur = jnp.asarray(idx, jnp.int32)

    def attn_pair(lp, plp, h, i, prefix):
        y, new = ref_tr._decode_attn(lp["attn"], cfg, h, caches[i]["attn"],
                                     cur, wins[i], prefix)
        got, pnew = transformer._decode_attn(
            plp["attn"], pcfg, _to_port(h), mine[i]["attn"], idx, wins[i],
            prefix)
        return y, new, got, pnew

    def ssm_pair(lp, plp, h, i):
        y, new = ref_ssm.mamba_decode_step(lp["mamba"], h, caches[i]["ssm"],
                                           cfg.ssm)
        got, pnew = port_ssm.mamba_decode_step(
            plp["mamba"], _to_port(h), mine[i]["ssm"], pcfg.ssm)
        return y, new, got, pnew

    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], rp["layers"])
        plp = layer_of(pp["layers"], i)
        if cfg.family == "ssm":
            pairs = [ssm_pair(lp, plp, ref_layers.rmsnorm(lp["norm"], x, eps),
                              i)]
            x = x + pairs[0][0]
        elif cfg.family == "hybrid":
            h = ref_layers.rmsnorm(lp["input_norm"], x, eps)
            pairs = [attn_pair(lp, plp, h, i, prefix),
                     ssm_pair(lp, plp, h, i)]
            x = x + 0.5 * (
                ref_layers.rmsnorm(lp["attn_out_norm"], pairs[0][0], eps)
                + ref_layers.rmsnorm(lp["ssm_out_norm"], pairs[1][0], eps))
            x = x + ref_layers.glu_mlp(
                lp["mlp"], ref_layers.rmsnorm(lp["mlp_norm"], x, eps),
                cfg.mlp_act)
        else:
            h = ref_layers.rmsnorm(lp["attn_norm"], x, eps)
            pairs = [attn_pair(lp, plp, h, i, 0)]
            x = x + pairs[0][0]
            h2 = ref_layers.rmsnorm(lp["mlp_norm"], x, eps)
            x = x + (ref_moe.moe_forward(lp["moe"], h2, cfg.moe)[0]
                     if cfg.moe is not None else
                     ref_layers.glu_mlp(lp["mlp"], h2, cfg.mlp_act))
        for y, new, got, pnew in pairs:
            _bf16_close(got, y, rel=2.0 ** -6 * float(np.abs(_np64(y)).max()))
            for name, a in new.items():
                _bf16_close(pnew[name], a,
                            rel=2.0 ** -6 * float(np.abs(_np64(a)).max()))
    want, _ = ref_tr.decode_step(rp, cfg, caches,
                                 jnp.asarray(idx, jnp.int32), tok)
    got, _ = api.serve_decode_step(pp, pcfg, _port_caches(caches), idx,
                                   _to_port(tok))
    _bf16_close(got, want, rel=2.0 ** -7 * np.abs(_np64(want)).max(),
                frac=1.0)


def test_gelu_tanh_bitwise_jax_bf16():
    """``_gelu_tanh`` on 10^5 seeded bf16 inputs equals
    ``jax.nn.gelu(approximate=True)`` bit for bit: both put the constants
    into x's dtype (the cubic coefficient is 0.044677734375 in bf16) and
    round after every op."""
    from repro_torch.models.layers import _gelu_tanh

    x = np.random.default_rng(0).normal(0, 3, 10 ** 5).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
        x, jnp.bfloat16)
    assert np.array_equal(xt.float().numpy(), np.asarray(xj, np.float32))
    got = _gelu_tanh(xt)
    want = jax.nn.gelu(xj, approximate=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_serving_steps_run_without_grad():
    """Serving needs no gradient: the prefill and serve steps run under
    ``no_grad`` (K11 and K12 refuse operands that require grad), so
    params that require grad give logits and caches that do not."""
    cfg = get_config("tinyllama-1.1b-reduced")
    _, _, pp, toks = _setup("tinyllama-1.1b-reduced", 40)
    params = dict(pp, embed=pp["embed"].clone().requires_grad_())
    logits, caches, nxt = make_prefill_step(cfg, context_len=41)(
        params, {"tokens": torch.from_numpy(toks)})
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in caches for kind in c.values()
                   for t in kind.values())
    tok, logits, _ = make_serve_step(cfg)(params, caches, nxt, torch.argmax(
        logits[:, -1], -1).to(torch.int32))
    assert not (logits.requires_grad or tok.requires_grad)


def test_empty_prompt_raises():
    _, _, pp, _ = _setup("tinyllama-1.1b-reduced", 40)
    with pytest.raises(ValueError, match="empty prompt"):
        greedy_decode(pp, get_config("tinyllama-1.1b-reduced"),
                      torch.zeros((2, 0), dtype=torch.int32), 4)


@pytest.mark.parametrize("arch", sorted(REF_ARCH_IDS))
def test_every_config_serves(arch):
    """Every registered config, reduced, initialises through
    ``api.init_params`` and greedily decodes through the engine on the
    CPU (the vlm with patches, audio with encoder frames): int32 tokens
    in the padded vocabulary, the same tokens again."""
    cfg = get_config(arch + "-reduced")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(
        np.int32))
    n_extra = cfg.vision_tokens or cfg.enc_seq
    extra = (torch.from_numpy(rng.normal(size=(2, n_extra, cfg.d_model)
                                         ).astype(np.float32))
             if n_extra else None)
    out = greedy_decode(params, cfg, toks, 3, extra_embeds=extra)
    assert out.dtype == torch.int32 and out.shape == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_padded
    assert torch.equal(out, greedy_decode(params, cfg, toks, 3,
                                          extra_embeds=extra))


@pytest.mark.parametrize("arch", sorted(REF_ARCH_IDS))
def test_configs_match_reference(arch):
    """Every registered config, full and reduced, field for field, and
    its parameter counts."""
    assert ARCH_IDS == REF_ARCH_IDS
    for name in (arch, arch + "-reduced"):
        ref, port = ref_get_config(name), get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.vocab_padded == ref.vocab_padded


def test_get_config_unknown_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-reduced",
                                  "mamba2-1.3b-reduced",
                                  "gemma2-9b-reduced",
                                  "hymba-1.5b-reduced",
                                  "olmoe-1b-7b-reduced",
                                  "dbrx-132b-reduced",
                                  "internvl2-1b-reduced",
                                  "whisper-large-v3-reduced"])
def test_init_params_layout_matches_reference(arch):
    """The port's random init has the reference's tree: same keys, shapes
    and dtypes; weights truncated at 2·fan_in^-0.5, RMS norms at zero
    (LayerNorm scales at one); a seed draws what a generator seeded with
    it draws."""
    from repro.models import api as ref_api

    ref = jax.eval_shape(lambda k: ref_api.init_params(k, ref_get_config(
        arch)), jax.random.PRNGKey(0))
    port = api.init_params(0, get_config(arch), device="cpu")
    again = api.init_params(torch.Generator().manual_seed(0),
                            get_config(arch))
    assert torch.equal(port["embed"], again["embed"])

    def walk(r, p, path=""):
        if isinstance(r, dict):
            assert r.keys() == p.keys(), path
            for k in r:
                walk(r[k], p[k], f"{path}/{k}")
            return
        assert tuple(p.shape) == r.shape, path
        assert str(p.dtype).split(".")[-1] == r.dtype.name, path
    walk(ref, port)
    layer = port.get("layers", port.get("dec_layers"))
    w = layer["mamba"]["wx"] if "mamba" in layer else layer["attn"]["wq"]
    fan_in = w.shape[1]
    assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 + 1e-6
    if "moe" in layer:
        slab = layer["moe"]["wo"]                    # (L, E, F, D)
        assert float(slab.abs().max()) <= 2.0 * slab.shape[2] ** -0.5 + 1e-6
    if "final_norm" in port:
        assert float(port["final_norm"]["scale"].abs().max()) == 0.0
    else:
        assert torch.equal(port["dec_final_norm"]["scale"],
                           torch.ones(get_config(arch).d_model))
