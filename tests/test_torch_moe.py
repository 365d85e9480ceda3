"""The port's MoE (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same seeded numpy inputs and weights.

Selections bitwise: ``capacity``; ``top_k`` against ``lax.top_k`` (ties
to the lower index, on rows with exact ties and on the mostly-zero gate
rows the per-expert top-C sees); ``_route``'s ``top_i``; each expert's
top-C tokens (``sel_idx``) where gates tie, at 0 and where two experts
are the same; ``dispatch_cumsum``'s slots and keep flags.  f32 values
(probabilities, gates, expert outputs, y, the load-balance loss) within
rtol/atol 1e-5 (f32 GEMMs and sums in other orders), under capacity
overflow too.  In bf16 (the configs' dtype) the layer's y is held as
``tests/test_torch_lm.py`` holds a block: each gap within 2^-6·max|y|,
at most 2% of the bits off the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as ref_moe
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import params_from_jax
from repro_torch.models import moe

TOL = 1e-5
# (experts, top-k, capacity factor, tokens B×S, d_model, d_ff): olmoe's
# and dbrx's reduced shapes, more experts than a token picks, and a
# capacity factor that drops tokens
CASES = [(4, 2, 1.25, (2, 24), 32, 48), (16, 4, 1.25, (2, 40), 64, 32),
         (8, 2, 0.5, (2, 32), 32, 64), (64, 8, 1.25, (1, 16), 32, 16)]
IDS = ["olmoe-reduced", "dbrx-like", "overflow", "olmoe-experts"]


def _cfgs(e, k, cf):
    return (RefMoEConfig(num_experts=e, top_k=k, capacity_factor=cf),
            MoEConfig(num_experts=e, top_k=k, capacity_factor=cf))


def _layer(e, k, cf, bs, d, f, seed=0):
    rcfg, pcfg = _cfgs(e, k, cf)
    rp = jax.tree_util.tree_map(np.asarray, ref_moe.init_moe(
        jax.random.PRNGKey(seed), d, f, rcfg, jnp.float32))
    x = np.random.default_rng(seed).normal(size=bs + (d,)).astype(np.float32)
    return rcfg, pcfg, rp, params_from_jax(rp, device="cpu"), x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 4096])
@pytest.mark.parametrize("e,k,cf", [(64, 8, 1.25), (16, 4, 1.25),
                                    (4, 2, 0.5)])
def test_capacity_matches_reference(tokens, e, k, cf):
    rcfg, pcfg = _cfgs(e, k, cf)
    assert moe.capacity(tokens, pcfg) == ref_moe.capacity(tokens, rcfg)


@pytest.mark.parametrize("shape,k", [((6, 10), 3), ((4, 300), 40),
                                     ((3, 9), 9)])
def test_top_k_matches_lax_top_k_with_ties(shape, k):
    """Values drawn from a handful of levels (many exact ties, zeros and
    negatives), and mostly-zero rows: the same indices as
    ``lax.top_k``, the lower index first among equals."""
    rng = np.random.default_rng(shape[1])
    levels = np.array([0.0, 0.0, 0.25, 0.5, -1.5, 3.0], np.float32)
    x = levels[rng.integers(0, len(levels), shape)]
    x[0] = 0.0
    x[-1, ::3] = rng.random(len(x[-1, ::3])).astype(np.float32)
    vals, idx = moe.top_k(torch.from_numpy(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_route_matches_reference(case):
    e, k, cf, bs, d, f = case
    _, _, rp, pp, x = _layer(*case)
    xf = x.reshape(-1, d)
    want = ref_moe._route(jnp.asarray(xf), jnp.asarray(rp["router"]), e, k)
    got = moe._route(torch.from_numpy(xf), pp["router"], e, k)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)


def _ref_local(rp, x, rcfg):
    return ref_moe._moe_forward_local(
        jax.tree_util.tree_map(jnp.asarray, rp), jnp.asarray(x), rcfg)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moe_forward_local_matches_reference(case):
    """y and the load-balance loss; ``moe_forward`` is the local path."""
    rcfg, pcfg, rp, pp, x = _layer(*case)
    want_y, want_aux = _ref_local(rp, x, rcfg)
    got_y, got_aux = moe.moe_forward(pp, torch.from_numpy(x), pcfg)
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_aux, want_aux)


def test_capacity_overflow_drops_tokens():
    """The overflow case really drops: some chosen (token, expert) pairs
    miss their expert's top-C, and dropped tokens' y lacks that
    expert's share (held to the reference above)."""
    e, k, cf, bs, d, f = CASES[2]
    _, pcfg, rp, pp, x = _layer(*CASES[2])
    xf = torch.from_numpy(x.reshape(-1, d))
    gates, _, _, top_i = moe._route(xf, pp["router"], e, k)
    c = moe.capacity(xf.shape[0], pcfg)
    _, sel_idx = moe.top_k(gates.T, c)
    kept = sum(int(t in set(sel_idx[ex].tolist()))
               for t, row in enumerate(top_i.tolist()) for ex in row)
    assert c < xf.shape[0] and kept < top_i.numel()


def test_tied_gates_lower_index_wins():
    """Experts 1 and 2 share one router column and experts 0 and 3
    another, so every token's probabilities tie in pairs, and its top-k
    cuts between tied values: the lower expert index is chosen, as the
    reference chooses; each expert's top-C over the tied gates takes the
    lower token indices.  y and the loss equal the reference's."""
    e, k, d, f = 4, 1, 16, 24
    rcfg, pcfg = _cfgs(e, k, 1.0)
    rp = jax.tree_util.tree_map(np.array, ref_moe.init_moe(
        jax.random.PRNGKey(3), d, f, rcfg, jnp.float32))
    rp["router"][:, 2] = rp["router"][:, 1]
    rp["router"][:, 3] = rp["router"][:, 0]
    x = np.random.default_rng(3).normal(size=(1, 12, d)).astype(np.float32)
    x[0, 6:] = x[0, :6]                      # equal tokens: tied gates
    pp = params_from_jax(rp, device="cpu")
    xf = x.reshape(-1, d)
    want = ref_moe._route(jnp.asarray(xf), jnp.asarray(rp["router"]), e, k)
    got = moe._route(torch.from_numpy(xf), pp["router"], e, k)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert set(got[3].flatten().tolist()) <= {0, 1}
    c = moe.capacity(xf.shape[0], pcfg)
    want_sel = jax.lax.top_k(want[0].T, c)[1]
    got_sel = moe.top_k(got[0].T, c)[1]
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    want_y, want_aux = _ref_local(rp, x, rcfg)
    got_y, got_aux = moe.moe_forward(pp, torch.from_numpy(x), pcfg)
    _close(got_y, want_y)
    _close(got_aux, want_aux)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dispatch_cumsum_matches_reference(case):
    e, k, cf, bs, d, f = case
    rcfg, pcfg, rp, pp, x = _layer(*case)
    xf = x.reshape(-1, d)
    _, _, _, top_i = ref_moe._route(jnp.asarray(xf),
                                    jnp.asarray(rp["router"]), e, k)
    c = moe.capacity(xf.shape[0], pcfg)
    want = ref_moe.dispatch_cumsum(jnp.asarray(xf), top_i, c, e)
    got = moe.dispatch_cumsum(torch.from_numpy(xf),
                              torch.from_numpy(np.array(top_i)), c, e)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_combine_cumsum_matches_reference(case):
    """The dispatch, the reference's expert FFN, then the combine, on the
    reference's dispatch outputs."""
    e, k, cf, bs, d, f = case
    rcfg, pcfg, rp, pp, x = _layer(*case)
    xf = jnp.asarray(x.reshape(-1, d))
    _, _, top_p, top_i = ref_moe._route(xf, jnp.asarray(rp["router"]), e, k)
    c = moe.capacity(xf.shape[0], pcfg)
    xe, eid, pos, keep = ref_moe.dispatch_cumsum(xf, top_i, c, e)
    ye = ref_moe._expert_ffn(xe, rp["wi_gate"], rp["wi_up"], rp["wo"],
                             jnp.float32)
    want = ref_moe.combine_cumsum(ye, top_p, eid, pos, keep, jnp.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    got = moe.combine_cumsum(t(ye), t(top_p), t(eid), t(pos), t(keep),
                             torch.float32)
    _close(got, want)


@pytest.mark.parametrize("n_chunks", [8, 1])
@pytest.mark.parametrize("c", [4, 16, 40])
def test_expert_ffn_matches_reference(c, n_chunks, monkeypatch):
    """The SwiGLU of every expert on its slots, chunked along the slots
    (8 chunks where C divides and C >= 16) or not."""
    monkeypatch.setenv("REPRO_MOE_FFN_CHUNK", str(n_chunks))
    e, d, f = 4, 32, 48
    _, _, rp, pp, _ = _layer(e, 2, 1.25, (1, 4), d, f)
    xe = np.random.default_rng(c).normal(size=(e, c, d)).astype(np.float32)
    want = ref_moe._expert_ffn(jnp.asarray(xe), rp["wi_gate"], rp["wi_up"],
                               rp["wo"], jnp.float32)
    got = moe._expert_ffn(torch.from_numpy(xe), pp["wi_gate"], pp["wi_up"],
                          pp["wo"], torch.float32, n_chunks=n_chunks)
    _close(got, want)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_bf16_moe_forward_matches_reference(case):
    rcfg, pcfg, rp, pp, x = _layer(*case)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_y, want_aux = _ref_local(rp, xb, rcfg)
    got_y, got_aux = moe.moe_forward(
        pp, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
            torch.bfloat16), pcfg)
    assert got_y.dtype == torch.bfloat16
    w = np.asarray(want_y.astype(jnp.float32), np.float64)
    gap = np.abs(got_y.float().numpy().astype(np.float64) - w)
    assert gap.max() <= 2.0 ** -6 * np.abs(w).max()
    assert (gap > 0).mean() <= 0.02, (gap > 0).mean()
    _close(got_aux, want_aux)


def test_moe_config_fields_match_reference():
    assert (dataclasses.asdict(MoEConfig(num_experts=64, top_k=8))
            == dataclasses.asdict(RefMoEConfig(num_experts=64, top_k=8)))
