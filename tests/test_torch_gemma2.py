"""Gemma2-27B in the port against the JAX package: the ring-cache helpers
of ``models/cache.py``; ``gemma2_27b.reduced()`` (one local/global pair,
window 64, attention softcap 50, final softcap 30, GeGLU, tied embeddings)
with bridged weights through ``forward_full``, ``prefill``,
``make_decode_caches`` and ``decode_step`` with a local ring that wraps in
prefill (contexts of 100-200 tokens) and in decode; the sliding-window
variant (every layer a ring) on a dense config; the engine's turns (the
dense route, no session pool); the batched servers (the paged one refuses
gemma2, as JAX's does; the full-width one serves it, as JAX's does); and
the R7 probe: JAX's bucketed gemma2 prefill loses real positions from the
local ring, and the port reproduces it token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_family import (
    IMPLS,
    assert_caches,
    bridged,
    check_batched_wave,
    close,
    decode_greedy,
    engines,
    tcfg_of,
    torch_params,
)
from repro.configs.chatglm3_6b import CONFIG as JAX_CHATGLM3
from repro.configs.gemma2_27b import CONFIG as JAX_GEMMA2
from repro.models import cache as jcache
from repro.models import forward_full as jax_forward_full
from repro.models import make_decode_caches as jax_make_caches
from repro.models import prefill as jax_prefill
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro_torch.configs import GEMMA2_27B
from repro_torch.models import (
    forward_full,
    layer_groups,
    make_decode_caches,
    prefill,
    supports_append,
)
from repro_torch.models import cache as tcache
from repro_torch.serving import BatchedLLMService, BatchedServer

JCFG = JAX_GEMMA2.reduced()
W = JCFG.sliding_window            # 64


def test_reduced_config_and_groups():
    assert W == 64 and (JCFG.attn_softcap, JCFG.logit_softcap) == (50.0, 30.0)
    tc = tcfg_of(JCFG)
    assert [(g.kind, g.n_blocks) for g in layer_groups(tc)] == [("gemma_pair", 1)]
    assert [(g.kind, g.n_blocks) for g in layer_groups(GEMMA2_27B)] == [("gemma_pair", 23)]
    assert not supports_append(tc)


@pytest.mark.parametrize("seq_len", [5, 16, 23, 40])
def test_ring_helpers_match_jax(seq_len):
    """``write_step``/``update_kv_pos`` with ``ring`` (slot = pos % T) and
    without (clamped), ``prefill_kv_pos`` and ``ring_from_prefill`` for a
    sequence shorter than, equal to and longer than the 16-slot ring."""
    rng = np.random.default_rng(seq_len)
    B, T, KV, Dh = 3, 16, 2, 4
    ck = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    new = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    kv = rng.integers(-1, 40, size=(B, T)).astype(np.int32)
    pos = np.asarray([3, 17, seq_len + 31], np.int32)
    for ring in (True, False):
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy() + 1)
        tcache.write_step(tk, tv, torch.from_numpy(new), torch.from_numpy(new),
                          torch.from_numpy(pos), ring)
        jk, jv = jcache.write_step(jnp.asarray(ck), jnp.asarray(ck + 1), jnp.asarray(new),
                                   jnp.asarray(new), jnp.asarray(pos), ring)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        tkv = torch.from_numpy(kv.copy())
        tcache.update_kv_pos(tkv, torch.from_numpy(pos), ring)
        np.testing.assert_array_equal(tkv.numpy(), np.asarray(
            jcache.update_kv_pos(jnp.asarray(kv), jnp.asarray(pos), ring)))
        np.testing.assert_array_equal(
            tcache.prefill_kv_pos(2, T, seq_len, ring=ring).numpy(),
            np.asarray(jcache.prefill_kv_pos(2, T, seq_len, ring)))
    k = rng.standard_normal((B, seq_len, KV, Dh)).astype(np.float32)
    np.testing.assert_array_equal(tcache.ring_from_prefill(torch.from_numpy(k), T).numpy(),
                                  np.asarray(jcache.ring_from_prefill(jnp.asarray(k), T)))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_full_matches_jax(impl):
    """Local layers at window 64 over 150 tokens, a padded second lane."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG)
    toks = np.random.default_rng(4).integers(1, JCFG.vocab_size, size=(2, 150)).astype(np.int32)
    sv = np.arange(150)[None, :] < np.asarray([150, 101])[:, None]
    jlog, _ = jax_forward_full(jparams, JCFG, jnp.asarray(toks), seq_valid=jnp.asarray(sv))
    tlog, _ = forward_full(torch_params(tree, tc), tc, torch.from_numpy(toks),
                           seq_valid=torch.from_numpy(sv))
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], rtol=1e-4, atol=1e-4)
    assert np.abs(tlog.numpy()).max() <= JCFG.logit_softcap


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_ctx,steps", [(173, 12), (40, 28)])
def test_prefill_and_ring_decode_match_jax(impl, n_ctx, steps):
    """A prefill of 173 tokens (the local ring wraps in prefill: 64 slots
    hold positions 109-172 in ring order) or of 40 (the ring wraps in
    decode, at step 24), then greedy decode: logits, tokens and both caches
    equal JAX's; ``make_decode_caches`` gives JAX's layout."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG, seed=1)
    tparams = torch_params(tree, tc)
    toks = np.random.default_rng(n_ctx).integers(1, JCFG.vocab_size,
                                                 size=(1, n_ctx)).astype(np.int32)
    max_len = 256
    jl, jcaches, _ = jax_prefill(jparams, JCFG, jnp.asarray(toks), max_len)
    tl, tcaches, tpos = prefill(tparams, tc, torch.from_numpy(toks), max_len)
    close(tl, jl)
    assert_caches(tcaches, jcaches)
    loc = tcaches[0]["local"]
    assert loc["k"].shape[2] == W and tcaches[0]["global"]["k"].shape[2] == max_len
    jcaches, tcaches, _ = decode_greedy(jparams, JCFG, tparams, tc, jcaches, tcaches,
                                        int(np.asarray(jl)[0].argmax()), n_ctx, steps)
    assert_caches(tcaches, jcaches)
    assert sorted(tcaches[0]["local"]["kv_pos"][0].tolist()) == list(
        range(n_ctx + steps - W, n_ctx + steps))
    empty_t, empty_j = make_decode_caches(tc, 2, 48, device="cpu"), jax_make_caches(JCFG, 2, 48)
    assert_caches(empty_t, empty_j)
    assert empty_t[0]["local"]["k"].shape[2] == 48      # min(window, max_len)


@pytest.mark.parametrize("impl", IMPLS)
def test_sliding_window_variant_on_a_dense_config_matches_jax(impl):
    """``attn_variant="sliding_window"`` makes every attention layer of a
    dense decoder a ring of the window's slots (chatglm3 reduced, window
    32): prefill of 90 tokens, 12 decode steps, equal to JAX."""
    jc = JAX_CHATGLM3.reduced(sliding_window=32).with_variant("sliding_window")
    tc = tcfg_of(jc, impl)
    jparams, tree = bridged(jc, seed=2)
    tparams = torch_params(tree, tc)
    assert not supports_append(tc)
    toks = np.random.default_rng(9).integers(1, jc.vocab_size, size=(1, 90)).astype(np.int32)
    jl, jcaches, _ = jax_prefill(jparams, jc, jnp.asarray(toks), 128)
    tl, tcaches, _ = prefill(tparams, tc, torch.from_numpy(toks), 128)
    close(tl, jl)
    assert tcaches[0]["k"].shape[2] == 32
    assert_caches(tcaches, jcaches)
    jtl, _ = jax_forward_full(jparams, jc, jnp.asarray(toks))
    ttl, _ = forward_full(tparams, tc, torch.from_numpy(toks))
    close(ttl, jtl)
    jcaches, tcaches, _ = decode_greedy(jparams, jc, tparams, tc, jcaches, tcaches,
                                        int(np.asarray(jl)[0].argmax()), 90, 12)
    assert_caches(tcaches, jcaches)


def test_engine_turns_match_jax():
    """The dense route with no session pool: every turn a bucketed full
    prefill (bucket 64), then decode; two sessions x 2 turns of 100-200
    tokens and a keyless turn give JAX's tokens, no hit and no reuse."""
    jeng, teng = engines(JCFG, 512)
    assert jeng.session_pool is None and teng.session_pool is None
    rng = np.random.default_rng(0)
    hist = {"A": [], "B": []}
    for turn in range(2):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, JCFG.vocab_size, size=100 if turn == 0 else 60).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            assert t.token_ids == j.token_ids, (turn, key)
            assert not t.cache_hit and t.reused_tokens == 0 and t.prefill_tokens == len(hist[key])
            hist[key] += j.token_ids
    ids = rng.integers(8, JCFG.vocab_size, size=29).tolist()
    assert teng.generate(ids, max_new_tokens=6) == jeng.generate(ids, max_new_tokens=6)


def test_batched_servers_refuse_paged_and_serve_full_width_like_jax():
    """JAX's paged server asserts on gemma2 (its ring caches cannot take a
    chunk append) and the port's raises; ``BatchedLLMService.create(paged=
    True)`` falls back to the full-width server in both; the full-width
    server serves a wave with JAX's tokens."""
    tc = tcfg_of(JCFG)
    with pytest.raises(AssertionError):
        JaxBatchedServer(JCFG, None, paged=True)
    with pytest.raises(NotImplementedError):
        BatchedServer(tc, None, paged=True, device="cpu")
    svc = BatchedLLMService.create("g", tc, paged=True, max_len=128, device="cpu")
    assert not svc.server.paged and svc.server.session_pool is None
    assert svc.server.caches[0]["local"]["k"].shape[2] == W
    check_batched_wave(JCFG, paged=False, pooled=False)


def test_r7_bucketed_prefill_loses_ring_positions_like_jax():
    """R7 (ROADMAP, Queue 3), a fault of the reference: JAX's gemma_pair
    prefill ignores ``true_len``, so a 70-token turn padded to the bucket
    (128 > the 64-slot local ring) keeps padded positions 64-127 in the
    ring and loses real ones 6-63, which the next queries' windows still
    cover. Seed 0, max_len 256: the bucketed turn's tokens first differ
    from an exact-length prefill's at step 1. The port gives JAX's tokens
    on both."""
    ids = np.random.default_rng(0).integers(8, JCFG.vocab_size, size=70).tolist()
    out = {}
    for bucket in (64, 1):
        jeng, teng = engines(JCFG, 256, bucket=bucket)
        j = jeng.generate_ex(ids, max_new_tokens=16).token_ids
        t = teng.generate_ex(ids, max_new_tokens=16).token_ids
        assert t == j, bucket
        out[bucket] = t
    first = next(i for i, (a, b) in enumerate(zip(out[64], out[1])) if a != b)
    assert first == 1 and out[64][0] == out[1][0], out
