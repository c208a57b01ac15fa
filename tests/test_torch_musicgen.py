"""MusicGen-medium in the port against the JAX package: ``musicgen_medium.
reduced()`` (MHA 4 x 64, GELU MLP, K = 4 codebooks of 512 ids) with bridged
weights through ``forward_full``, ``prefill``, ``prefill_append`` and
``decode_step`` (the dense route), and ``prefill_chunk_paged`` and
``decode_step_paged`` (the paged route), on (B, S, 4) tokens, on the port's
plain path and its kernel path: f32 logits within ``LOGIT_TOL`` with JAX's
shapes ((B, S, K, V), (B, K, V), (B, 1, K, V)) and greedy tokens identical
per codebook. The K codebook embeddings are summed in the table's dtype in
JAX's order (bf16 bit for bit), and, as in JAX, neither the single-stream
engine nor the batched servers serve an audio model."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_family import IMPLS, bridged, close, engines, tcfg_of, torch_params
from repro.configs.musicgen_medium import CONFIG as JAX_MUSICGEN
from repro.models import decode_step as jax_decode_step
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import forward_full as jax_forward_full
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import prefill_append as jax_prefill_append
from repro.models import prefill_chunk_paged as jax_prefill_chunk_paged
from repro.models.cache import init_paged_pool as jax_init_paged_pool
from repro.models.layers import embed_tokens as jax_embed_tokens
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro_torch.configs import MUSICGEN_MEDIUM
from repro_torch.models import (
    decode_step,
    decode_step_paged,
    forward_full,
    init_params,
    params_from_numpy,
    prefill,
    prefill_append,
    prefill_chunk_paged,
)
from repro_torch.models.cache import init_paged_pool
from repro_torch.models.layers import embed_tokens
from repro_torch.serving import BatchedServer

JCFG = JAX_MUSICGEN.reduced()
K, V = JCFG.n_codebooks, JCFG.vocab_size


def _codes(seed, b, s):
    return np.random.default_rng(seed).integers(0, V, size=(b, s, K)).astype(np.int32)


def _greedy(logits):
    """(B, 1, K, V) or (B, K, V) logits -> the (B, 1, K) next codes."""
    a = np.asarray(logits)
    return a.reshape(a.shape[0], K, V).argmax(-1)[:, None, :].astype(np.int32)


def test_reduced_config_and_embedding_shapes_match_jax():
    assert (MUSICGEN_MEDIUM.n_codebooks, MUSICGEN_MEDIUM.arch_type) == (4, "audio")
    assert (MUSICGEN_MEDIUM.n_layers, MUSICGEN_MEDIUM.n_heads, MUSICGEN_MEDIUM.d_head) == (
        48, 24, 64)
    jp = jax_init_params(jax.random.key(0), JCFG)
    tp = init_params(tcfg_of(JCFG), seed=0, device="cpu")
    for name in ("tok", "lm_head", "final_norm"):
        assert tuple(tp["embed"][name].shape) == jp["embed"][name].shape, name
    assert tuple(tp["embed"]["tok"].shape) == (K, V, JCFG.d_model)
    assert tuple(tp["embed"]["lm_head"].shape) == (JCFG.d_model, K * V)


def test_bf16_codebook_tables_bridge_and_sum_bit_exact():
    """The (K, V, D) table and (D, K * V) head cross bit-exact in bf16, and
    the K embeddings sum in bf16 in JAX's order to the same bits."""
    jcfg = JAX_MUSICGEN.reduced(param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(3), jcfg))
    tp = params_from_numpy(tree, tcfg_of(jcfg), device="cpu")
    for name in ("tok", "lm_head"):
        got = tp["embed"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      tree["embed"][name].view(np.int16))
    codes = _codes(5, 2, 9)
    want = np.asarray(jax_embed_tokens(jax.tree_util.tree_map(jnp.asarray, tree["embed"]),
                                       jnp.asarray(codes), jcfg))
    assert want.dtype == ml_dtypes.bfloat16
    got = embed_tokens(tp["embed"], torch.from_numpy(codes), tcfg_of(jcfg))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_full_matches_jax(impl):
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG)
    codes = _codes(4, 2, 29)
    jlog, _ = jax_forward_full(jparams, JCFG, jnp.asarray(codes))
    tlog, aux = forward_full(torch_params(tree, tc), tc, torch.from_numpy(codes))
    assert tuple(tlog.shape) == (2, 29, K, V) and float(aux) == 0.0
    close(tlog, jlog)


@pytest.mark.parametrize("impl", IMPLS)
def test_dense_prefill_append_decode_match_jax(impl):
    """A bucketed prefill of 21 frames (bucket 24) into 48-slot caches,
    chunk appends of 13 and 4 frames (the second's padding runs past the
    cache, so its writes drop), then 8 greedy decode steps on every
    codebook: logits equal JAX's and the (1, 1, 4) codes are identical."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG)
    tparams = torch_params(tree, tc)
    codes = _codes(2, 1, 38)
    toks = np.zeros((1, 24, K), np.int32)
    toks[0, :21] = codes[0, :21]
    tl = np.asarray([21], np.int32)
    jl, jc, jpos = jax_prefill(jparams, JCFG, jnp.asarray(toks), max_len=48,
                               true_len=jnp.asarray(tl))
    tlog, tc_, tpos = prefill(tparams, tc, torch.from_numpy(toks), max_len=48,
                              true_len=torch.from_numpy(tl))
    assert tuple(tlog.shape) == (1, K, V)
    close(tlog, jl)
    for start, stop in ((21, 34), (34, 38)):
        toks = np.zeros((1, 16, K), np.int32)
        toks[0, : stop - start] = codes[0, start:stop]
        n = np.asarray([stop - start], np.int32)
        jl, jc, jpos = jax_prefill_append(jparams, JCFG, jc, jnp.asarray(toks), jpos,
                                          true_len=jnp.asarray(n))
        tlog, tc_, tpos = prefill_append(tparams, tc, tc_, torch.from_numpy(toks), start,
                                         torch.from_numpy(n))
        assert tuple(tlog.shape) == (1, K, V)
        close(tlog, jl)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    nxt = _greedy(jl)
    for step in range(8):
        pos = np.asarray([38 + step], np.int32)
        jl, jc = jax_decode_step(jparams, JCFG, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tlog, tc_ = decode_step(tparams, tc, tc_, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert tuple(tlog.shape) == (1, 1, K, V)
        close(tlog, jl)
        nxt = _greedy(jl)
        np.testing.assert_array_equal(_greedy(tlog.numpy()), nxt)


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_prefill_and_decode_match_jax(impl):
    """Two paged prefill chunks of 21 and 16 frames (the second from
    mid-page) through a scattered page table, then 10 greedy paged decode
    steps: logits, codes, pools and kv_pos equal JAX's."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG, seed=1)
    tparams = torch_params(tree, tc)
    ps, mp = 8, 8
    jpools = [jax_init_paged_pool(JCFG, JCFG.n_layers, 12, ps)]
    tpools = [init_paged_pool(tc, tc.n_layers, 12, ps)]
    table = np.asarray([[3, 7, 1, 9, 2, 11, 5, 4]], np.int32)
    codes = _codes(1, 1, 37)
    for start, stop, width in ((0, 21, 24), (21, 37, 16)):
        toks = np.zeros((1, width, K), np.int32)
        toks[0, : stop - start] = codes[0, start:stop]
        p0, n = np.asarray([start], np.int32), np.asarray([stop - start], np.int32)
        jl, jpools = jax_prefill_chunk_paged(jparams, JCFG, jpools, jnp.asarray(table),
                                             jnp.asarray(toks), jnp.asarray(p0),
                                             jnp.asarray(n))
        tlog = prefill_chunk_paged(tparams, tc, tpools, torch.from_numpy(table),
                                   torch.from_numpy(toks), torch.from_numpy(p0),
                                   torch.from_numpy(n))
        assert tuple(tlog.shape) == (1, K, V)
        close(tlog, jl)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[0][name].numpy(), np.asarray(jpools[0][name]),
                                   rtol=1e-5, atol=1e-5)
    kv_np = np.where(np.arange(mp * ps) < 37, np.arange(mp * ps), -1).astype(np.int32)[None]
    jkv, tkv = jnp.asarray(kv_np), torch.from_numpy(kv_np.copy())
    nxt = _greedy(jl)
    for step in range(10):
        pos = np.asarray([37 + step], np.int32)
        jl, jpools, jkv = jax_decode_step_paged(jparams, JCFG, jpools, jnp.asarray(table), jkv,
                                                jnp.asarray(nxt), jnp.asarray(pos))
        tlog = decode_step_paged(tparams, tc, tpools, torch.from_numpy(table), tkv,
                                 torch.from_numpy(nxt), torch.from_numpy(pos))
        assert tuple(tlog.shape) == (1, 1, K, V)
        close(tlog, jl)
        nxt = _greedy(jl)
        np.testing.assert_array_equal(_greedy(tlog.numpy()), nxt)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))


@pytest.mark.parametrize("route", ["dense", "paged"])
def test_engine_raises_at_the_first_turn_as_jax(route):
    """The single-stream engines take token-id lists, which embed to one
    stream: both raise the same ValueError at an audio model's first turn
    (a limit shared with JAX, not a fault of the port)."""
    kw = dict(page_size=16, kv_pages=96) if route == "paged" else {}
    jeng, teng = engines(JCFG, 256, **kw)
    ids = list(range(5, 40))
    with pytest.raises(ValueError) as jerr:
        jeng.generate_ex(ids, max_new_tokens=4, cache_key="a")
    with pytest.raises(ValueError) as terr:
        teng.generate_ex(ids, max_new_tokens=4, cache_key="a")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("paged", [False, True])
def test_batched_servers_refuse_audio_as_jax(paged):
    jparams = jax_init_params(jax.random.key(1), JCFG)
    with pytest.raises(AssertionError):
        JaxBatchedServer(JCFG, jparams, n_slots=2, max_len=64, paged=paged)
    tc = tcfg_of(JCFG)
    tparams = torch_params(jax.tree_util.tree_map(np.asarray, jparams), tc)
    with pytest.raises(NotImplementedError, match="full-cache attention"):
        BatchedServer(tc, tparams, n_slots=2, max_len=64, paged=paged, device="cpu")
