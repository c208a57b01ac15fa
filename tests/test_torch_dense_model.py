"""The port's dense-route model functions against the JAX package with the
same (bridged) weights, in f32: the full-cache helpers of
``models/cache.py`` (clamped decode writes, dropped chunk writes, trims),
``prefill`` (bucketed, ``true_len``), ``prefill_append`` (a second chunk
whose padding runs past the cache, so its writes drop), ``decode_step``
and ``forward_full``, on the tiny GQA config and the paper's Qwen1.5-0.5B
reduced. Logits agree within 1e-4 (the bound of tests/test_torch_model.py),
greedy tokens are identical over 12 steps, and the caches hold the same
K/V and kv_pos. JAX runs its reference path and its Pallas kernels in
interpret mode; the port runs its reference path and its kernel path (K4
and K5's plain versions, on CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.models import decode_step as jax_decode_step
from repro.models import forward_full as jax_forward_full
from repro.models import prefill as jax_prefill
from repro.models import prefill_append as jax_prefill_append
from repro.models import cache as jcache
from repro_torch.models import (
    decode_step,
    forward_full,
    make_decode_caches,
    params_from_numpy,
    prefill,
    prefill_append,
)
from repro_torch.models import cache as tcache
from test_torch_model import bridged_params, tcfg_of

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN = 48


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_full_cache_helpers_match_jax():
    """write_step/update_kv_pos clamp to the last slot, append_kv_pos and
    write_chunk drop past the cache (including a chunk that lies wholly
    past it), trims mask beyond n_valid."""
    rng = np.random.default_rng(0)
    B, T, KV, Dh, S = 3, 10, 2, 4, 5
    ck = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    new = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    kv = rng.integers(-1, T, size=(B, T)).astype(np.int32)

    pos = np.asarray([3, 9, 14], np.int32)                 # lane 2 clamps to slot 9
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy() + 1)
    tcache.write_step(tk, tv, torch.from_numpy(new[:, :1]), torch.from_numpy(new[:, :1]),
                      torch.from_numpy(pos))
    jk, _ = jcache.write_step(jnp.asarray(ck), jnp.asarray(ck + 1), jnp.asarray(new[:, :1]),
                              jnp.asarray(new[:, :1]), jnp.asarray(pos), ring=False)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    tkv = torch.from_numpy(kv.copy())
    tcache.update_kv_pos(tkv, torch.from_numpy(pos))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jcache.update_kv_pos(
        jnp.asarray(kv), jnp.asarray(pos), ring=False)))

    # chunks at p0 7 (3 slots past T), 2 (inside) and 12 (wholly past T)
    valid = np.arange(S)[None, :] < np.asarray([4, 5, 2])[:, None]
    bidx = jnp.arange(B)[:, None]
    for p0 in (7, 2, 12):
        q_pos = np.broadcast_to(p0 + np.arange(S, dtype=np.int32), (B, S))
        tkv = torch.from_numpy(kv.copy())
        tcache.append_kv_pos(tkv, p0, torch.from_numpy(valid))
        np.testing.assert_array_equal(tkv.numpy(), np.asarray(jcache.append_kv_pos(
            jnp.asarray(kv), jnp.asarray(q_pos), jnp.asarray(valid))))
        tk = torch.from_numpy(ck.copy())
        tcache.write_chunk(tk, torch.from_numpy(new), p0)
        want = jnp.asarray(ck).at[bidx, jnp.asarray(q_pos)].set(jnp.asarray(new), mode="drop")
        np.testing.assert_array_equal(tk.numpy(), np.asarray(want))

    n = np.asarray([0, 4, 10], np.int32)
    np.testing.assert_array_equal(
        tcache.trim_kv_pos(torch.from_numpy(kv), torch.from_numpy(n)).numpy(),
        np.asarray(jcache.trim_kv_pos(jnp.asarray(kv), jnp.asarray(n))))
    one = {"k": torch.from_numpy(ck[:1]), "v": torch.from_numpy(ck[:1]),
           "kv_pos": torch.from_numpy(kv[:1])}
    jone = {"k": jnp.asarray(ck[:1]), "v": jnp.asarray(ck[:1]), "kv_pos": jnp.asarray(kv[:1])}
    got = tcache.trim_cache_prefix([one], 6)[0]
    assert got["k"] is one["k"] and got["kv_pos"] is not one["kv_pos"]
    np.testing.assert_array_equal(got["kv_pos"].numpy(),
                                  np.asarray(jcache.trim_cache_prefix([jone], 6)[0]["kv_pos"]))
    np.testing.assert_array_equal(tcache.prefill_kv_pos(2, T, 7).numpy(),
                                  np.asarray(jcache.prefill_kv_pos(2, T, 7, ring=False)))


@pytest.fixture(params=["tiny_gqa", "paper_mha"])
def jcfg(request, tiny_dense_cfg):
    return tiny_dense_cfg if request.param == "tiny_gqa" else JAX_PAPER.reduced()


def _assert_caches(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **KV_TOL)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_dense_prefill_append_decode_match_jax(jcfg, impl):
    """A bucketed prefill of 21 tokens (bucket 24), a chunk append of 13
    more at p0 21 padded to 16, a second append of 4 at p0 34 padded to 16
    — its padding runs past max_len 48, so those writes drop — then 12
    greedy decode steps (the last ones at positions past the cache clamp
    to its last slot, as in JAX). Every logit, token and cache agrees."""
    jc = jcfg.replace(attn_impl="reference" if impl == "reference" else "pallas")
    tc = tcfg_of(jcfg, "reference" if impl == "reference" else "cuda")
    jparams, tree = bridged_params(jcfg)
    tparams = params_from_numpy(tree, tc, device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(1, jc.vocab_size, size=38).astype(np.int32)

    toks = np.zeros((1, 24), np.int32)
    toks[0, :21] = ids[:21]
    tl = np.asarray([21], np.int32)
    jl, jcaches, jpos = jax.jit(lambda p, t, n: jax_prefill(p, jc, t, max_len=MAX_LEN, true_len=n))(
        jparams, jnp.asarray(toks), jnp.asarray(tl))
    tl_, tcaches, tpos = prefill(tparams, tc, torch.from_numpy(toks), max_len=MAX_LEN,
                                 true_len=torch.from_numpy(tl))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert int(tpos[0]) == int(jpos[0]) == 21
    _assert_caches(tcaches, jcaches)

    jappend = jax.jit(lambda p, c, t, p0, n: jax_prefill_append(p, jc, c, t, p0, true_len=n))
    for start, stop in ((21, 34), (34, 38)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, : stop - start] = ids[start:stop]
        n = np.asarray([stop - start], np.int32)
        jl, jcaches, jpos = jappend(jparams, jcaches, jnp.asarray(toks), jpos, jnp.asarray(n))
        tl_, tcaches, tpos = prefill_append(tparams, tc, tcaches, torch.from_numpy(toks), start,
                                            torch.from_numpy(n))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _assert_caches(tcaches, jcaches)

    jdecode = jax.jit(lambda p, c, t, pos: jax_decode_step(p, jc, c, t, pos))
    jtok = ttok = int(np.asarray(jl)[0].argmax())
    for step in range(12):
        pos = np.asarray([38 + step], np.int32)
        jlog, jcaches = jdecode(jparams, jcaches, jnp.asarray([[jtok]], jnp.int32), jnp.asarray(pos))
        tlog, tcaches = decode_step(tparams, tc, tcaches, torch.tensor([[ttok]], dtype=torch.int32),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        jtok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert jtok == ttok, (step, jtok, ttok)
    _assert_caches(tcaches, jcaches)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_forward_full_and_batched_decode_match_jax(tiny_dense_cfg, impl):
    """forward_full with ragged seq_valid (K4 over a whole sequence), and a
    B = 3 decode step from empty caches where one lane sits at a stale
    position (the full-width server's empty lanes)."""
    jcfg = tiny_dense_cfg
    jc = jcfg.replace(attn_impl="reference" if impl == "reference" else "pallas")
    tc = tcfg_of(jcfg, "reference" if impl == "reference" else "cuda")
    jparams, tree = bridged_params(jcfg, seed=3)
    tparams = params_from_numpy(tree, tc, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jc.vocab_size, size=(2, 19)).astype(np.int32)
    sv = np.arange(19)[None, :] < np.asarray([19, 11])[:, None]
    jlog, _ = jax_forward_full(jparams, jc, jnp.asarray(toks), seq_valid=jnp.asarray(sv))
    tlog, aux = forward_full(tparams, tc, torch.from_numpy(toks), seq_valid=torch.from_numpy(sv))
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], **LOGIT_TOL)

    from repro.models import make_decode_caches as jax_make_caches

    jcaches = jax_make_caches(jc, 3, 16)
    tcaches = make_decode_caches(tc, 3, 16, device="cpu")
    _assert_caches(tcaches, jcaches)
    for step in range(3):
        pos = np.asarray([step, 7, 15 + step], np.int32)
        tok = rng.integers(1, jc.vocab_size, size=(3, 1)).astype(np.int32)
        jlog, jcaches = jax_decode_step(jparams, jc, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tcaches = decode_step(tparams, tc, tcaches, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)
