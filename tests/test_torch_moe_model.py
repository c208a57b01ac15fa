"""The port's MoE decoders against the JAX package: granite-moe-3b-a800m
and dbrx-132b ``.reduced()`` (2 layers, 4 experts, top 2, capacity factor
1.25 as configured) with bridged weights, in f32.

- the model functions: ``forward_full`` (logits and the summed aux loss),
  a bucketed ``prefill`` then ``decode_step``, ``prefill_append``, and
  ``prefill_chunk_paged`` then ``decode_step_paged`` — logits within 1e-4
  (K/V caches and pools within 1e-5) and greedy tokens identical;
- the engines: turns on the paged and the dense route, and a wave through
  the paged batched server, with greedy tokens and reuse counts identical
  to JAX's.

A prompt of one repeated token makes every row of the first layer equal,
so every row picks the same two experts and their capacity overflows:
those runs drop tokens, and the same ones as JAX, bucket padding and idle
decode lanes included (the capacity is taken over every row a call
passes). JAX runs its reference path and its Pallas kernels in interpret
mode; the port its reference path and its kernel path (plain versions on
CPU tensors). ``max_len`` is 512 (JAX's R1 fault, ROADMAP Queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dbrx_132b import CONFIG as JAX_DBRX
from repro.configs.granite_moe_3b_a800m import CONFIG as JAX_GRANITE
from repro.models import decode_step as jax_decode_step
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import forward_full as jax_forward_full
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import prefill_append as jax_prefill_append
from repro.models import prefill_chunk_paged as jax_prefill_chunk_paged
from repro.models.cache import init_paged_pool as jax_init_paged_pool
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro.serving.session_cache import SessionCachePool as JaxPool
from repro_torch.models import (
    ModelConfig,
    decode_step,
    decode_step_paged,
    forward_full,
    layer_groups,
    params_from_numpy,
    prefill,
    prefill_append,
    prefill_chunk_paged,
    supports_append,
)
from repro_torch.models import moe as tmoe
from repro_torch.models.cache import init_paged_pool
from repro_torch.serving import BatchedServer, InferenceEngine, SessionCachePool

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
MAX_LEN, PS, KV_PAGES = 512, 16, 96
FIELDS = ("token_ids", "cache_hit", "reused_tokens", "prefill_tokens")


# granite on both of the port's paths; dbrx (the same layer shapes once
# reduced) on the kernel path only, to keep the file quick
CASES = pytest.mark.parametrize("jcfg,impl", [
    (JAX_GRANITE.reduced(), "reference"), (JAX_GRANITE.reduced(), "kernel"),
    (JAX_DBRX.reduced(), "kernel")], ids=["granite-reference", "granite-kernel", "dbrx-kernel"])


def _tcfg(jcfg, impl):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=impl)


def _bridged(jcfg, seed=0):
    """JAX weights, with the zero-initialised norms perturbed by seeded
    noise; returns (jax params, numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    g = tree["groups"][0]
    for name in ("norm1", "norm2"):
        g[name] += 0.1 * rng.standard_normal(g[name].shape).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _impls(jcfg, impl):
    jc = jcfg.replace(attn_impl="reference" if impl == "reference" else "pallas")
    return jc, _tcfg(jcfg, "reference" if impl == "reference" else "cuda")


@pytest.fixture
def drops(monkeypatch):
    """Count the (token, choice) pairs the port's dispatch drops."""
    seen = []
    real = tmoe._dispatch_plan

    def plan(top_idx, e, cap):
        dest = real(top_idx, e, cap)
        seen.append(int((dest == e * cap).sum()))
        return dest

    monkeypatch.setattr(tmoe, "_dispatch_plan", plan)
    return seen


def test_moe_groups_and_append_support():
    for base in (JAX_GRANITE, JAX_DBRX):
        for cfg in (base, base.reduced()):
            tcfg = _tcfg(cfg, "cuda")
            assert [(s.kind, s.n_blocks) for s in layer_groups(tcfg)] == [("moe", cfg.n_layers)]
            assert supports_append(tcfg)


@CASES
def test_forward_full_matches_jax(jcfg, impl, drops):
    """Logits (with ragged ``seq_valid``) and the aux loss summed over the
    layers; the repeated-token row drops tokens in both."""
    jc, tc = _impls(jcfg, impl)
    jparams, tree = _bridged(jcfg)
    tparams = params_from_numpy(tree, tc, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jc.vocab_size, size=(2, 40)).astype(np.int32)
    toks[1] = 7
    sv = np.arange(40)[None, :] < np.asarray([40, 29])[:, None]
    jlog, jaux = jax_forward_full(jparams, jc, jnp.asarray(toks), seq_valid=jnp.asarray(sv))
    tlog, taux = forward_full(tparams, tc, torch.from_numpy(toks), seq_valid=torch.from_numpy(sv))
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], **LOGIT_TOL)
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert sum(drops) > 0


def _assert_caches(tcaches, jcaches):
    for tc, jc in zip(tcaches, jcaches):
        np.testing.assert_array_equal(tc["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **KV_TOL)


@CASES
def test_prefill_append_decode_match_jax(jcfg, impl, drops):
    """A bucketed prefill of 45 repeated tokens (bucket 48: the padding
    rows take expert capacity too), an append of 13 at p0 45 padded to
    16, then 10 greedy decode steps: logits, tokens and caches agree."""
    jc, tc = _impls(jcfg, impl)
    jparams, tree = _bridged(jcfg, seed=1)
    tparams = params_from_numpy(tree, tc, device="cpu")
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.full(45, 11), rng.integers(1, jc.vocab_size, size=13)])
    ids = ids.astype(np.int32)
    toks = np.zeros((1, 48), np.int32)
    toks[0, :45] = ids[:45]
    tl = np.asarray([45], np.int32)
    jl, jcaches, jpos = jax_prefill(jparams, jc, jnp.asarray(toks), max_len=64,
                                    true_len=jnp.asarray(tl))
    tl_, tcaches, tpos = prefill(tparams, tc, torch.from_numpy(toks), max_len=64,
                                 true_len=torch.from_numpy(tl))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)
    assert sum(drops) > 0

    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = ids[45:]
    n = np.asarray([13], np.int32)
    jl, jcaches, jpos = jax_prefill_append(jparams, jc, jcaches, jnp.asarray(toks), jpos,
                                           true_len=jnp.asarray(n))
    tl_, tcaches, tpos = prefill_append(tparams, tc, tcaches, torch.from_numpy(toks), 45,
                                        torch.from_numpy(n))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _assert_caches(tcaches, jcaches)

    jdecode = jax.jit(lambda p, c, t, q: jax_decode_step(p, jc, c, t, q))
    jtok = ttok = int(np.asarray(jl)[0].argmax())
    for step in range(10):
        pos = np.asarray([58 + step], np.int32)
        jlog, jcaches = jdecode(jparams, jcaches, jnp.asarray([[jtok]], jnp.int32),
                                jnp.asarray(pos))
        tlog, tcaches = decode_step(tparams, tc, tcaches, torch.tensor([[ttok]], dtype=torch.int32),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        jtok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert jtok == ttok, (step, jtok, ttok)
    _assert_caches(tcaches, jcaches)


@CASES
def test_paged_chunks_and_decode_match_jax(jcfg, impl, drops):
    """Two chunks into pages (40 repeated tokens in a 64-row bucket, then
    13 more at p0 40), then 10 greedy paged decode steps over B = 2 lanes,
    the second lane idle at a position past the table (its writes drop,
    its row still reaches the experts, as in the batched server)."""
    jc, tc = _impls(jcfg, impl)
    jparams, tree = _bridged(jcfg, seed=2)
    tparams = params_from_numpy(tree, tc, device="cpu")
    n_pages, mp = 12, 8
    jpools = [jax_init_paged_pool(jc, jc.n_layers, n_pages, 8)]
    tpools = [init_paged_pool(tc, tc.n_layers, n_pages, 8)]
    table_np = np.asarray([[3, 7, 1, 9, 2, 11, 5, 4]], np.int32)
    rng = np.random.default_rng(3)
    ids = np.concatenate([np.full(40, 5), rng.integers(1, jc.vocab_size, size=13)]).astype(np.int32)
    for start, stop, width in ((0, 40, 64), (40, 53, 16)):
        toks = np.zeros((1, width), np.int32)
        toks[0, : stop - start] = ids[start:stop]
        args = (np.asarray([start], np.int32), np.asarray([stop - start], np.int32))
        jl, jpools = jax_prefill_chunk_paged(jparams, jc, jpools, jnp.asarray(table_np),
                                             jnp.asarray(toks), *map(jnp.asarray, args))
        tl_ = prefill_chunk_paged(tparams, tc, tpools, torch.from_numpy(table_np),
                                  torch.from_numpy(toks), *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[0][name].numpy(), np.asarray(jpools[0][name]), **KV_TOL)
    assert sum(drops) > 0

    table2 = np.concatenate([table_np, np.zeros_like(table_np)])
    n = len(ids)
    kv_np = np.where(np.arange(mp * 8) < n, np.arange(mp * 8), -1).astype(np.int32)
    kv_np = np.stack([kv_np, np.full_like(kv_np, -1)])
    jkv, tkv = jnp.asarray(kv_np), torch.from_numpy(kv_np.copy())
    jdecode = jax.jit(lambda p, pools, t, kv, tok, q: jax_decode_step_paged(
        p, jc, pools, t, kv, tok, q))
    jtok = ttok = int(np.asarray(jl)[0].argmax())
    for step in range(10):
        pos = np.asarray([n + step, mp * 8], np.int32)
        jlog, jpools, jkv = jdecode(jparams, jpools, jnp.asarray(table2), jkv,
                                    jnp.asarray([[jtok], [3]], jnp.int32), jnp.asarray(pos))
        tlog = decode_step_paged(tparams, tc, tpools, torch.from_numpy(table2), tkv,
                                 torch.tensor([[ttok], [3]], dtype=torch.int32),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy()[0], np.asarray(jlog)[0], **LOGIT_TOL)
        jtok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert jtok == ttok, (step, jtok, ttok)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))


# -- engines ---------------------------------------------------------------

def _engines(jcfg, **kw):
    jeng = JaxEngine.create(jcfg, seed=0, max_len=MAX_LEN, **kw)
    tcfg = _tcfg(jcfg, "cuda")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jeng.params), tcfg,
                                device="cpu")
    return jeng, InferenceEngine.create(tcfg, max_len=MAX_LEN, device="cpu", params=tparams, **kw)


@pytest.mark.parametrize("route", ["paged", "dense"])
def test_engine_turns_match_jax(route, drops):
    """Reduced granite, two sessions x 2 turns and a keyless turn, on the
    paged route (K3 + K1's plain versions) or the dense route (K4 + K5's):
    session B opens with 70 repeated tokens (drops in its prefill); tokens
    and reuse counts equal JAX's turn for turn."""
    kw = dict(page_size=PS, kv_pages=KV_PAGES) if route == "paged" else {}
    jeng, teng = _engines(JAX_GRANITE.reduced(), **kw)
    rng = np.random.default_rng(0)
    V = JAX_GRANITE.reduced().vocab_size
    hist = {"A": rng.integers(8, V, size=37).tolist(), "B": [9] * 70}
    for turn in range(2):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, V, size=9 + 4 * turn).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            for f in FIELDS:
                assert getattr(t, f) == getattr(j, f), (route, turn, key, f)
            assert t.cache_hit == (turn > 0)
            hist[key] += j.token_ids
    ids = rng.integers(8, V, size=30).tolist()
    assert teng.generate(ids, max_new_tokens=6) == jeng.generate(ids, max_new_tokens=6)
    assert sum(drops) > 0


def test_batched_wave_matches_jax(drops):
    """Reduced dbrx on the paged batched server: four tenants share a
    52-token system prompt on three slots (the cascade branch), then their
    second turns: the same tokens, reuse and sharing as JAX's server."""
    jcfg = JAX_DBRX.reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = _tcfg(jcfg, "cuda")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    kw = dict(n_slots=3, max_len=MAX_LEN, paged=True, page_size=PS)
    jsrv = JaxBatchedServer(jcfg, jparams, session_pool=JaxPool(capacity=8), **kw)
    tsrv = BatchedServer(tcfg, tparams, session_pool=SessionCachePool(capacity=8), device="cpu",
                         **kw)
    rng = np.random.default_rng(5)
    system = [4] * 20 + rng.integers(8, jcfg.vocab_size, size=32).tolist()
    reqs = [system + rng.integers(8, jcfg.vocab_size, size=4 + 3 * i).tolist() for i in range(4)]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        res, wave = [], reqs
        for _ in range(2):
            rids = [srv.submit(list(r), max_new=6, cache_key=f"t{i}") for i, r in enumerate(wave)]
            fin = {f.request_id: f for f in srv.run_to_completion()}
            srv.finished.clear()
            res += [(fin[r].token_ids, fin[r].cache_hit, fin[r].reused_tokens) for r in rids]
            wave = [r + fin[rid].token_ids + [7, 8] for r, rid in zip(wave, rids)]
        out[name] = (res, srv.session_pool.shared_hits, srv.allocator.used_pages)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] > 0
    assert all(hit for _, hit, _ in out["torch"][0][4:])
