"""Checks shared by the port's per-model tests (``test_torch_chatglm3.py``,
``test_torch_qwen2_vl.py``, ``test_torch_gemma2.py``): one reduced config,
JAX's weights bridged into the port, and the same inputs through the model
functions and the serving routes of both packages. The port runs its plain
path (``attn_impl="reference"``) or its kernel path (``"cuda"``: on CPU
tensors every kernel wrapper runs its plain version); JAX runs its
reference path. f32 logits agree within ``LOGIT_TOL`` and greedy tokens are
identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import decode_step as jax_decode_step
from repro.models import decode_step_paged as jax_decode_step_paged
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
    params_from_numpy,
    prefill,
    prefill_append,
    prefill_chunk_paged,
)
from repro_torch.models.cache import init_paged_pool
from repro_torch.serving import BatchedServer, InferenceEngine, SessionCachePool

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = ("reference", "cuda")
FIELDS = ("token_ids", "cache_hit", "reused_tokens", "prefill_tokens")


_JITTED = {}


def jitted(name, jcfg):
    """One jitted JAX model function per (function, config), shared by the
    tests of a module, so that a test's plain and kernel variants compile
    JAX's side once."""
    key = (name, jcfg)
    if key not in _JITTED:
        fn = {
            "decode": lambda p, c, t, pos: jax_decode_step(p, jcfg, c, t, pos),
            "append": lambda p, c, t, p0, n: jax_prefill_append(p, jcfg, c, t, p0, true_len=n),
            "chunk": lambda p, pools, t, toks, p0, n: jax_prefill_chunk_paged(
                p, jcfg, pools, t, toks, p0, n),
            "decode_paged": lambda p, pools, t, kv, tok, pos: jax_decode_step_paged(
                p, jcfg, pools, t, kv, tok, pos),
        }[name]
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def tcfg_of(jcfg, attn_impl="cuda"):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=attn_impl)


def bridged(jcfg, seed=0):
    """JAX ``init_params`` as numpy f32 with every norm and qkv bias (zeros
    at init) perturbed by seeded noise, else a norm or bias bug would be
    invisible; returns (jax params, numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def perturb(node):
        for name, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif "norm" in name or name in ("bq", "bk", "bv"):
                node[name] = v + 0.1 * rng.standard_normal(v.shape)

    perturb(tree)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def torch_params(tree, tcfg):
    return params_from_numpy(tree, tcfg, device="cpu")


def assert_caches(tcaches, jcaches):
    """Caches equal leaf for leaf: kv_pos exactly, K/V within KV_TOL (a
    gemma pair's cache nests its local and global dicts)."""
    for tc, jc in zip(tcaches, jcaches):
        for name, t in tc.items():
            if isinstance(t, dict):
                assert_caches([t], [jc[name]])
            elif name == "kv_pos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(jc[name]))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(jc[name]), **KV_TOL)


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **LOGIT_TOL)


def decode_greedy(jparams, jcfg, tparams, tcfg, jcaches, tcaches, tok, p0, n_steps):
    """``n_steps`` greedy decode steps from position ``p0`` in both
    packages: logits within LOGIT_TOL, tokens identical; returns the caches
    and the tokens."""
    jdecode = jitted("decode", jcfg)
    toks = []
    for step in range(n_steps):
        pos = np.asarray([p0 + step], np.int32)
        jlog, jcaches = jdecode(jparams, jcaches, jnp.asarray([[tok]], jnp.int32),
                                jnp.asarray(pos))
        tlog, tcaches = decode_step(tparams, tcfg, tcaches,
                                    torch.tensor([[tok]], dtype=torch.int32),
                                    torch.from_numpy(pos))
        close(tlog, jlog)
        tok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert tok == ttok, (step, tok, ttok)
        toks.append(tok)
    return jcaches, tcaches, toks


def check_dense_functions(jcfg, impl, max_len=64):
    """A bucketed prefill of 21 tokens (bucket 24), chunk appends of 13 and
    4 tokens (the second's padding runs past ``max_len`` 48, so its writes
    drop), then 10 greedy decode steps: logits, tokens and caches equal
    JAX's."""
    tc = tcfg_of(jcfg, impl)
    jparams, tree = bridged(jcfg)
    tparams = torch_params(tree, tc)
    ids = np.random.default_rng(2).integers(1, jcfg.vocab_size, size=38).astype(np.int32)
    toks = np.zeros((1, 24), np.int32)
    toks[0, :21] = ids[:21]
    tl = np.asarray([21], np.int32)
    jl, jcaches, jpos = jax_prefill(jparams, jcfg, jnp.asarray(toks), max_len=max_len,
                                    true_len=jnp.asarray(tl))
    tl_, tcaches, tpos = prefill(tparams, tc, torch.from_numpy(toks), max_len=max_len,
                                 true_len=torch.from_numpy(tl))
    close(tl_, jl)
    assert int(tpos[0]) == int(jpos[0]) == 21
    assert_caches(tcaches, jcaches)
    jappend = jitted("append", jcfg)
    for start, stop in ((21, 34), (34, 38)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, : stop - start] = ids[start:stop]
        n = np.asarray([stop - start], np.int32)
        jl, jcaches, jpos = jappend(jparams, jcaches, jnp.asarray(toks), jpos, jnp.asarray(n))
        tl_, tcaches, tpos = prefill_append(tparams, tc, tcaches, torch.from_numpy(toks), start,
                                            torch.from_numpy(n))
        close(tl_, jl)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert_caches(tcaches, jcaches)
    jcaches, tcaches, _ = decode_greedy(jparams, jcfg, tparams, tc, jcaches, tcaches,
                                        int(np.asarray(jl)[0].argmax()), 38, 10)
    assert_caches(tcaches, jcaches)


def check_paged_functions(jcfg, impl, ps=8, mp=8, n_pages=12):
    """Two paged prefill chunks (the second from mid-page) through a
    scattered page table, then 12 greedy paged decode steps: logits,
    tokens, pools and kv_pos equal JAX's."""
    tc = tcfg_of(jcfg, impl)
    jparams, tree = bridged(jcfg, seed=1)
    tparams = torch_params(tree, tc)
    jpools = [jax_init_paged_pool(jcfg, jcfg.n_layers, n_pages, ps)]
    tpools = [init_paged_pool(tc, tc.n_layers, n_pages, ps)]
    table = np.asarray([[3, 7, 1, 9, 2, 11, 5, 4]], np.int32)[:, :mp]
    ids = np.random.default_rng(1).integers(1, jcfg.vocab_size, size=37).astype(np.int32)
    jchunk = jitted("chunk", jcfg)
    for start, stop, width in ((0, 21, 24), (21, 37, 16)):
        toks = np.zeros((1, width), np.int32)
        toks[0, : stop - start] = ids[start:stop]
        p0, n = np.asarray([start], np.int32), np.asarray([stop - start], np.int32)
        jl, jpools = jchunk(jparams, jpools, jnp.asarray(table), jnp.asarray(toks),
                            jnp.asarray(p0), jnp.asarray(n))
        tl_ = prefill_chunk_paged(tparams, tc, tpools, torch.from_numpy(table),
                                  torch.from_numpy(toks), torch.from_numpy(p0),
                                  torch.from_numpy(n))
        close(tl_, jl)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[0][name].numpy(), np.asarray(jpools[0][name]),
                                   **KV_TOL)
    n = len(ids)
    kv_np = np.where(np.arange(mp * ps) < n, np.arange(mp * ps), -1).astype(np.int32)[None]
    jkv, tkv = jnp.asarray(kv_np), torch.from_numpy(kv_np.copy())
    jdecode = jitted("decode_paged", jcfg)
    tok = int(np.asarray(jl)[0].argmax())
    for step in range(12):
        pos = np.asarray([n + step], np.int32)
        jlog, jpools, jkv = jdecode(jparams, jpools, jnp.asarray(table), jkv,
                                    jnp.asarray([[tok]], jnp.int32), jnp.asarray(pos))
        tlog = decode_step_paged(tparams, tc, tpools, torch.from_numpy(table), tkv,
                                 torch.tensor([[tok]], dtype=torch.int32), torch.from_numpy(pos))
        close(tlog, jlog)
        tok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert tok == ttok, (step, tok, ttok)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))


def engines(jcfg, max_len, **kw):
    """JAX's engine and the port's over the same weights (the port on its
    kernel path)."""
    jeng = JaxEngine.create(jcfg, seed=0, max_len=max_len, **kw)
    tcfg = tcfg_of(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = InferenceEngine.create(tcfg, max_len=max_len, device="cpu", params=torch_params(
        tree, tcfg), **kw)
    return jeng, teng


def check_engine_turns(jcfg, route, max_len=512, ps=16, kv_pages=96):
    """Two sessions x 2 turns sharing a 40-token system prompt, and a
    keyless turn: tokens, session hits, reused and prefilled tokens equal
    JAX's turn for turn."""
    kw = dict(page_size=ps, kv_pages=kv_pages) if route == "paged" else {}
    jeng, teng = engines(jcfg, max_len, **kw)
    rng = np.random.default_rng(0)
    system = rng.integers(8, jcfg.vocab_size, size=40).tolist()
    hist = {"A": list(system), "B": list(system)}
    for turn in range(2):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, jcfg.vocab_size, size=11 + 5 * turn).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            for f in FIELDS:
                assert getattr(t, f) == getattr(j, f), (route, turn, key, f)
            hist[key] += j.token_ids
    ids = rng.integers(8, jcfg.vocab_size, size=29).tolist()
    assert teng.generate(ids, max_new_tokens=6) == jeng.generate(ids, max_new_tokens=6)
    return jeng, teng


def batched_servers(jcfg, paged, n_slots=3, max_len=512, ps=16):
    jparams = jax_init_params(jax.random.key(1), jcfg)
    tcfg = tcfg_of(jcfg)
    tparams = torch_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    kw = dict(n_slots=n_slots, max_len=max_len, paged=paged, page_size=ps)
    jsrv = JaxBatchedServer(jcfg, jparams, session_pool=JaxPool(capacity=8), **kw)
    tsrv = BatchedServer(tcfg, tparams, session_pool=SessionCachePool(capacity=8),
                         device="cpu", **kw)
    return jsrv, tsrv


def check_batched_wave(jcfg, paged, pooled=True):
    """Four tenants sharing a system prompt on three slots, then their
    second turns (session hits, or with ``pooled`` False — a model whose
    caches are not pooled — full prefills again): tokens, hits and reuse
    equal JAX's, and on the paged server the shared hits and pages too."""
    jsrv, tsrv = batched_servers(jcfg, paged)
    rng = np.random.default_rng(3)
    system = rng.integers(8, jcfg.vocab_size, size=50).tolist()
    reqs = [system + rng.integers(8, jcfg.vocab_size, size=3 + 2 * i).tolist()
            for i in range(4)]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        res, wave = [], reqs
        for _ in range(2):
            rids = [srv.submit(list(r), max_new=6, cache_key=f"t{i}")
                    for i, r in enumerate(wave)]
            fin = {f.request_id: f for f in srv.run_to_completion()}
            srv.finished.clear()
            res += [(fin[r].token_ids, fin[r].cache_hit, fin[r].reused_tokens) for r in rids]
            wave = [r + fin[rid].token_ids + [9] for r, rid in zip(wave, rids)]
        pages = srv.allocator.used_pages if paged else None
        out[name] = (res, srv.session_pool.shared_hits, pages)
    assert out["torch"] == out["jax"]
    assert all(bool(hit) == pooled for _, hit, _ in out["torch"][0][4:])
    if paged:
        assert out["torch"][1] > 0


def check_launcher(arch, monkeypatch, capsys, kv_heads):
    """``launch.serve --arch <arch> --device cpu`` gives each node its own
    kernel-route service of the reduced model and answers every turn of a
    roaming session."""
    from repro_torch import serving
    from repro_torch.launch import serve

    made = []
    create = serving.TorchLLMService.create

    def recording_create(model, cfg, **kw):
        made.append((cfg.name, cfg.attn_impl, cfg.n_kv_heads))
        return create(model, cfg, **kw)

    monkeypatch.setattr(serving.TorchLLMService, "create", staticmethod(recording_create))
    serve.main(["--arch", arch, "--device", "cpu", "--turns", "3", "--roam"])
    assert made == [(f"{arch}-smoke", "cuda", kv_heads)] * 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:4]] == ["edge-0", "edge-0", "edge-1"]
    assert lines[-1].startswith("sync=")
