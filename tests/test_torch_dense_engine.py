"""The dense route of the port's ``InferenceEngine`` against the JAX
engine, token for token with the same ``GenerateResult`` accounting, with
the same (bridged) weights: keyed multi-turn sessions on a dense session
pool (``page_size=0``, the JAX default), keyless turns, a resend (ids that
stop inside the stored prefix) followed by the original continuation, and
the page-exhaustion fallback of a paged engine (``paged_fallbacks``, a
dense cache stored into pages, a paged entry materialised). Then a
``TorchLLMService`` with ``kv_reuse=False`` and one with a dense pool,
mounted on a JAX ``EdgeCluster``, give the all-JAX transcripts. The port
runs its kernel path (K4/K5's plain versions on CPU tensors); JAX runs its
reference path, which its own tests hold token-identical to its Pallas
path."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.edge import EdgeCluster
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import JaxLLMService
from repro_torch.serving import InferenceEngine, TorchLLMService
from test_torch_engine import FIELDS, _roam, _tcfg, _torch_params

MAX_LEN = 256


def _pair(jcfg, **kw):
    jeng = JaxEngine.create(jcfg, seed=0, max_len=MAX_LEN, **kw)
    tcfg = _tcfg(jcfg)
    teng = InferenceEngine.create(tcfg, max_len=MAX_LEN, device="cpu",
                                  params=_torch_params(jeng.params, tcfg), **kw)
    return jeng, teng


def _same(t, j, where):
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (where, f, getattr(t, f), getattr(j, f))


def test_dense_pool_sessions_keyless_and_resend_match_jax(tiny_dense_cfg):
    """Two sessions x 3 turns on a dense pool (turns 2-3 hit and prefill
    only the suffix; the 4-entry pool keeps both), keyless turns between
    them, then a resend of a prefix of session A's history (usable <
    entry.pos: the stored cache is trimmed on a copy) and the original
    continuation after it."""
    jeng, teng = _pair(tiny_dense_cfg)
    assert teng.session_pool.allocator is None
    rng = np.random.default_rng(0)
    V = tiny_dense_cfg.vocab_size
    hist = {"A": rng.integers(8, V, size=30).tolist(), "B": rng.integers(8, V, size=45).tolist()}
    last = {}
    for turn in range(3):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, V, size=7 + 6 * turn).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=9, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=9, cache_key=key)
            _same(t, j, (turn, key))
            assert t.cache_hit == (turn > 0)
            if turn:
                assert t.prefill_tokens == 7 + 6 * turn
            last[key] = (list(hist[key]), j.token_ids)
            hist[key] += j.token_ids
        ids = rng.integers(8, V, size=20 + 9 * turn).tolist()
        j, t = jeng.generate_ex(ids, max_new_tokens=6), teng.generate_ex(ids, max_new_tokens=6)
        _same(t, j, (turn, "keyless"))
        assert not t.cache_hit and t.prefill_tokens == len(ids)

    # the client resends A's last request: its ids stop inside the stored
    # prefix, the stored cache is trimmed (on a copy) and the same answer
    # comes back
    resend, answer = last["A"]
    j = jeng.generate_ex(resend, max_new_tokens=9, cache_key="A")
    t = teng.generate_ex(resend, max_new_tokens=9, cache_key="A")
    _same(t, j, "resend")
    assert t.cache_hit and t.reused_tokens == len(resend) - 1
    assert t.token_ids == answer
    cont = hist["A"] + rng.integers(8, V, size=5).tolist()
    j = jeng.generate_ex(cont, max_new_tokens=9, cache_key="A")
    t = teng.generate_ex(cont, max_new_tokens=9, cache_key="A")
    _same(t, j, "continuation")
    assert t.cache_hit and t.reused_tokens == len(hist["A"])
    assert teng.session_pool.stats() == jeng.session_pool.stats()


def test_page_exhaustion_falls_back_to_dense_like_jax(tiny_dense_cfg):
    """A paged engine with 8 pages of 16: session A's second turn needs
    more fresh pages than the pool can give while A's own entry is pinned,
    so it leaves the paged route (``paged_fallbacks``), materialises A's
    pages, decodes dense and stores the cache back into pages; later turns
    go paged again or fall back exactly as JAX's do."""
    jeng, teng = _pair(tiny_dense_cfg, page_size=16, kv_pages=9)
    rng = np.random.default_rng(1)
    V = tiny_dense_cfg.vocab_size
    hist = {"A": rng.integers(8, V, size=50).tolist(), "B": rng.integers(8, V, size=20).tolist()}
    for key, new, gen in (("A", 0, 6), ("B", 0, 4), ("A", 65, 6), ("B", 10, 4), ("A", 5, 3)):
        hist[key] += rng.integers(8, V, size=new).tolist()
        j = jeng.generate_ex(hist[key], max_new_tokens=gen, cache_key=key)
        t = teng.generate_ex(hist[key], max_new_tokens=gen, cache_key=key)
        _same(t, j, (key, len(hist[key])))
        assert teng.paged_fallbacks == jeng.paged_fallbacks
        hist[key] += j.token_ids
    assert teng.paged_fallbacks >= 1
    assert teng.session_pool.stats() == jeng.session_pool.stats()
    alloc = teng.session_pool.allocator
    assert alloc.used_pages == jeng.session_pool.allocator.used_pages
    # keyless turns on a paged engine take the dense route without a fallback
    ids = rng.integers(8, V, size=33).tolist()
    j, t = jeng.generate_ex(ids, max_new_tokens=5), teng.generate_ex(ids, max_new_tokens=5)
    _same(t, j, "keyless")
    assert teng.paged_fallbacks == jeng.paged_fallbacks


def test_dense_prime_matches_jax(tiny_dense_cfg):
    """The migration warm start on a dense pool: a prime from tokens, an
    extension of it, and the primed session's turn (a "tokens" warm start
    prefilling only the new prompt)."""
    jeng, teng = _pair(tiny_dense_cfg)
    rng = np.random.default_rng(2)
    V = tiny_dense_cfg.vocab_size
    ctx = rng.integers(8, V, size=40).tolist()
    assert jeng.prime("k", ctx) and teng.prime("k", ctx)
    ctx2 = ctx + rng.integers(8, V, size=12).tolist()
    assert jeng.prime("k", ctx2) and teng.prime("k", ctx2)
    assert teng.prime_count == jeng.prime_count == 2
    ids = ctx2 + rng.integers(8, V, size=6).tolist()
    j = jeng.generate_ex(ids, max_new_tokens=7, cache_key="k")
    t = teng.generate_ex(ids, max_new_tokens=7, cache_key="k")
    _same(t, j, "primed")
    assert t.warm_start and t.warm_source == "tokens" and t.prefill_tokens == 6


@pytest.mark.parametrize("kv_reuse", [False, True], ids=["no_reuse", "dense_pool"])
def test_dense_services_roam_in_jax_cluster(kv_reuse):
    """A client roams edge-a -> edge-b -> edge-a on a JAX EdgeCluster whose
    nodes mount a dense-route TorchLLMService (the paper's kv_reuse=False
    service, and the default dense pool); the transcripts and the KV
    accounting equal the all-JAX cluster's."""
    jcfg = JAX_PAPER.reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = _tcfg(jcfg)
    tparams = _torch_params(jparams, tcfg)
    jax_cluster = EdgeCluster.build(
        ["a", "b"], lambda nid: JaxLLMService.create("m", jcfg, seed=0, max_len=MAX_LEN,
                                                     kv_reuse=kv_reuse))
    torch_cluster = EdgeCluster.build(
        ["a", "b"], lambda nid: TorchLLMService.create("m", tcfg, max_len=MAX_LEN,
                                                       kv_reuse=kv_reuse, device="cpu",
                                                       params=tparams))
    svc = torch_cluster.node("a").service
    assert svc.capabilities().kv_reuse == svc.capabilities().prime == kv_reuse
    want, got = _roam(jax_cluster), _roam(torch_cluster)
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.n_generated_tokens for r in got] == [r.n_generated_tokens for r in want]
    for g, w in zip(got, want):
        for f in ("kv_cache_hit", "kv_reused_tokens", "kv_warm_start", "kv_warm_source"):
            assert getattr(g.timing, f) == getattr(w.timing, f), f
    assert got[2].timing.kv_cache_hit == kv_reuse
