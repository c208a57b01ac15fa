"""The port's public serving API against the JAX package's, argument for
argument: ``share_prefixes`` on ``InferenceEngine.create`` and
``TorchLLMService.create``, ``tokenize_scale`` on ``BatchedLLMService``,
and ``InferenceEngine.generate`` / ``warmup``. Bridged weights on the tiny
dense config, inputs from a seeded numpy generator; JAX runs its
reference path."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.manager import ContextManager
from repro.serving import BatchedLLMService as JaxBatchedLLMService
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import JaxLLMService
from repro.store import DistributedKVStore, Link, Network
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import BatchedLLMService, InferenceEngine, TorchLLMService

MAX_LEN, PS, KV_PAGES = 256, 16, 64


def _tcfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")


def _torch_params(jparams, tcfg):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")


def _shared_prompt_turns(vocab, seed=0):
    """Two sessions whose first turns share a 40-token system prompt (two
    full pages), each followed by its own question."""
    rng = np.random.default_rng(seed)
    system = rng.integers(8, vocab, size=40).tolist()
    return {key: system + rng.integers(8, vocab, size=13).tolist() for key in ("A", "B")}


@pytest.mark.parametrize("share", [False, True], ids=["no-sharing", "sharing"])
def test_engine_share_prefixes_matches_jax(tiny_dense_cfg, share):
    """``share_prefixes`` reaches the allocator: without sharing the two
    sessions keep separate physical pages for the common prompt (no shared
    hit, B prefills everything), with it B reuses A's two system pages.
    Tokens, reuse counts and page use equal JAX's under the same setting."""
    jeng = JaxEngine.create(tiny_dense_cfg, seed=0, max_len=MAX_LEN, page_size=PS,
                            kv_pages=KV_PAGES, share_prefixes=share)
    tcfg = _tcfg(tiny_dense_cfg)
    teng = InferenceEngine.create(tcfg, max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES,
                                  share_prefixes=share, device="cpu",
                                  params=_torch_params(jeng.params, tcfg))
    assert teng.session_pool.allocator.share_prefixes is share
    for key, ids in _shared_prompt_turns(tiny_dense_cfg.vocab_size).items():
        j = jeng.generate_ex(ids, max_new_tokens=6, cache_key=key)
        t = teng.generate_ex(ids, max_new_tokens=6, cache_key=key)
        assert t.token_ids == j.token_ids, key
        assert (t.cache_hit, t.reused_tokens) == (j.cache_hit, j.reused_tokens), key
    tpool, jpool = teng.session_pool, jeng.session_pool
    assert tpool.shared_hits == jpool.shared_hits == (1 if share else 0)
    pages = {k: tpool.peek(k).pages for k in ("A", "B")}
    common = set(pages["A"][:2]) & set(pages["B"][:2])
    assert len(common) == (2 if share else 0), pages
    assert tpool.allocator.used_pages == jpool.allocator.used_pages


def test_service_share_prefixes_reaches_allocator(tiny_dense_cfg):
    """``TorchLLMService.create(share_prefixes=False)`` builds an engine
    whose allocator does not share, as JAX's service does, and serves the
    two sessions with JAX's tokens."""
    kw = dict(max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES, share_prefixes=False)
    jsvc = JaxLLMService.create("m", tiny_dense_cfg, seed=0, **kw)
    tcfg = _tcfg(tiny_dense_cfg)
    tsvc = TorchLLMService.create("m", tcfg, device="cpu",
                                  params=_torch_params(jsvc.engine.params, tcfg), **kw)
    for svc in (jsvc, tsvc):
        assert svc.engine.session_pool.allocator.share_prefixes is False
    for key, ids in _shared_prompt_turns(tiny_dense_cfg.vocab_size, seed=1).items():
        j = jsvc.engine.generate_ex(ids, max_new_tokens=5, cache_key=key)
        t = tsvc.engine.generate_ex(ids, max_new_tokens=5, cache_key=key)
        assert t.token_ids == j.token_ids and not t.cache_hit, key
    assert tsvc.engine.session_pool.shared_hits == 0


def _mounted_scale(service) -> float:
    net = Network(default_link=Link(latency_ms=1.0, bandwidth_mbps=100.0))
    mgr = ContextManager(node_id="a", store=DistributedKVStore(net), service=service)
    return mgr.tokenize_scale


def test_batched_service_tokenize_scale(tiny_dense_cfg):
    """``BatchedLLMService(..., tokenize_scale=3.0)``: a JAX
    ``ContextManager`` mounting it reads 3.0, as it does from JAX's
    service; without the argument both report 1."""
    jsvc = JaxBatchedLLMService.create("m", tiny_dense_cfg, n_slots=2, max_len=128)
    tsvc = BatchedLLMService.create("m", _tcfg(tiny_dense_cfg), n_slots=2, max_len=128,
                                    device="cpu")
    assert _mounted_scale(tsvc) == _mounted_scale(jsvc) == 1.0
    jscaled = JaxBatchedLLMService(jsvc.model, jsvc.server, jsvc.tokenizer, tokenize_scale=3.0)
    tscaled = BatchedLLMService(tsvc.model, tsvc.server, tsvc.tokenizer, tokenize_scale=3.0)
    assert _mounted_scale(tscaled) == _mounted_scale(jscaled) == 3.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_generate_and_warmup_match_jax(tiny_dense_cfg, paged):
    """``generate`` returns ``generate_ex(...).token_ids`` and equals JAX's
    ``generate``, keyless and keyed; ``warmup`` runs a short generation per
    length and leaves the engine serving the same tokens."""
    kw = dict(max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES) if paged else dict(
        max_len=MAX_LEN)
    jeng = JaxEngine.create(tiny_dense_cfg, seed=0, **kw)
    tcfg = _tcfg(tiny_dense_cfg)
    teng = InferenceEngine.create(tcfg, device="cpu", params=_torch_params(jeng.params, tcfg),
                                  **kw)
    teng.warmup((8, 64))
    rng = np.random.default_rng(2)
    ids = rng.integers(8, tiny_dense_cfg.vocab_size, size=37).tolist()
    keyless = teng.generate(ids, max_new_tokens=7)
    assert keyless == jeng.generate(ids, max_new_tokens=7)
    assert keyless == teng.generate_ex(ids, max_new_tokens=7).token_ids
    keyed = teng.generate(ids, max_new_tokens=7, cache_key="s")
    assert keyed == jeng.generate(ids, max_new_tokens=7, cache_key="s") == keyless


# -- P4: PrefixPageIndex.pages() ---------------------------------------------

def test_prefix_index_pages_match_jax(tiny_dense_cfg):
    """After a wave of three tenants sharing a 52-token system prompt (three
    full pages at ps 16) through both paged batched servers on the same
    weights and prompts, ``allocator.index.pages()`` lists the same pages
    in the same order."""
    from repro.models import init_params as jax_init_params
    from repro.serving.scheduler import BatchedServer as JaxBatchedServer
    from repro.serving.session_cache import SessionCachePool as JaxPool
    from repro_torch.serving import BatchedServer, SessionCachePool

    jparams = jax_init_params(jax.random.key(0), tiny_dense_cfg)
    tcfg = _tcfg(tiny_dense_cfg)
    kw = dict(n_slots=2, max_len=128, paged=True, page_size=PS)
    jsrv = JaxBatchedServer(tiny_dense_cfg.replace(attn_impl="reference"), jparams,
                            session_pool=JaxPool(capacity=8), **kw)
    tsrv = BatchedServer(tcfg, _torch_params(jparams, tcfg),
                         session_pool=SessionCachePool(capacity=8), device="cpu", **kw)
    rng = np.random.default_rng(11)
    system = rng.integers(8, tiny_dense_cfg.vocab_size, size=52).tolist()
    reqs = [system + rng.integers(8, tiny_dense_cfg.vocab_size, size=5 + 2 * i).tolist()
            for i in range(3)]
    pages, tokens = {}, {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        assert srv.allocator.index.pages() == []
        rids = [srv.submit(list(r), max_new=5, cache_key=f"t{i}") for i, r in enumerate(reqs)]
        fin = {f.request_id: f.token_ids for f in srv.run_to_completion()}
        tokens[name] = [fin[r] for r in rids]
        pages[name] = srv.allocator.index.pages()
    assert tokens["torch"] == tokens["jax"]
    assert pages["torch"] == pages["jax"]
    assert len(pages["torch"]) >= 3 and len(pages["torch"]) == len(tsrv.allocator.index)
    assert tsrv.session_pool.shared_hits > 0


# -- P5: sample(logits, temperature, top_k, generator) ------------------------

def _logits(b=4, v=12, seed=5):
    return np.random.default_rng(seed).normal(size=(b, v)).astype(np.float32) * 2.0


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_sample_greedy_matches_jax(temperature):
    """At temperature <= 0 both return the argmax, int32, with no key."""
    from repro.serving.sampling import sample as jax_sample
    from repro_torch.serving.sampling import sample

    x = _logits(b=16, v=300)
    j = np.asarray(jax_sample(jax.numpy.asarray(x), temperature=temperature, top_k=5))
    t = sample(torch.from_numpy(x), temperature=temperature, top_k=5)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("top_k", [0, 1, 4])
def test_sample_top_k_mask_matches_jax(top_k, monkeypatch):
    """The logits JAX hands ``jax.random.categorical`` (divided by the
    temperature, -1e30 below the k-th value) equal the port's exactly; a
    missing generator trips the same assert as a missing key."""
    from repro.serving import sampling as jsampling
    from repro_torch.serving import sampling as tsampling

    seen = []
    real = jax.random.categorical
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: seen.append(np.asarray(lg)) or real(key, lg,
                                                                                      axis=axis))
    x = _logits()
    jsampling.sample(jax.numpy.asarray(x), temperature=0.7, top_k=top_k,
                     key=jax.random.key(0))
    t = tsampling._tempered(torch.from_numpy(x), 0.7, top_k).numpy()
    np.testing.assert_array_equal(t, seen[0])
    if top_k:
        assert ((t > -1e29).sum(-1) == top_k).all()
    with pytest.raises(AssertionError, match="PRNG key"):
        tsampling.sample(torch.from_numpy(x), temperature=0.7, top_k=top_k)


def test_sample_distribution_is_the_top_k_softmax():
    """The draws of the two packages cannot be equal (different
    generators), so their distribution is tested: 40,000 draws of each row
    at temperature 0.7 and top_k 4 never leave the top 4, and their
    frequencies pass a chi-square test against the softmax of the top-4
    tempered logits at p >= 1e-3 (seeded, so the test is deterministic)."""
    from scipy.stats import chisquare

    from repro_torch.serving.sampling import sample

    x = torch.from_numpy(_logits(b=3, v=12))
    n, k, temp = 40_000, 4, 0.7
    gen = torch.Generator().manual_seed(123)
    for row in range(x.shape[0]):
        draws = sample(x[row:row + 1].expand(n, -1), temperature=temp, top_k=k,
                       generator=gen).long()
        top = torch.topk(x[row], k).indices
        assert torch.isin(draws, top).all()
        expected = torch.softmax(x[row, top].double() / temp, dim=-1) * n
        observed = torch.stack([(draws == i).sum() for i in top]).double()
        assert chisquare(observed.numpy(), expected.numpy()).pvalue >= 1e-3
