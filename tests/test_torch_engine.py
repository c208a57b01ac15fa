"""The slice as a whole against the JAX package: the port's paged
``InferenceEngine`` serves multi-turn keyed sessions token-identically to
JAX's paged engine with the same (bridged) weights and the same reuse
accounting — session hits that prefill only the suffix and a cross-session
shared-prefix hit — and a ``TorchLLMService`` mounted on both nodes of a
JAX ``EdgeCluster`` serves a roaming client with the transcripts of an
all-JAX cluster. The port runs its kernel path (plain versions on CPU
tensors); JAX runs its reference path, which its own tests hold
token-identical to its Pallas path."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.core import ContextMode
from repro.edge import EdgeCluster, LLMClient
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import JaxLLMService
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import InferenceEngine, PagePoolExhausted, TorchLLMService

MAX_LEN, PS, KV_PAGES = 256, 16, 64


def _tcfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")


def _torch_params(jparams, tcfg):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")


FIELDS = ("token_ids", "cache_hit", "reused_tokens", "prefill_tokens", "warm_start", "warm_source")


def test_engine_sessions_match_jax(tiny_dense_cfg):
    """Two sessions x 3 turns. Turns 2-3 of each are session hits that
    prefill only the suffix (one ends mid-page: tail-page copy); session
    B's first turn shares session A's system-prompt pages through the
    content index. Tokens and reuse counts equal JAX's turn for turn."""
    jcfg = tiny_dense_cfg
    jeng = JaxEngine.create(jcfg, seed=0, max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES)
    tcfg = _tcfg(jcfg)
    teng = InferenceEngine.create(tcfg, max_len=MAX_LEN, page_size=PS, kv_pages=KV_PAGES,
                                  device="cpu", params=_torch_params(jeng.params, tcfg))
    rng = np.random.default_rng(0)
    system = rng.integers(8, jcfg.vocab_size, size=40).tolist()
    hist = {"A": list(system), "B": list(system)}
    results = []
    for turn in range(3):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, jcfg.vocab_size, size=11 + 5 * turn).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=9, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=9, cache_key=key)
            for f in FIELDS:
                assert getattr(t, f) == getattr(j, f), (turn, key, f, getattr(t, f), getattr(j, f))
            hist[key] += j.token_ids
            results.append(t)
    a1, b1 = results[0], results[1]
    assert not a1.cache_hit
    assert b1.cache_hit and b1.reused_tokens == 32       # two shared system pages
    assert teng.session_pool.shared_hits == jeng.session_pool.shared_hits == 1
    for r in results[2:]:
        assert r.cache_hit and r.prefill_tokens < 30
    assert teng.session_pool.allocator.used_pages == jeng.session_pool.allocator.used_pages


def test_decode_to_full_table_width(tiny_dense_cfg):
    """A turn that decodes until its page table spans all of max_len (the
    width at which the JAX engine's donated kv_pos row breaks, ROADMAP
    Queue 3) completes, and the kernel path and the reference path agree."""
    out = {}
    for impl in ("cuda", "reference"):
        tcfg = _tcfg(tiny_dense_cfg).replace(attn_impl=impl)
        eng = InferenceEngine.create(tcfg, max_len=64, page_size=PS, kv_pages=8, device="cpu")
        ids = list(range(8, 48))
        r1 = eng.generate_ex(ids, max_new_tokens=24, cache_key="k")
        assert len(r1.token_ids) == 24                      # positions up to 63
        r2 = eng.generate_ex(ids[:30], max_new_tokens=34, cache_key="k")
        assert r2.cache_hit and r2.reused_tokens == 29      # a resend: prefix reuse
        out[impl] = (r1.token_ids, r2.token_ids)
    assert out["cuda"] == out["reference"]


def test_page_exhaustion_raises(tiny_dense_cfg):
    """Where JAX falls back to the dense route, the port raises."""
    tcfg = _tcfg(tiny_dense_cfg)
    eng = InferenceEngine.create(tcfg, max_len=MAX_LEN, page_size=PS, kv_pages=3, device="cpu")
    with pytest.raises(PagePoolExhausted):
        eng.generate_ex(list(range(1, 60)), max_new_tokens=4, cache_key="k")
    with pytest.raises(NotImplementedError):
        eng.generate_ex(list(range(1, 10)), max_new_tokens=4)   # keyless: dense route


def _roam(cluster):
    client = LLMClient(cluster, model="m", mode=ContextMode.TOKENIZED, max_new_tokens=12)
    resps = []
    for i, node in enumerate(["a", "b", "a"]):
        r = client.chat(f"question {i} about robots and their sensors", node)
        assert r.error is None, r.error
        resps.append(r)
        client.think(400)
    return resps


def test_torch_service_roams_in_jax_cluster():
    """A client roams edge-a -> edge-b -> edge-a. With TorchLLMService on
    both nodes of a JAX EdgeCluster it gets the transcripts of the all-JAX
    cluster; the port's turn back on edge-a reuses that node's pages."""
    jcfg = JAX_PAPER.reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    tcfg = _tcfg(jcfg)
    tparams = _torch_params(jparams, tcfg)
    # max_len 512: the JAX engine's decode loop donates its whole kv_pos
    # row once the table width reaches max_len (a fault of the reference,
    # ROADMAP Queue 3); this roam stays below it
    jax_cluster = EdgeCluster.build(
        ["a", "b"],
        lambda nid: JaxLLMService.create("m", jcfg, seed=0, max_len=2 * MAX_LEN,
                                         page_size=PS, kv_pages=KV_PAGES),
    )
    torch_cluster = EdgeCluster.build(
        ["a", "b"],
        lambda nid: TorchLLMService.create("m", tcfg, max_len=2 * MAX_LEN, page_size=PS,
                                           kv_pages=KV_PAGES, device="cpu", params=tparams),
    )
    want = _roam(jax_cluster)
    got = _roam(torch_cluster)
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.n_generated_tokens for r in got] == [r.n_generated_tokens for r in want]
    assert [r.n_context_tokens for r in got] == [r.n_context_tokens for r in want]
    t3 = got[2].timing
    assert t3.migrated and t3.kv_cache_hit and t3.kv_reused_tokens > 0
    assert not got[1].timing.kv_cache_hit   # no prime in this slice: cold on b
    assert torch_cluster.node("a").service.resident_keys()
