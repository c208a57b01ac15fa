"""The batched paged server against the JAX package, with the same
(bridged) weights, in f32:

- ``BatchedServer(paged=True)``: the port with the kernels selected (the
  plain cascade on CPU tensors) against JAX's reference server — same
  greedy tokens, reuse and sharing counts and pages in use, over a wave of
  tenants sharing a system prompt and their second turns, and with a long
  admission interleaving its chunks with resident decodes;
- ``BatchedLLMService`` on one node of a JAX ``EdgeCluster`` with four
  concurrent clients: the texts of the all-JAX cluster, in a shared batch.

JAX's own tests hold its reference server token-identical to its Pallas
cascade (tests/test_paged_kv.py)."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.edge import EdgeCluster, LLMClient
from repro.models import init_params as jax_init_params
from repro.serving import BatchedLLMService as JaxBatchedLLMService
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro.serving.session_cache import SessionCachePool as JaxPool
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import BatchedLLMService, BatchedServer, SessionCachePool

def _tcfg(jcfg, impl="cuda"):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=impl)


def _bridged(jcfg, seed=0):
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, _tcfg(jcfg), device="cpu")


@pytest.fixture(params=["tiny_gqa", "paper_mha"])
def jcfg(request, tiny_dense_cfg):
    return tiny_dense_cfg if request.param == "tiny_gqa" else JAX_PAPER.reduced()


# -- BatchedServer ------------------------------------------------------------

def _servers(jcfg, jparams, tparams, **kw):
    jsrv = JaxBatchedServer(jcfg.replace(attn_impl="reference"), jparams,
                            session_pool=JaxPool(capacity=8), paged=True, **kw)
    tsrv = BatchedServer(_tcfg(jcfg), tparams, session_pool=SessionCachePool(capacity=8),
                         paged=True, device="cpu", **kw)
    return jsrv, tsrv


def _wave(srv, reqs, max_new, keys):
    rids = [srv.submit(list(r), max_new=max_new, cache_key=k) for r, k in zip(reqs, keys)]
    fin = {f.request_id: f for f in srv.run_to_completion()}
    srv.finished.clear()
    return [fin[r] for r in rids]


FIELDS = ("token_ids", "reused_tokens", "cache_hit", "warm_start", "warm_source")


def test_batched_server_matches_jax(jcfg, monkeypatch):
    """Four tenants share a 3-page system prompt (ps 16) on two slots, then
    each takes a second turn under its key. Port and JAX give the same
    tokens, reuse, sharing counts and pages in use; the port's decode took
    the cascade branch."""
    calls = []
    real = paged_ops.shared_prefix_ref
    monkeypatch.setattr(paged_ops, "shared_prefix_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jparams, tparams = _bridged(jcfg)
    jsrv, tsrv = _servers(jcfg, jparams, tparams, n_slots=2, max_len=128, page_size=16)
    rng = np.random.default_rng(4)
    system = rng.integers(8, jcfg.vocab_size, size=52).tolist()
    reqs = [system + rng.integers(8, jcfg.vocab_size, size=4 + 3 * i).tolist()
            for i in range(4)]
    keys = [f"t{i}" for i in range(4)]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        first = _wave(srv, reqs, 6, keys)
        second = _wave(srv, [r + f.token_ids + [7, 8, 9] for r, f in zip(reqs, first)], 5, keys)
        pool = srv.session_pool
        out[name] = ([[getattr(f, k) for k in FIELDS] for f in first + second],
                     pool.shared_hits, pool.shared_tokens, srv.allocator.used_pages,
                     pool.stats()["unique_pages"], pool.stats()["pages_in_use"])
    assert out["torch"] == out["jax"]
    results, hits, tokens, used, unique, logical = out["torch"]
    assert hits == 3 and tokens == 3 * 48
    assert unique < logical                      # the system prompt is stored once
    assert all(r[2] and r[1] > 0 for r in results[4:])   # second turns: session hits
    assert calls, "the port's decode never took the cascade branch"


def test_batched_server_sharing_off_matches_jax(tiny_dense_cfg):
    """``share_prefixes=False``: the same tokens as JAX's server, no shared
    hit, and every tenant stores the system prompt in its own pages."""
    jparams, tparams = _bridged(tiny_dense_cfg)
    rng = np.random.default_rng(6)
    system = rng.integers(8, 512, size=52).tolist()
    reqs = [system + rng.integers(8, 512, size=5 + i).tolist() for i in range(3)]
    out = {}
    for share in (True, False):
        jsrv, tsrv = _servers(tiny_dense_cfg, jparams, tparams, n_slots=2, max_len=128,
                              page_size=16, share_prefixes=share)
        for name, srv in (("jax", jsrv), ("torch", tsrv)):
            fin = _wave(srv, reqs, 5, [f"t{i}" for i in range(3)])
            pool = srv.session_pool
            out[name, share] = ([f.token_ids for f in fin], pool.shared_hits,
                                srv.allocator.used_pages)
        assert out["torch", share] == out["jax", share]
    assert out["torch", False][0] == out["torch", True][0]
    assert out["torch", False][1] == 0 < out["torch", True][1]
    assert out["torch", False][2] > out["torch", True][2]


@pytest.mark.parametrize("budget", [16, None])
def test_chunk_budget_interleaves_like_jax(tiny_dense_cfg, budget):
    """A resident tenant decodes while a long admission (90 tokens) drains
    its plan in 16-token chunks (or all at once): the same tokens as JAX."""
    jparams, tparams = _bridged(tiny_dense_cfg)
    jsrv, tsrv = _servers(tiny_dense_cfg, jparams, tparams, n_slots=2, max_len=128,
                          page_size=16, prefill_chunk_tokens=budget)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, 512, size=20).tolist(), rng.integers(1, 512, size=90).tolist()]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        rids = [srv.submit(list(reqs[0]), max_new=6, cache_key="s0")]
        for _ in range(2):
            srv.step()
        rids.append(srv.submit(list(reqs[1]), max_new=6, cache_key="s1"))
        fin = {f.request_id: f.token_ids for f in srv.run_to_completion()}
        out[name] = [fin[r] for r in rids]
    assert out["torch"] == out["jax"]
    assert all(len(t) == 6 for t in out["torch"])


# -- BatchedLLMService in a JAX EdgeCluster -------------------------------------

def test_batched_service_in_jax_cluster(tiny_dense_cfg):
    """Four concurrent clients on one node share the port's decode batch
    and get the texts of the all-JAX batched cluster."""
    jcfg = tiny_dense_cfg
    _, tparams = _bridged(jcfg)
    kw = dict(n_slots=4, max_len=192, paged=True, page_size=16)
    texts = {}
    for name in ("jax", "torch"):
        svc = (JaxBatchedLLMService.create("m", jcfg.replace(attn_impl="reference"), **kw)
               if name == "jax" else
               BatchedLLMService.create("m", _tcfg(jcfg), device="cpu", params=tparams, **kw))
        assert svc.capabilities().batched and svc.capabilities().prime
        cluster = EdgeCluster.build(["a"], lambda nid, s=svc: s)
        clients = [LLMClient(cluster, model="m", max_new_tokens=6) for _ in range(4)]
        tickets = [c.submit(f"question {i} about robots", "a") for i, c in enumerate(clients)]
        cluster.run_until_quiet()
        resps = [t.response for t in tickets]
        assert all(r.error is None for r in resps)
        assert max(r.timing.batch_size for r in resps) > 1
        assert all(r.timing.inference_ms > 0 for r in resps)
        texts[name] = [r.text for r in resps]
    assert texts["torch"] == texts["jax"]
