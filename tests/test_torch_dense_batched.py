"""The full-width batched server (``BatchedServer(paged=False)``, the JAX
default) against JAX's, with the same (bridged) weights, in f32: the same
greedy tokens and reuse accounting over a wave of tenants on fewer slots
than tenants — so slots are re-admitted after their lanes were written
back to the session pool — and their second turns (session hits appended
onto a copy of the stored lane); a warm start primed through a dense lane;
and ``BatchedLLMService`` (default ``paged=False``) on one node of a JAX
``EdgeCluster`` with four concurrent clients. The port runs its kernel path
(K4/K5's plain versions on CPU tensors), JAX its reference path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.edge import EdgeCluster, LLMClient
from repro.serving import BatchedLLMService as JaxBatchedLLMService
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro.serving.session_cache import SessionCachePool as JaxPool
from repro_torch.serving import BatchedLLMService, BatchedServer, SessionCachePool
from test_torch_batched import FIELDS, _bridged, _tcfg, _wave, jcfg  # noqa: F401


def _servers(jcfg, jparams, tparams, **kw):
    jsrv = JaxBatchedServer(jcfg.replace(attn_impl="reference"), jparams,
                            session_pool=JaxPool(capacity=8), **kw)
    tsrv = BatchedServer(_tcfg(jcfg), tparams, session_pool=SessionCachePool(capacity=8),
                         device="cpu", **kw)
    assert not tsrv.paged and tsrv.allocator is None
    return jsrv, tsrv


def test_full_width_server_matches_jax(jcfg):
    """Five tenants on two slots: slots 0 and 1 are re-admitted twice each
    after their finished lanes were copied into the pool, then every tenant
    takes a second turn (a session hit prefilling only its suffix). Tokens,
    reuse and the KV byte accounting equal JAX's."""
    jparams, tparams = _bridged(jcfg)
    jsrv, tsrv = _servers(jcfg, jparams, tparams, n_slots=2, max_len=128)
    rng = np.random.default_rng(7)
    reqs = [rng.integers(8, jcfg.vocab_size, size=18 + 7 * i).tolist() for i in range(5)]
    keys = [f"t{i}" for i in range(5)]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        first = _wave(srv, reqs, 6, keys)
        second = _wave(srv, [r + f.token_ids + [7, 8, 9] for r, f in zip(reqs, first)], 5, keys)
        out[name] = ([[getattr(f, k) for k in FIELDS] for f in first + second],
                     srv.session_pool.stats(), srv.resident_kv_bytes(), srv.total_kv_bytes())
    assert out["torch"] == out["jax"]
    results = out["torch"][0]
    assert not any(r[2] for r in results[:5])
    assert all(r[2] and r[1] == len(reqs[i]) + 6 for i, r in enumerate(results[5:]))


def test_full_width_prime_matches_jax(tiny_dense_cfg):
    """A prime through the full-width server's dense lane: the primed
    session's turn is a "tokens" warm start with the tokens of JAX's."""
    jparams, tparams = _bridged(tiny_dense_cfg)
    jsrv, tsrv = _servers(tiny_dense_cfg, jparams, tparams, n_slots=2, max_len=96)
    rng = np.random.default_rng(8)
    ctx = rng.integers(8, 512, size=40).tolist()
    ids = ctx + rng.integers(8, 512, size=6).tolist()
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        assert srv.prime("k", ctx)
        assert not srv.install_shipped_pages("k", ctx, [], 0)
        (f,) = _wave(srv, [ids], 5, ["k"])
        out[name] = [getattr(f, k) for k in FIELDS]
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == [len(ctx), True, True, "tokens"]


def test_full_width_service_in_jax_cluster(tiny_dense_cfg):
    """Four concurrent clients on one node share the full-width server's
    decode batch (the default BatchedLLMService) and get the texts of the
    all-JAX batched cluster, then a second turn each hits its session."""
    jcfg = tiny_dense_cfg
    _, tparams = _bridged(jcfg)
    kw = dict(n_slots=4, max_len=192)
    texts = {}
    for name in ("jax", "torch"):
        svc = (JaxBatchedLLMService.create("m", jcfg.replace(attn_impl="reference"), **kw)
               if name == "jax" else
               BatchedLLMService.create("m", _tcfg(jcfg), device="cpu", params=tparams, **kw))
        assert svc.capabilities().batched and svc.capabilities().kv_reuse
        assert svc.kv_ship_profile() is None
        cluster = EdgeCluster.build(["a"], lambda nid, s=svc: s)
        clients = [LLMClient(cluster, model="m", max_new_tokens=6) for _ in range(4)]
        resps = []
        for turn in range(2):
            tickets = [c.submit(f"question {i}.{turn} about robots", "a")
                       for i, c in enumerate(clients)]
            cluster.run_until_quiet()
            resps += [t.response for t in tickets]
        assert all(r.error is None for r in resps)
        assert max(r.timing.batch_size for r in resps) > 1
        assert all(r.timing.kv_cache_hit for r in resps[4:])
        texts[name] = [r.text for r in resps]
    assert texts["torch"] == texts["jax"]
