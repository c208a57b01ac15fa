"""The migration warm-start hooks of the port against the JAX package:

- the KV-page wire format: for the same pool contents the port's
  ``export_page_bytes`` equals JAX's byte for byte (f32 and bf16), JAX's
  bytes imported into the port reproduce the page bit-exactly, and an
  import into the scratch page is refused;
- ``TorchLLMService``: pages exported by one service and installed into
  another make the next turn a ``"pages"`` warm start, ``prime`` from
  token ids a ``"tokens"`` one, both with the tokens of a cold JAX run;
- the batched server's ``prime`` and ``install_kv_pages`` likewise;
- a JAX ``EdgeCluster`` with ``kv_ship=True`` whose origin node runs the
  JAX service and whose destination runs the port: a roam installs the
  shipped JAX pages on the torch node, with the texts of the token
  recompute run."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.edge import EdgeCluster, LLMClient
from repro.models import init_params as jax_init_params
from repro.serving import JaxLLMService
from repro.serving.paged_kv import PagedKVAllocator as JaxAllocator
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.models.weights import tensor_from_numpy
from repro_torch.serving import SCRATCH_PAGE, BatchedLLMService, PagedKVAllocator, TorchLLMService

PS, KV_PAGES, MAX_LEN = 16, 48, 256


def _tcfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")


def _tparams(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(seed), jcfg))
    return params_from_numpy(tree, _tcfg(jcfg), device="cpu")


def _filled_pair(jcfg, dtype, seed):
    """A JAX and a port allocator whose pools hold the same numpy values."""
    j = JaxAllocator(jcfg, page_size=PS, n_pages=6)
    t = PagedKVAllocator(_tcfg(jcfg), page_size=PS, n_pages=6, device=torch.device("cpu"))
    rng = np.random.default_rng(seed)
    jpools = []
    for jp, tp in zip(j.pools, t.pools):
        entry = {}
        for name in ("k", "v"):
            a = rng.standard_normal(jp[name].shape).astype(np.float32).astype(dtype)
            entry[name] = jnp.asarray(a)
            tp[name].copy_(tensor_from_numpy(a, torch.device("cpu")))
        jpools.append(entry)
    j.pools = jpools
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_bytes_match_jax(tiny_dense_cfg, dtype):
    """Export is byte-identical to JAX's; JAX's bytes import bit-exactly."""
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jcfg = tiny_dense_cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    j, t = _filled_pair(jcfg, np_dtype, seed=0)
    assert t.page_bytes == j.page_bytes
    for page in (1, 4):
        assert t.export_page_bytes(page) == j.export_page_bytes(page)
    _, dst = _filled_pair(jcfg, np_dtype, seed=1)
    dst.import_page_bytes(2, j.export_page_bytes(4))
    for pool, src in zip(dst.pools, t.pools):
        for name in ("k", "v"):
            assert torch.equal(pool[name][:, 2].view(torch.uint8), src[name][:, 4].view(torch.uint8))
    assert dst.export_page_bytes(2) == j.export_page_bytes(4)
    with pytest.raises(ValueError, match="scratch"):
        dst.import_page_bytes(SCRATCH_PAGE, j.export_page_bytes(4))
    with pytest.raises(ValueError, match="bytes"):
        dst.import_page_bytes(3, j.export_page_bytes(4)[:-2])
    assert dst.stats()["page_bytes"] == j.stats()["page_bytes"]


def _history(svc):
    tok = svc.tokenizer
    p1 = tok.encode("a long opening question about wheel odometry covariance and loop "
                    "closure detection for the warehouse robot near the charging dock")
    r1 = svc.completion([], p1, 24, cache_key="s")
    return p1 + r1.token_ids, tok.encode("and a follow-up about sensor fusion")


def test_service_ship_and_prime_warm_starts(tiny_dense_cfg):
    """Service a exports its pages, b installs them, c primes from tokens:
    b's and c's next turns are warm starts ("pages", "tokens") that prefill
    only the prompt, with the tokens of a cold JAX service."""
    jcfg = tiny_dense_cfg
    tparams = _tparams(jcfg)

    def mk():
        svc = TorchLLMService.create("m", _tcfg(jcfg), max_len=MAX_LEN, page_size=PS,
                                     kv_pages=KV_PAGES, device="cpu", params=tparams)
        assert svc.capabilities().prime and svc.kv_ship_profile() is None
        return svc

    a, b, c = mk(), mk(), mk()
    hist, p2 = _history(a)
    ship = a.export_kv_pages("s")
    assert ship is not None and len(ship.payloads) >= 2
    assert ship.token_ids == hist[: len(ship.token_ids)]
    assert b.install_kv_pages("s", ship.token_ids, ship.payloads, 0)
    assert c.prime("s", hist)
    assert b.resident_ship_pages("s", hist) == len(hist) // PS
    rb = b.completion(hist, p2, 12, cache_key="s")
    rc = c.completion(hist, p2, 12, cache_key="s")
    cold = JaxLLMService.create("m", jcfg, max_len=MAX_LEN, kv_reuse=False).completion(hist, p2, 12)
    assert rb.token_ids == rc.token_ids == cold.token_ids
    assert rb.warm_start and rb.warm_source == "pages"
    assert rc.warm_start and rc.warm_source == "tokens"
    for r in (rb, rc):
        assert r.cache_hit and r.reused_tokens == len(hist) and r.prefill_tokens == len(p2)
    assert b.engine.prime_count == c.engine.prime_count == 1
    b.ship_prefill_ms_per_token = 1.0
    prof = b.kv_ship_profile()
    assert prof.page_size == PS and prof.page_wire_bytes == b.engine.session_pool.allocator.page_bytes


def test_batched_service_ship_and_prime(tiny_dense_cfg):
    """The batched server's hooks: pages installed from a single-stream
    service and a token prime both make suffix-only warm starts."""
    jcfg = tiny_dense_cfg
    tparams = _tparams(jcfg)
    a = TorchLLMService.create("m", _tcfg(jcfg), max_len=MAX_LEN, page_size=PS,
                               kv_pages=KV_PAGES, device="cpu", params=tparams)
    hist, p2 = _history(a)
    ship = a.export_kv_pages("s")
    outs = {}
    for how in ("pages", "tokens"):
        svc = BatchedLLMService.create("m", _tcfg(jcfg), n_slots=2, max_len=MAX_LEN,
                                       paged=True, page_size=PS, kv_pages=KV_PAGES,
                                       device="cpu", params=tparams)
        ok = (svc.install_kv_pages("s", ship.token_ids, ship.payloads, 0) if how == "pages"
              else svc.prime("s", hist))
        assert ok
        r = svc.completion(hist, p2, 12, cache_key="s")
        assert r.warm_start and r.warm_source == how
        assert r.reused_tokens == len(hist) and r.prefill_tokens == len(p2)
        outs[how] = r.token_ids
    assert outs["pages"] == outs["tokens"] == a.completion(hist, p2, 12, cache_key="s").token_ids


def _ship_cluster(tiny_dense_cfg, force):
    jcfg = tiny_dense_cfg
    tparams = _tparams(jcfg)

    def factory(nid):
        if nid == "n0":
            svc = JaxLLMService.create("m", jcfg, seed=0, max_len=2 * MAX_LEN,
                                       page_size=PS, kv_pages=KV_PAGES)
        else:
            svc = TorchLLMService.create("m", _tcfg(jcfg), max_len=2 * MAX_LEN, page_size=PS,
                                         kv_pages=KV_PAGES, device="cpu", params=tparams)
        svc.ship_prefill_ms_per_token = 0.9
        return svc

    return EdgeCluster.build(["n0", "n1"], factory, kv_ship=True, kv_ship_force=force)


def test_jax_to_torch_kv_ship(tiny_dense_cfg):
    """A session served on the JAX node roams to the torch node: the JAX
    node's pages are shipped and installed there (warm source "pages", no
    fallback), and every text equals the token-recompute cluster's."""
    turns = [f"turn {i} about maps and control" for i in range(5)] + ["roam turn"]
    texts, last = {}, {}
    for force in ("ship", "recompute"):
        cluster = _ship_cluster(tiny_dense_cfg, force)
        client = LLMClient(cluster, "m", user_id="u", session_id="s", max_new_tokens=8)
        texts[force] = []
        for i, prompt in enumerate(turns):
            t = client.submit(prompt, node_id="n1" if i == len(turns) - 1 else "n0")
            cluster.run_until_quiet()
            assert t.done and t.response.error is None, t.response
            texts[force].append(t.response.text)
        last[force] = (t.response, cluster.kv_ship_stats())
    resp, stats = last["ship"]
    assert resp.timing.kv_warm_start and resp.timing.kv_warm_source == "pages"
    assert stats["installed"] > 0 and stats["fallbacks"] == 0 and stats["node_fallbacks"] == 0
    assert last["recompute"][0].timing.kv_warm_source == "tokens"
    assert texts["ship"] == texts["recompute"]
