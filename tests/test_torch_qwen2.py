"""Qwen2-0.5B in the port against the JAX package: the config copies and
the registry, and ``qwen2_0_5b.reduced()`` (GQA 4/2, QKV bias, tied
embeddings, rope θ 1e6) with bridged weights served on the paged route
(K3 + K1's plain versions), the dense route (K4 + K5's) and the paged
batched server, with greedy tokens and reuse counts identical to JAX's;
and ``launch.serve --arch qwen2-0.5b`` serving its reduced form."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.configs.qwen2_0_5b import CONFIG as JAX_QWEN2
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.scheduler import BatchedServer as JaxBatchedServer
from repro.serving.session_cache import SessionCachePool as JaxPool
from repro_torch import configs as tconfigs
from repro_torch.models import ModelConfig, params_from_numpy
from repro_torch.serving import BatchedServer, InferenceEngine, SessionCachePool

MAX_LEN, PS, KV_PAGES = 512, 16, 96
FIELDS = ("token_ids", "cache_hit", "reused_tokens", "prefill_tokens")


def _tcfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl="cuda")


def test_configs_and_registry_match_jax():
    """Every config the port registers is field for field JAX's;
    ``ASSIGNED`` holds the assigned architectures it serves, ``ALL`` adds
    the paper model, and names resolve with either spelling."""
    assert set(tconfigs.ASSIGNED) == {
        "qwen2-0.5b", "granite-moe-3b-a800m", "dbrx-132b", "mamba2-1.3b", "zamba2-7b"}
    assert set(tconfigs.ASSIGNED) <= set(jconfigs.ASSIGNED)
    assert set(tconfigs.ALL) == set(tconfigs.ASSIGNED) | {"paper-qwen1.5-0.5b"}
    assert tconfigs.list_archs() == sorted(tconfigs.ASSIGNED)
    for name, cfg in tconfigs.ALL.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get_config(name)), name
        assert tconfigs.get_config(name.replace("-", "_").upper()) is cfg
    q = tconfigs.QWEN2_0_5B
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.d_head) == (24, 896, 14, 2, 64)
    assert q.qkv_bias and q.tie_embeddings and q.rope_theta == 1e6
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gemma2-27b")


@pytest.mark.parametrize("route", ["paged", "dense"])
def test_engine_turns_match_jax(route):
    """Two sessions x 3 turns sharing a 40-token system prompt, and a
    keyless turn: tokens, session hits, reused and prefilled tokens equal
    JAX's turn for turn (on the paged route B's first turn shares A's
    system pages)."""
    jcfg = JAX_QWEN2.reduced()
    kw = dict(page_size=PS, kv_pages=KV_PAGES) if route == "paged" else {}
    jeng = JaxEngine.create(jcfg, seed=0, max_len=MAX_LEN, **kw)
    tcfg = _tcfg(jcfg)
    teng = InferenceEngine.create(
        tcfg, max_len=MAX_LEN, device="cpu", **kw,
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jeng.params), tcfg,
                                 device="cpu"))
    rng = np.random.default_rng(0)
    system = rng.integers(8, jcfg.vocab_size, size=40).tolist()
    hist = {"A": list(system), "B": list(system)}
    for turn in range(3):
        for key in ("A", "B"):
            hist[key] += rng.integers(8, jcfg.vocab_size, size=11 + 5 * turn).tolist()
            j = jeng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            t = teng.generate_ex(hist[key], max_new_tokens=8, cache_key=key)
            for f in FIELDS:
                assert getattr(t, f) == getattr(j, f), (route, turn, key, f)
            hist[key] += j.token_ids
    ids = rng.integers(8, jcfg.vocab_size, size=29).tolist()
    assert teng.generate(ids, max_new_tokens=6) == jeng.generate(ids, max_new_tokens=6)
    if route == "paged":
        assert teng.session_pool.shared_hits == jeng.session_pool.shared_hits == 1


def test_batched_wave_matches_jax():
    """Five tenants sharing a system prompt on three paged slots (the
    cascade branch), then their second turns: JAX's tokens and reuse."""
    jcfg = JAX_QWEN2.reduced()
    jparams = jax_init_params(jax.random.key(1), jcfg)
    tcfg = _tcfg(jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    kw = dict(n_slots=3, max_len=MAX_LEN, paged=True, page_size=PS)
    jsrv = JaxBatchedServer(jcfg, jparams, session_pool=JaxPool(capacity=8), **kw)
    tsrv = BatchedServer(tcfg, tparams, session_pool=SessionCachePool(capacity=8), device="cpu",
                         **kw)
    rng = np.random.default_rng(3)
    system = rng.integers(8, jcfg.vocab_size, size=50).tolist()
    reqs = [system + rng.integers(8, jcfg.vocab_size, size=3 + 2 * i).tolist() for i in range(5)]
    out = {}
    for name, srv in (("jax", jsrv), ("torch", tsrv)):
        res, wave = [], reqs
        for _ in range(2):
            rids = [srv.submit(list(r), max_new=6, cache_key=f"t{i}") for i, r in enumerate(wave)]
            fin = {f.request_id: f for f in srv.run_to_completion()}
            srv.finished.clear()
            res += [(fin[r].token_ids, fin[r].cache_hit, fin[r].reused_tokens) for r in rids]
            wave = [r + fin[rid].token_ids + [9] for r, rid in zip(wave, rids)]
        out[name] = (res, srv.session_pool.shared_hits, srv.allocator.used_pages)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] > 0 and all(hit for _, hit, _ in out["torch"][0][5:])


def test_serve_launcher_serves_qwen2(monkeypatch, capsys):
    """``launch.serve --arch qwen2-0.5b --device cpu`` gives each node its
    own kernel-route service of the reduced model and answers every turn
    of a roaming session, as ``repro.launch.serve --arch qwen2-0.5b``
    does."""
    from repro_torch import serving
    from repro_torch.launch import serve

    made = []
    create = serving.TorchLLMService.create

    def recording_create(model, cfg, **kw):
        made.append((cfg.name, cfg.attn_impl, cfg.n_kv_heads))
        return create(model, cfg, **kw)

    monkeypatch.setattr(serving.TorchLLMService, "create", staticmethod(recording_create))
    serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--turns", "3", "--roam"])
    assert made == [("qwen2-0.5b-smoke", "cuda", 2)] * 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:4]] == ["edge-0", "edge-0", "edge-1"]
    assert lines[-1].startswith("sync=")
