"""The model layer's shared-prefix cascade against the JAX package, with
the same (bridged) weights, in f32: ``attention_decode_paged`` and
``decode_step_paged`` with ``shared_pages`` on the batched server's
trimmed table equal the same calls without it and JAX's reference path
(rtol = atol = 1e-5), and a lane pushed to ``pos = w * page_size`` (a
mid-prefill lane riding the batched call) writes nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.models import attention as jattn
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import init_params as jax_init_params
from repro_torch.models import ModelConfig, attention, decode_step_paged, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _tcfg(jcfg, impl="cuda"):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=impl)


def _bridged(jcfg, seed=0):
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, _tcfg(jcfg), device="cpu")


@pytest.fixture(params=["tiny_gqa", "paper_mha"])
def jcfg(request, tiny_dense_cfg):
    return tiny_dense_cfg if request.param == "tiny_gqa" else JAX_PAPER.reduced()


PS, W, MP = 8, 4, 8   # page size, trimmed table width (pages), full width


def _batch_state(jcfg, seed=0):
    """Four lanes over one pool: lanes 0-2 decode and share pages [1, 2]
    (positions [0, 16)); lane 2's query sits right past the run; lane 3 is
    mid-prefill, pushed to pos = W * PS. Returns numpy (pools k/v
    (L, P, PS, KV, Dh), full table (4, MP), full kv_pos (4, MP*PS), tokens
    (4, 1), pos (4,), shared (2,))."""
    rng = np.random.default_rng(seed)
    L, KV, Dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.d_head
    pk = rng.standard_normal((L, 10, PS, KV, Dh)).astype(np.float32)
    pv = rng.standard_normal((L, 10, PS, KV, Dh)).astype(np.float32)
    table = np.zeros((4, MP), np.int32)
    table[:, :2] = [1, 2]
    for lane, own in enumerate(([3], [4, 9], [5], [6, 7])):
        table[lane, 2 : 2 + len(own)] = own
    lens = (19, 25, 16, 20)
    kv_pos = np.full((4, MP * PS), -1, np.int32)
    for lane, n in enumerate(lens):
        kv_pos[lane, :n] = np.arange(n)
    tokens = rng.integers(1, jcfg.vocab_size, size=(4, 1)).astype(np.int32)
    pos = np.asarray([19, 25, 16, W * PS], np.int32)
    return pk, pv, table, kv_pos, tokens, pos, np.asarray([1, 2], np.int32)


def test_attention_decode_paged_shared_matches_jax(jcfg):
    """One layer: the cascade equals the single pass and JAX's gather
    reference on the decoding lanes."""
    pk, pv, table, kv_pos, _, pos, sp = _batch_state(jcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 1, jcfg.d_model)).astype(np.float32)
    jparams, tparams = _bridged(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"][0]["attn"])
    tp = tparams["groups"][0][0]["attn"]
    positions = pos[:, None]
    tbl, kvp = table[:, :W], kv_pos[:, : W * PS]
    args = [torch.from_numpy(a) for a in (x, positions, pk[0], pv[0], tbl, kvp)]
    tcfg = _tcfg(jcfg)
    fused = attention.attention_decode_paged(tp, *args[:6], tcfg, shared_pages=torch.from_numpy(sp))
    single = attention.attention_decode_paged(tp, *args[:6], tcfg)
    want = jattn.attention_decode_paged(
        jp, *[jnp.asarray(a) for a in (x, positions, pk[0], pv[0], tbl, kvp)],
        jcfg.replace(attn_impl="reference"),
    )
    np.testing.assert_allclose(fused[:3].numpy(), single[:3].numpy(), **TOL)
    np.testing.assert_allclose(fused[:3].numpy(), np.asarray(want)[:3], **TOL)


def test_decode_step_paged_shared_matches_jax(jcfg):
    """The batched server's decode call: trimmed table and kv_pos, a shared
    run, a mid-prefill lane pushed to W * PS. Logits of the decoding lanes
    equal the single pass and JAX's reference; pools and kv_pos equal
    JAX's; the pushed lane changed neither the pool nor its kv_pos row."""
    pk, pv, table, kv_pos, tokens, pos, sp = _batch_state(jcfg, 3)
    jparams, tparams = _bridged(jcfg)
    tbl, kvp = table[:, :W], np.ascontiguousarray(kv_pos[:, : W * PS])
    jlog, jpools, jkv = jax_decode_step_paged(
        jparams, jcfg.replace(attn_impl="reference"),
        [{"k": jnp.asarray(pk), "v": jnp.asarray(pv)}],
        *[jnp.asarray(a) for a in (tbl, kvp, tokens, pos, sp)],
    )
    outs = {}
    for name, shared in (("fused", torch.from_numpy(sp)), ("single", None)):
        pools = [{"k": torch.from_numpy(pk.copy()), "v": torch.from_numpy(pv.copy())}]
        kv = torch.from_numpy(kvp.copy())
        logits = decode_step_paged(
            tparams, _tcfg(jcfg), pools, torch.from_numpy(tbl), kv,
            torch.from_numpy(tokens), torch.from_numpy(pos), shared,
        )
        outs[name] = (logits, pools, kv)
    logits, pools, kv = outs["fused"]
    np.testing.assert_allclose(logits[:3].numpy(), outs["single"][0][:3].numpy(), **TOL)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jlog)[:3], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[0][name].numpy(), np.asarray(jpools[0][name]), **TOL)
        # the pushed lane's pages, and the scratch page, hold their bytes
        for page in (0, 6, 7):
            assert np.array_equal(pools[0][name][:, page].numpy(),
                                  (pk if name == "k" else pv)[:, page])
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(kv[3].numpy(), kvp[3])
