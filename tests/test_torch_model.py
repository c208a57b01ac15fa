"""The port's paged model functions against the JAX package with the same
(bridged) weights: chunked paged prefill (``prefill_chunk_paged``) and
paged decode (``decode_step_paged``), on the tiny GQA config and the
paper's Qwen1.5-0.5B reduced (MHA, qkv bias, tied embeddings), in f32.
Logits agree within 1e-4 and greedy tokens are identical over 16 steps.
JAX runs its reference path and its Pallas kernels in interpret mode; the
port runs its reference path and its kernel path (the plain versions, on
CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.models import decode_step_paged as jax_decode_step_paged
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk_paged as jax_prefill_chunk_paged
from repro.models.cache import init_paged_pool as jax_init_paged_pool
from repro_torch.models import ModelConfig, decode_step_paged, params_from_numpy, prefill_chunk_paged
from repro_torch.models.cache import init_paged_pool

PS, MP, N_PAGES = 8, 8, 12   # page size, table width (pages), pool pages
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def bridged_params(jcfg, seed=0):
    """JAX init_params as numpy, with the zero-initialised norms and qkv
    biases perturbed by seeded noise (else a norm or bias bug is
    invisible); returns (jax params, numpy tree)."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree_util.tree_map(np.array, tree)  # writable copies
    tree["embed"]["final_norm"] += 0.1 * rng.standard_normal(tree["embed"]["final_norm"].shape)
    g = tree["groups"][0]
    for name in ("norm1", "norm2"):
        g[name] += 0.1 * rng.standard_normal(g[name].shape)
    for name in ("bq", "bk", "bv"):
        if name in g["attn"]:
            g["attn"][name] += 0.1 * rng.standard_normal(g["attn"][name].shape)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def tcfg_of(jcfg, attn_impl):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=attn_impl)


@pytest.fixture(params=["tiny_gqa", "paper_mha"])
def jcfg(request, tiny_dense_cfg):
    return tiny_dense_cfg if request.param == "tiny_gqa" else JAX_PAPER.reduced()


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_paged_prefill_and_decode_match_jax(jcfg, impl):
    """Two prefill chunks (the second starting mid-page) then 16 greedy
    paged decode steps: every step's logits and token agree, and the pools
    hold the same K/V."""
    jc = jcfg.replace(attn_impl="reference" if impl == "reference" else "pallas")
    tc = tcfg_of(jcfg, "reference" if impl == "reference" else "cuda")
    jparams, tree = bridged_params(jcfg)
    tparams = params_from_numpy(tree, tc, device="cpu")

    jpools = [jax_init_paged_pool(jc, jc.n_layers, N_PAGES, PS)]
    tpools = [init_paged_pool(tc, tc.n_layers, N_PAGES, PS)]
    table_np = np.asarray([[3, 7, 1, 9, 2, 11, 5, 4]], np.int32)
    jtable, ttable = jnp.asarray(table_np), torch.from_numpy(table_np)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, jc.vocab_size, size=37).astype(np.int32)

    jprefill = jax.jit(lambda p, pools, t, toks, p0, tl: jax_prefill_chunk_paged(p, jc, pools, t, toks, p0, tl))
    for start, stop, width in ((0, 21, 24), (21, 37, 16)):
        toks = np.zeros((1, width), np.int32)
        toks[0, : stop - start] = ids[start:stop]
        p0 = np.asarray([start], np.int32)
        tl = np.asarray([stop - start], np.int32)
        jl, jpools = jprefill(jparams, jpools, jtable, jnp.asarray(toks), jnp.asarray(p0), jnp.asarray(tl))
        tl_ = prefill_chunk_paged(tparams, tc, tpools, ttable, torch.from_numpy(toks),
                                  torch.from_numpy(p0), torch.from_numpy(tl))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[0][name].numpy(), np.asarray(jpools[0][name]),
                                   rtol=1e-5, atol=1e-5)

    n = len(ids)
    kv_np = np.where(np.arange(MP * PS) < n, np.arange(MP * PS), -1).astype(np.int32)[None]
    jkv, tkv = jnp.asarray(kv_np), torch.from_numpy(kv_np.copy())
    jdecode = jax.jit(lambda p, pools, t, kv, tok, pos: jax_decode_step_paged(p, jc, pools, t, kv, tok, pos))
    jtok = ttok = int(np.asarray(jl)[0].argmax())
    for step in range(16):
        pos = np.asarray([n + step], np.int32)
        jlog, jpools, jkv = jdecode(jparams, jpools, jtable, jkv, jnp.asarray([[jtok]], jnp.int32),
                                    jnp.asarray(pos))
        tlog = decode_step_paged(tparams, tc, tpools, ttable, tkv,
                                 torch.tensor([[ttok]], dtype=torch.int32), torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        jtok, ttok = int(np.asarray(jlog)[0, 0].argmax()), int(tlog[0, 0].argmax())
        assert jtok == ttok, (step, jtok, ttok)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))
