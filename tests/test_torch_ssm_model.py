"""The port's SSM and hybrid models against the JAX package with the same
(bridged) weights, in f32: ``mamba2_1_3b.reduced()`` (2 mamba layers) and
``zamba2_7b.reduced(n_layers=5)`` (2 zamba groups of 2 mamba layers and
the shared attention block, then 1 trailing mamba layer).

- ``prefill`` (bucketed, ``true_len``), 8 greedy ``decode_step``s and
  ``forward_full``: logits within 1e-4 (the bound of
  tests/test_torch_dense_model.py), the SSM ``h``/``conv`` caches and the
  zamba attention caches equal;
- the engine and the service: greedy tokens and accounting equal JAX's
  on prompts that are no bucket multiple, so JAX's padded prefill (the SSM
  runs over the padding) is reproduced, not hidden; the bucket-vs-chunk
  assertion raises as JAX's does; the batched server refuses these models;
- the weight bridge: both layouts, bf16 bit-exact.

JAX runs its reference path and its Pallas kernels in interpret mode; the
port runs its reference path and its kernel path (the plain versions, on
CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mamba2_1_3b import CONFIG as JAX_MAMBA2
from repro.configs.zamba2_7b import CONFIG as JAX_ZAMBA2
from repro.models import decode_step as jax_decode_step
from repro.models import forward_full as jax_forward_full
from repro.models import init_params as jax_init_params
from repro.models import make_decode_caches as jax_make_decode_caches
from repro.models import prefill as jax_prefill
from repro.serving import BatchedServer as JaxBatchedServer
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import JaxLLMService
from repro_torch.models import (
    ModelConfig,
    decode_step,
    forward_full,
    make_decode_caches,
    params_from_numpy,
    prefill,
    supports_append,
)
from repro_torch.serving import BatchedLLMService, InferenceEngine, TorchLLMService

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 48
FIELDS = ("token_ids", "cache_hit", "reused_tokens", "prefill_tokens", "warm_start", "warm_source")
# zero-initialised leaves, perturbed so that a bug in their use shows
ZERO_INIT = ("norm", "norm1", "norm2", "final_norm", "conv_b", "dt_bias", "gate_norm", "D")

CONFIGS = {
    "mamba": lambda: JAX_MAMBA2.reduced(),
    "zamba": lambda: JAX_ZAMBA2.reduced(n_layers=5),
}


def _tcfg(jcfg, attn_impl="cuda"):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(attn_impl=attn_impl)


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in ZERO_INIT and not isinstance(v, dict) else _perturb(v, rng)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _bridged(jcfg, seed=0):
    """JAX init_params as a numpy tree with its zero-initialised leaves
    perturbed by seeded noise; returns (jax params, numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(seed), jcfg))
    tree = _perturb(tree, np.random.default_rng(seed + 100))
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _assert_caches(tcaches, jcaches):
    """Every leaf of the caches: kv_pos exactly, the rest within 1e-4."""
    tl, jl = jax.tree_util.tree_flatten_with_path(jcaches)[0], []
    def walk(c, path):
        if isinstance(c, dict):
            for k in sorted(c):
                walk(c[k], path + (k,))
        elif isinstance(c, (list, tuple)):
            for i, v in enumerate(c):
                walk(v, path + (i,))
        else:
            jl.append((path, c))
    walk(tcaches, ())
    assert len(tl) == len(jl)
    for (jpath, jv), (tpath, tv) in zip(tl, jl):
        assert tuple(tv.shape) == jv.shape, tpath
        if tpath[-1] == "kv_pos":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=str(tpath))
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), err_msg=str(tpath),
                                       **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
@pytest.mark.parametrize("family", ["mamba", "zamba"])
def test_prefill_decode_forward_match_jax(family, impl):
    """A prefill of 21 tokens padded to 32 (true_len 21), 8 greedy decode
    steps, then forward_full over the 29 tokens: logits, tokens and every
    cache agree."""
    jcfg = CONFIGS[family]().replace(attn_impl="reference" if impl == "reference" else "pallas")
    tcfg = _tcfg(jcfg, "reference" if impl == "reference" else "cuda")
    jparams, tree = _bridged(jcfg)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(1, jcfg.vocab_size, size=21).astype(np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :21] = ids
    tl = np.asarray([21], np.int32)

    jlog, jcaches, jpos = jax.jit(lambda p, t, n: jax_prefill(p, jcfg, t, MAX_LEN, true_len=n))(
        jparams, jnp.asarray(toks), jnp.asarray(tl))
    tlog, tcaches, tpos = prefill(tparams, tcfg, torch.from_numpy(toks), MAX_LEN,
                                  true_len=torch.from_numpy(tl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)
    assert tpos.tolist() == np.asarray(jpos).tolist()

    jdecode = jax.jit(lambda p, c, t, pos: jax_decode_step(p, jcfg, c, t, pos))
    seq = list(ids)
    for step in range(8):
        tok = int(np.argmax(np.asarray(jlog)[0]))
        assert tok == int(tlog[0].argmax()), step
        seq.append(tok)
        jlog, jcaches = jdecode(jparams, jcaches, jnp.asarray([[tok]], jnp.int32), jpos)
        tlog, tcaches = decode_step(tparams, tcfg, tcaches, torch.tensor([[tok]]), tpos)
        jlog, tlog, jpos, tpos = jlog[:, 0], tlog[:, 0], jpos + 1, tpos + 1
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), err_msg=str(step),
                                   **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)

    full = np.asarray([seq + [0] * 3], np.int32)          # 29 + 3 -> 32 rows (chunk 16)
    jf, _ = jax.jit(lambda p, t: jax_forward_full(p, jcfg, t))(jparams, jnp.asarray(full))
    tf, aux = forward_full(tparams, tcfg, torch.from_numpy(full))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("family", ["mamba", "zamba"])
def test_decode_caches_match_jax_layout(family):
    jcfg = CONFIGS[family]()
    tc = make_decode_caches(_tcfg(jcfg), 2, MAX_LEN, device="cpu")
    jc = jax_make_decode_caches(jcfg, 2, MAX_LEN)
    assert (jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tc)
            == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jc))
    assert not supports_append(_tcfg(jcfg))


def _engines(jcfg, max_len, **kw):
    jeng = JaxEngine.create(jcfg, seed=0, max_len=max_len, **kw)
    tcfg = _tcfg(jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jeng.params), tcfg,
                                device="cpu")
    teng = InferenceEngine.create(tcfg, max_len=max_len, device="cpu", params=tparams, **kw)
    assert teng.session_pool is None and jeng.session_pool is None
    return jeng, teng


@pytest.mark.parametrize("family", ["mamba", "zamba"])
def test_engine_matches_jax_padding_included(family):
    """Keyed and keyless turns of 48, 37 and 100 tokens (buckets 64, 64,
    128): every turn a full prefill (no pool), tokens and accounting equal
    JAX's. JAX pads the prompt to the bucket and the SSM runs over the
    padding; the port does the same, so the 48-token turn's tokens differ
    from those of an exact-length prefill."""
    jcfg = CONFIGS[family]()
    jeng, teng = _engines(jcfg, 160)
    rng = np.random.default_rng(5)
    V = jcfg.vocab_size
    for n, key in ((48, "a"), (37, None), (100, "a")):
        ids = rng.integers(8, V, size=n).tolist()
        j = jeng.generate_ex(ids, max_new_tokens=8, cache_key=key)
        t = teng.generate_ex(ids, max_new_tokens=8, cache_key=key)
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), (n, f, getattr(t, f), getattr(j, f))
        assert not t.cache_hit and t.prefill_tokens == n
        if n == 48 and family == "mamba":
            exact = _exact_greedy(teng, ids, 8)
            assert exact[0] == t.token_ids[0] and exact != t.token_ids, (exact, t.token_ids)


def _exact_greedy(eng, ids, n_new):
    """Greedy tokens of an unpadded prefill of ``ids``, then decode."""
    logits, caches, pos = prefill(eng.params, eng.cfg, torch.tensor([ids]), eng.max_len)
    out = []
    for _ in range(n_new):
        tok = int(logits[0].argmax())
        out.append(tok)
        logits, caches = decode_step(eng.params, eng.cfg, caches, torch.tensor([[tok]]), pos)
        logits, pos = logits[:, 0], pos + 1
    return out


def test_service_matches_jax():
    """Two turns of one session through JaxLLMService and TorchLLMService:
    the same capabilities (as JAX's: prime and kv_reuse follow the flag,
    though these models get no pool), texts, tokens and accounting."""
    jcfg = JAX_MAMBA2.reduced()
    jsvc = JaxLLMService.create("m", jcfg, seed=0, max_len=256)
    tsvc = TorchLLMService.create(
        "m", _tcfg(jcfg), max_len=256, device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jsvc.engine.params),
                                 _tcfg(jcfg), device="cpu"),
    )
    assert dataclasses.asdict(tsvc.capabilities()) == dataclasses.asdict(jsvc.capabilities())
    rng = np.random.default_rng(6)
    ctx = rng.integers(8, jcfg.vocab_size, size=70).tolist()
    for turn in range(2):
        prompt = rng.integers(8, jcfg.vocab_size, size=13 + 20 * turn).tolist()
        j = jsvc.completion(ctx, prompt, 10, cache_key="s")
        t = tsvc.completion(ctx, prompt, 10, cache_key="s")
        for f in ("text", "token_ids", "cache_hit", "reused_tokens", "prefill_tokens",
                  "warm_start", "warm_source"):
            assert getattr(t, f) == getattr(j, f), (turn, f)
        ctx = ctx + prompt + j.token_ids
    assert tsvc.prime("s", ctx) is jsvc.prime("s", ctx) is False


def test_bucket_vs_chunk_assertion_like_jax():
    """With ssm_chunk 128 and the default bucket 64, a 100-token prompt
    (bucket 128) serves and a 150-token one (bucket 192) raises JAX's
    assertion (192, 128) on both engines; bucket=128 serves it."""
    jcfg = JAX_MAMBA2.reduced(ssm_chunk=128)
    jeng, teng = _engines(jcfg, 256)
    rng = np.random.default_rng(7)
    ok = rng.integers(8, jcfg.vocab_size, size=100).tolist()
    assert (teng.generate_ex(ok, max_new_tokens=3).token_ids
            == jeng.generate_ex(ok, max_new_tokens=3).token_ids)
    bad = rng.integers(8, jcfg.vocab_size, size=150).tolist()
    with pytest.raises(AssertionError) as jerr:
        jeng.generate_ex(bad, max_new_tokens=3)
    with pytest.raises(AssertionError) as terr:
        teng.generate_ex(bad, max_new_tokens=3)
    assert terr.value.args == jerr.value.args == ((192, 128),)
    big = InferenceEngine.create(teng.cfg, max_len=256, bucket=128, device="cpu",
                                 params=teng.params)
    assert len(big.generate_ex(bad, max_new_tokens=3).token_ids) == 3


@pytest.mark.parametrize("family", ["mamba", "zamba"])
def test_batched_server_refuses_like_jax(family):
    jcfg = CONFIGS[family]()
    with pytest.raises(AssertionError):
        JaxBatchedServer(jcfg, None)
    with pytest.raises(NotImplementedError):
        BatchedLLMService.create("m", _tcfg(jcfg), device="cpu")


@pytest.mark.parametrize("family", ["mamba", "zamba"])
def test_weight_bridge_bf16_bit_exact(family):
    """A bf16 model's every leaf crosses bit for bit: the mamba stack
    un-stacked per layer, the zamba stack per (group, layer), and the
    shared attention block as one dict."""
    jcfg = CONFIGS[family]().replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(1), jcfg))
    tp = params_from_numpy(tree, _tcfg(jcfg), device="cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        else:
            yield path, t

    n = 0
    for (gi, spec_group), tg in zip(enumerate(tree["groups"]), tp["groups"]):
        for path, arr in leaves(spec_group):
            for idx in np.ndindex(*arr.shape[: 2 if family == "zamba" and gi == 0 else 1]):
                layer = tg
                for i in idx:
                    layer = layer[i]
                for k in path:
                    layer = layer[k]
                _bit_equal(layer, arr[idx], (gi, idx, path))
                n += 1
    for path, arr in leaves(tree["embed"]):
        _bit_equal(tp["embed"][path[0]], arr, path)
    if family == "zamba":
        for path, arr in leaves(tree["shared_attn"]):
            t = tp["shared_attn"]
            for k in path:
                t = t[k]
            _bit_equal(t, arr, path)
    assert n > 0


def _bit_equal(t, a, where):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape, where
    if a.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16, where
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16),
                                      err_msg=str(where))
    else:
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(where))
