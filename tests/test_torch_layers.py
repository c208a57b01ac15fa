"""The port's layers, paged-cache writers and weight bridge against their
JAX twins, on the same numpy-seeded inputs (f32, rtol = atol = 1e-5 for
the layers; exact for the cache writes and the bridge)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_qwen15_0_5b import CONFIG as JAX_PAPER
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import init_params as jax_init_params
from repro_torch.models import ModelConfig, attention, cache, layers, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _tcfg(jcfg):
    """The port's ModelConfig with the JAX config's fields."""
    return ModelConfig(**dataclasses.asdict(jcfg))


def tensor_to_numpy(t):
    """The bridge in reverse: bf16 comes back as its raw uint16 bits."""
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **(tol or TOL))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-5), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_standard(rng, theta):
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    _close(layers.rope_standard(_t(x), _t(pos), theta),
           jlayers.rope_standard(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rope_other_styles_raise(tiny_dense_cfg):
    """Every rope style of the JAX package is ported (standard, chatglm2d,
    mrope: ``tests/test_torch_rope.py``); any other raises ValueError, as
    JAX's ``apply_rope`` does."""
    cfg = _tcfg(tiny_dense_cfg).replace(rope_style="yarn")
    jcfg = tiny_dense_cfg.replace(rope_style="yarn")
    with pytest.raises(ValueError):
        layers.apply_rope(cfg, torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        jlayers.apply_rope(jcfg, jnp.zeros((1, 1, 4, 16)), jnp.zeros((1, 1), jnp.int32))


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_forward(tiny_dense_cfg, rng, mlp_type):
    jcfg = tiny_dense_cfg.replace(mlp_type=mlp_type)
    p = jax.tree_util.tree_map(np.asarray, jlayers.init_mlp(jax.random.key(1), jcfg))
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    ours = layers.mlp_forward({k: _t(v) for k, v in p.items()}, _t(x), _tcfg(jcfg))
    _close(ours, jlayers.mlp_forward(p, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("tie,softcap", [(True, 0.0), (False, 30.0)])
def test_embed_unembed(tiny_dense_cfg, rng, tie, softcap):
    jcfg = tiny_dense_cfg.replace(tie_embeddings=tie, logit_softcap=softcap)
    p = jax.tree_util.tree_map(np.asarray, jlayers.init_embed(jax.random.key(2), jcfg))
    p["final_norm"] = (0.1 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    tcfg = _tcfg(jcfg)
    emb = layers.embed_tokens(tp, _t(toks), tcfg)
    _close(emb, jlayers.embed_tokens(p, jnp.asarray(toks), jcfg), rtol=0, atol=0)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    _close(layers.unembed(tp, _t(x), tcfg), jlayers.unembed(p, jnp.asarray(x), jcfg))


def _attn_params(jcfg, rng):
    """JAX-initialised attention weights, with the zero-initialised biases
    perturbed so a bias bug cannot hide."""
    p = jax.tree_util.tree_map(np.asarray, jattn.init_attention(jax.random.key(3), jcfg))
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = (0.1 * rng.standard_normal(p[b].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("which", ["tiny_gqa", "paper_mha_bias"])
def test_qkv_and_kv_step_projection(tiny_dense_cfg, rng, which):
    jcfg = tiny_dense_cfg if which == "tiny_gqa" else JAX_PAPER.reduced()
    tcfg = _tcfg(jcfg)
    p = _attn_params(jcfg, rng)
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = (np.arange(6)[None, :] + np.array([[0], [40]])).astype(np.int32)
    for ours, theirs in zip(attention.qkv_project(tp, _t(x), _t(pos), tcfg),
                            jattn.qkv_project(p, jnp.asarray(x), jnp.asarray(pos), jcfg)):
        _close(ours, theirs)
    x1, p1 = x[:, :1], pos[:, :1]
    for ours, theirs in zip(attention.project_kv_step(tp, _t(x1), _t(p1), tcfg),
                            jattn.project_kv_step(p, jnp.asarray(x1), jnp.asarray(p1), jcfg)):
        _close(ours, theirs)
    _close(attention._project_q_step(tp, _t(x1), _t(p1), tcfg),
           jattn._project_q_step(p, jnp.asarray(x1), jnp.asarray(p1), jcfg))


# ---------------------------------------------------------------------------
# Paged cache writes: the same drops as JAX's mode="drop" scatters, in place
# ---------------------------------------------------------------------------

def _pool(rng, n_pages, ps, kv=2, dh=8):
    k = rng.standard_normal((n_pages, ps, kv, dh)).astype(np.float32)
    return k, k + 1.0


def test_paged_write_step_drops_at_capacity(rng):
    """tests/test_paged_kv.py:131 on both packages: the last in-range
    position lands in the last page's tail cell; the at-capacity write is
    dropped, leaving every page (the scratch page too) untouched."""
    ps, n_pages = 4, 8
    pk, pv = _pool(rng, n_pages, ps)
    table = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    k_new = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
    for pos in ([11, 5], [12, 11], [13, 12]):
        pos = np.asarray(pos, np.int32)
        jk, jv = jcache.paged_write_step(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(k_new),
                                          jnp.asarray(k_new + 2), jnp.asarray(pos),
                                          jnp.asarray(table), ps)
        tk, tv = _t(pk), _t(pv)
        cache.paged_write_step(tk, tv, _t(k_new), _t(k_new + 2), _t(pos), _t(table), ps)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_skip", [0, 1])
@pytest.mark.parametrize("p0,true_len", [(0, 5), (6, 8), (9, 6)])
def test_paged_write_chunk_drops(rng, n_skip, p0, true_len):
    """Padding rows, positions past the table and writes into the first
    n_skip pages are dropped exactly as JAX drops them."""
    ps, n_pages, S = 4, 8, 8
    pk, pv = _pool(rng, n_pages, ps)
    table = np.asarray([[1, 2, 3]], np.int32)           # 12 slots
    k_new = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    q_pos = (p0 + np.arange(S))[None, :].astype(np.int32)
    valid = (np.arange(S) < true_len)[None, :]
    jk, jv = jcache.paged_write_chunk(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(k_new),
                                       jnp.asarray(-k_new), jnp.asarray(q_pos),
                                       jnp.asarray(valid), jnp.asarray(table), ps, n_skip=n_skip)
    tk, tv = _t(pk), _t(pv)
    cache.paged_write_chunk(tk, tv, _t(k_new), _t(-k_new), _t(q_pos), _t(valid), _t(table),
                            ps, n_skip=n_skip)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kv_pos_update_drops_at_capacity():
    """tests/test_paged_kv.py:158: the at-capacity position update is
    dropped, an in-range one lands."""
    kv_pos = torch.arange(8, dtype=torch.int32)[None, :].repeat(2, 1)
    kv_pos[1, 5:] = -1
    cache.update_kv_pos_paged(kv_pos, torch.tensor([8, 5], dtype=torch.int32))
    assert kv_pos[0].tolist() == list(range(8))
    assert kv_pos[1].tolist() == [0, 1, 2, 3, 4, 5, -1, -1]


def test_gather_pages_matches_jax(rng):
    pk, _ = _pool(rng, 6, 4)
    table = np.asarray([[2, 5, 0], [1, 3, 4]], np.int32)
    _close(cache.gather_pages(_t(pk), _t(table)), jcache.gather_pages(jnp.asarray(pk), jnp.asarray(table)),
           rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------

def test_bf16_bridge_round_trip_is_bit_exact():
    """The full bf16 pytree (paper model, reduced) crosses into torch and
    back bit for bit, with each group's L axis un-stacked."""
    import ml_dtypes

    jcfg = JAX_PAPER.reduced(param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(0), jcfg))
    params = params_from_numpy(tree, _tcfg(jcfg), device="cpu")
    assert params["embed"]["tok"].dtype == torch.bfloat16
    assert "lm_head" not in params["embed"]  # tied
    for name, a in tree["embed"].items():
        back = tensor_to_numpy(params["embed"][name]).view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
    group = tree["groups"][0]
    layers_ = params["groups"][0]
    assert len(layers_) == jcfg.n_layers
    for i, lp in enumerate(layers_):
        for sub in ("attn", "mlp"):
            for name, a in group[sub].items():
                back = tensor_to_numpy(lp[sub][name])
                np.testing.assert_array_equal(back, a[i].view(np.uint16))
        for name in ("norm1", "norm2"):
            np.testing.assert_array_equal(tensor_to_numpy(lp[name]), group[name][i].view(np.uint16))
