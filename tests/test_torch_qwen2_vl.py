"""Qwen2-VL-7B in the port against the JAX package: ``qwen2_vl_7b.
reduced()`` (M-RoPE sections 8/12/12, 4 heads x 64, QKV bias, 16 patch
embeddings of the stub vision frontend) with bridged weights. The
multimodal inputs: ``forward_full`` and ``prefill`` with three different
(t, h, w) position streams over a 4 x 4 patch grid, ``patch_embeds`` and
ragged ``seq_valid``, then decode from there. Text serving broadcasts one
stream to all three (where M-RoPE equals standard RoPE): the dense and
paged model functions on the port's plain and kernel paths, engine turns
on both routes, a batched wave on both servers, ``launch.serve --arch
qwen2-vl-7b``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_family import (
    IMPLS,
    assert_caches,
    bridged,
    check_batched_wave,
    check_dense_functions,
    check_engine_turns,
    check_launcher,
    check_paged_functions,
    close,
    decode_greedy,
    tcfg_of,
    torch_params,
)
from repro.configs.qwen2_vl_7b import CONFIG as JAX_QWEN2_VL
from repro.models import forward_full as jax_forward_full
from repro.models import prefill as jax_prefill
from repro_torch.configs import QWEN2_VL_7B
from repro_torch.models import forward_full, prefill

JCFG = JAX_QWEN2_VL.reduced()
GRID = 4          # the reduced config's 16 patches: a 4 x 4 grid


def vision_inputs(b, s, seed=5):
    """Token ids (B, S), M-RoPE positions (3, B, S) and patch embeddings
    (B, 16, D): the patches take the first 16 rows at t = 0, h = row,
    w = column (three different streams); the text after them continues
    from GRID on every stream, as Qwen2-VL numbers a prompt after an
    image."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, JCFG.vocab_size, size=(b, s)).astype(np.int32)
    n = JCFG.n_patches
    assert n == GRID * GRID
    i = np.arange(n)
    text = GRID + np.arange(s - n)
    pos = np.stack([np.concatenate([np.zeros(n), text]),
                    np.concatenate([i // GRID, text]),
                    np.concatenate([i % GRID, text])]).astype(np.int32)
    positions = np.broadcast_to(pos[:, None], (3, b, s)).copy()
    patches = rng.standard_normal((b, n, JCFG.d_model)).astype(np.float32)
    return toks, positions, patches


def test_reduced_config_keeps_the_vlm_switches():
    cfg = QWEN2_VL_7B.reduced()
    assert (cfg.arch_type, cfg.rope_style, cfg.frontend) == ("vlm", "mrope", "vision")
    assert sum(cfg.mrope_sections) * 2 == cfg.d_head and cfg.n_patches == 16
    assert sum(QWEN2_VL_7B.mrope_sections) * 2 == QWEN2_VL_7B.d_head == 128


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_full_with_patches_and_three_streams_matches_jax(impl):
    """Positions (3, B, S) with three different streams, patch embeddings
    over the first 16 rows and a padded second lane: JAX's logits. The
    same call with one stream broadcast gives other logits (the streams
    reach the attention)."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG)
    tparams = torch_params(tree, tc)
    toks, positions, patches = vision_inputs(2, 40)
    sv = np.arange(40)[None, :] < np.asarray([40, 29])[:, None]
    jlog, _ = jax_forward_full(jparams, JCFG, jnp.asarray(toks), positions=jnp.asarray(positions),
                               patch_embeds=jnp.asarray(patches), seq_valid=jnp.asarray(sv))
    tlog, _ = forward_full(tparams, tc, torch.from_numpy(toks),
                           positions=torch.from_numpy(positions),
                           patch_embeds=torch.from_numpy(patches), seq_valid=torch.from_numpy(sv))
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], rtol=1e-4, atol=1e-4)
    flat, _ = forward_full(tparams, tc, torch.from_numpy(toks),
                           patch_embeds=torch.from_numpy(patches), seq_valid=torch.from_numpy(sv))
    assert (flat - tlog).abs().max() > 1e-2


@pytest.mark.parametrize("impl", IMPLS)
def test_vision_prefill_then_decode_matches_jax(impl):
    """``prefill`` of a 16-patch image plus 24 text tokens with the three
    streams, then 8 greedy text decode steps at the next positions (one
    stream broadcast): logits, tokens and caches equal JAX's."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG, seed=2)
    tparams = torch_params(tree, tc)
    toks, positions, patches = vision_inputs(1, 40, seed=6)
    jl, jcaches, _ = jax_prefill(jparams, JCFG, jnp.asarray(toks), 96,
                                 positions=jnp.asarray(positions),
                                 patch_embeds=jnp.asarray(patches))
    tl, tcaches, tpos = prefill(tparams, tc, torch.from_numpy(toks), 96,
                                positions=torch.from_numpy(positions),
                                patch_embeds=torch.from_numpy(patches))
    close(tl, jl)
    assert_caches(tcaches, jcaches)
    # the cache slots are the sequence's rows; decode continues at row 40
    assert int(tpos[0]) == 40
    decode_greedy(jparams, JCFG, tparams, tc, jcaches, tcaches, int(np.asarray(jl)[0].argmax()),
                  40, 8)


@pytest.mark.parametrize("impl", IMPLS)
def test_dense_prefill_append_decode_match_jax(impl):
    check_dense_functions(JCFG, impl, max_len=48)


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_prefill_and_decode_match_jax(impl):
    check_paged_functions(JCFG, impl)


@pytest.mark.parametrize("route", ["paged", "dense"])
def test_engine_turns_match_jax(route):
    check_engine_turns(JCFG, route)


@pytest.mark.parametrize("paged", [True, False])
def test_batched_wave_matches_jax(paged):
    check_batched_wave(JCFG, paged)


def test_serve_launcher_serves_qwen2_vl(monkeypatch, capsys):
    check_launcher("qwen2-vl-7b", monkeypatch, capsys, kv_heads=4)
