"""The port's RoPE styles against the JAX package's (``repro.models.
layers``): ChatGLM's 2D RoPE (rotary on the first half of each head, in
JAX's half-split form), Qwen2-VL's M-RoPE with three different position
streams, and ``apply_rope``'s dispatch by ``cfg.rope_style``; in f32 and
bf16, from the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ModelConfig as JaxModelConfig
from repro.models import layers as jlayers
from repro_torch.models import layers
from test_torch_model import tcfg_of

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _both(x, dtype):
    """(torch tensor, jax array) of the same values in ``dtype``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def _close(t, j, dtype):
    got, want = t.float().numpy(), np.asarray(j.astype(jnp.float32))
    if dtype == "bfloat16":
        # both round the same f32 rotation to bf16: equal but for a tie
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


def _streams(rng, b, s):
    """Three different (t, h, w) position streams (3, B, S)."""
    t = np.sort(rng.integers(0, 50, size=(b, s)), axis=1)
    return np.stack([t, t + rng.integers(0, 9, size=(b, s)),
                     rng.integers(0, 3000, size=(b, s))]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_chatglm2d_matches_jax(theta, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 9)).astype(np.int32)
    tx, jx = _both(x, dtype)
    got = layers.rope_chatglm2d(tx, torch.from_numpy(pos), theta)
    _close(got, jlayers.rope_chatglm2d(jx, jnp.asarray(pos), theta), dtype)
    # the second half of every head passes through untouched
    assert torch.equal(got[..., 32:], tx[..., 32:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,dh", [((8, 12, 12), 64), ((16, 24, 24), 128)])
def test_rope_mrope_matches_jax_with_three_streams(sections, dh, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 3, dh)).astype(np.float32)
    pos3 = _streams(rng, 2, 11)
    tx, jx = _both(x, dtype)
    got = layers.rope_mrope(tx, torch.from_numpy(pos3), 1e6, sections)
    _close(got, jlayers.rope_mrope(jx, jnp.asarray(pos3), 1e6, sections), dtype)
    # each section follows its own stream: one stream broadcast differs
    flat = layers.rope_mrope(tx, torch.from_numpy(np.broadcast_to(pos3[:1], pos3.shape).copy()),
                             1e6, sections)
    assert (flat.float() - got.float()).abs().max() > 1e-2


def test_mrope_of_one_broadcast_stream_is_standard_rope():
    """Text serving broadcasts one stream to all three (``text_positions``):
    then M-RoPE equals standard RoPE, in both packages."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 7, 2, 64)).astype(np.float32)
    pos = rng.integers(0, 900, size=(1, 7)).astype(np.int32)
    cfg = tcfg_of(JaxModelConfig(
        name="m", arch_type="vlm", n_layers=1, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=8, vocab_size=8, rope_style="mrope", mrope_sections=(8, 12, 12)), "cuda")
    p3 = layers.text_positions(cfg, torch.from_numpy(pos))
    assert tuple(p3.shape) == (3, 1, 7)
    got = layers.apply_rope(cfg, torch.from_numpy(x), p3)
    np.testing.assert_allclose(got.numpy(), layers.rope_standard(
        torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta).numpy(), **F32_TOL)
    j3 = jnp.broadcast_to(jnp.asarray(pos), (3, 1, 7))
    np.testing.assert_allclose(
        np.asarray(jlayers.rope_mrope(jnp.asarray(x), j3, cfg.rope_theta, (8, 12, 12))),
        got.numpy(), **F32_TOL)
    assert layers.text_positions(cfg.replace(rope_style="standard"),
                                 torch.from_numpy(pos)).shape == (1, 7)


@pytest.mark.parametrize("style", ["standard", "chatglm2d", "mrope"])
def test_apply_rope_dispatch_matches_jax(tiny_dense_cfg, style):
    rng = np.random.default_rng(3)
    jcfg = tiny_dense_cfg.replace(rope_style=style, mrope_sections=(2, 3, 3), rope_theta=5e4)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = _streams(rng, 2, 6) if style == "mrope" else rng.integers(
        0, 700, size=(2, 6)).astype(np.int32)
    got = layers.apply_rope(tcfg_of(jcfg, "cuda"), torch.from_numpy(x), torch.from_numpy(pos))
    want = jlayers.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
