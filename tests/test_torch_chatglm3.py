"""ChatGLM3-6B in the port against the JAX package: ``chatglm3_6b.
reduced()`` (GQA 4/2 x 64, QKV bias, RoPE on the first half of each head)
with bridged weights through ``forward_full``, ``prefill``,
``prefill_append`` and ``decode_step`` (the dense route), and
``prefill_chunk_paged`` and ``decode_step_paged`` (the paged route), on the
port's plain path and its kernel path; engine turns on both routes and a
batched wave on both servers with JAX's greedy tokens and reuse; and
``launch.serve --arch chatglm3-6b``. At full width chatglm3's G * Dh is
16 x 128 = 2048, so K1 and K5 cut each KV head into two row groups: their
planners are checked here, the kernels on the card (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_family import (
    IMPLS,
    bridged,
    check_batched_wave,
    check_dense_functions,
    check_engine_turns,
    check_launcher,
    check_paged_functions,
    close,
    tcfg_of,
    torch_params,
)
from repro.configs.chatglm3_6b import CONFIG as JAX_CHATGLM3
from repro.models import forward_full as jax_forward_full
from repro_torch.configs import CHATGLM3_6B
from repro_torch.kernels.decode_attention.kernel import decode_plan
from repro_torch.kernels.paged_attention.kernel import paged_plan, row_groups
from repro_torch.models import forward_full

JCFG = JAX_CHATGLM3.reduced()


def test_reduced_config_keeps_chatglm3s_switches():
    cfg = CHATGLM3_6B.reduced()
    assert (cfg.rope_style, cfg.qkv_bias, cfg.n_heads, cfg.n_kv_heads) == ("chatglm2d", True, 4, 2)
    full = CHATGLM3_6B
    assert full.group_size * full.d_head == 2048


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_full_matches_jax(impl):
    """Two lanes, one padded (ragged ``seq_valid``): logits of the valid
    rows equal JAX's."""
    tc = tcfg_of(JCFG, impl)
    jparams, tree = bridged(JCFG)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, JCFG.vocab_size, size=(2, 37)).astype(np.int32)
    sv = np.arange(37)[None, :] < np.asarray([37, 20])[:, None]
    jlog, _ = jax_forward_full(jparams, JCFG, jnp.asarray(toks), seq_valid=jnp.asarray(sv))
    tlog, aux = forward_full(torch_params(tree, tc), tc, torch.from_numpy(toks),
                             seq_valid=torch.from_numpy(sv))
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], rtol=1e-4, atol=1e-4)


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


def test_serve_launcher_serves_chatglm3(monkeypatch, capsys):
    check_launcher("chatglm3-6b", monkeypatch, capsys, kv_heads=2)


def test_k1_k5_row_groups_at_g_dh_2048():
    """K1 and K5 hold at most 1024 / Dh query rows per block: chatglm3's
    16 rows of 128 are two groups of 8, each its own cluster (grid y = KV x
    groups); the split count then counts the groups' blocks too."""
    assert row_groups(16, 128) == (2, 8)
    assert row_groups(7, 128) == (1, 7)
    assert row_groups(8, 128) == (1, 8)
    assert row_groups(12, 128) == (2, 6)
    assert row_groups(9, 112) == (1, 9)
    assert row_groups(10, 112) == (2, 5)
    assert row_groups(32, 64) == (2, 16)
    # chatglm3 at B = 1: 2 KV heads x 2 groups = 4 clusters of 8 splits
    assert paged_plan(1, 2, 128, 16, 0, 2) == (8, (8, 4, 1))
    assert decode_plan(1, 2, 2048, 2) == (8, (8, 4, 1))
    assert decode_plan(8, 2, 2048, 2) == (4, (4, 4, 8))
    assert decode_plan(1, 16, 2048) == (8, (8, 16, 1))
