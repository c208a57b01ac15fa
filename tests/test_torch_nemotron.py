"""Nemotron-4-340B in the port against the JAX package: the config field for
field; ``nemotron_4_340b.reduced()`` (4 heads x 64, squared-ReLU MLP) and
``reduced(n_heads=12, n_kv_heads=1, d_head=192)`` — nemotron's own head
group, G = 12 query heads of d_head 192 per KV head (G * Dh = 2304) — with
bridged weights through ``forward_full``, the dense route's and the paged
route's model functions, on the port's plain path and its kernel path;
engine turns on both routes and a batched wave on both servers with JAX's
greedy tokens and reuse; ``launch.serve --arch nemotron-4-340b``; and the
kernels' planners at nemotron's full-width shapes (the kernels themselves
run on the card: ``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import dataclasses

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
    tcfg_of,
    torch_params,
)
from repro.configs.nemotron_4_340b import CONFIG as JAX_NEMOTRON
from repro.models import forward_full as jax_forward_full
from repro_torch.configs import NEMOTRON_4_340B
from repro_torch.kernels.chunked_prefill import kernel as chunk_kernel
from repro_torch.kernels.decode_attention.kernel import decode_plan
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention.kernel import (
    K2_MAX_ROWS_DH,
    MAX_G_DH,
    paged_plan,
    row_groups,
    shared_prefix_plan,
)
from repro_torch.models import forward_full

CONFIGS = {
    "reduced": JAX_NEMOTRON.reduced(),
    "g12x192": JAX_NEMOTRON.reduced(n_heads=12, n_kv_heads=1, d_head=192),
}
CFG_IDS = list(CONFIGS)


def test_config_matches_jax_field_for_field():
    assert dataclasses.asdict(NEMOTRON_4_340B) == dataclasses.asdict(JAX_NEMOTRON)
    c = NEMOTRON_4_340B
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_head) == (96, 18432, 96, 8, 192)
    assert (c.d_ff, c.vocab_size, c.mlp_type, c.arch_type) == (73728, 256000, "relu2", "dense")
    assert c.group_size * c.d_head == 2304 <= MAX_G_DH
    g = CONFIGS["g12x192"]
    assert (g.group_size, g.d_head, g.mlp_type) == (12, 192, "relu2")


@pytest.mark.parametrize("name", CFG_IDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_full_matches_jax(name, impl):
    """Two lanes, one padded (ragged ``seq_valid``): logits of the valid
    rows equal JAX's."""
    jcfg = CONFIGS[name]
    tc = tcfg_of(jcfg, impl)
    jparams, tree = bridged(jcfg)
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, size=(2, 37)).astype(np.int32)
    sv = np.arange(37)[None, :] < np.asarray([37, 20])[:, None]
    jlog, _ = jax_forward_full(jparams, jcfg, jnp.asarray(toks), seq_valid=jnp.asarray(sv))
    tlog, _ = forward_full(torch_params(tree, tc), tc, torch.from_numpy(toks),
                           seq_valid=torch.from_numpy(sv))
    np.testing.assert_allclose(tlog.numpy()[sv], np.asarray(jlog)[sv], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CFG_IDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_dense_prefill_append_decode_match_jax(name, impl):
    check_dense_functions(CONFIGS[name], impl, max_len=48)


@pytest.mark.parametrize("name", CFG_IDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_paged_prefill_and_decode_match_jax(name, impl):
    check_paged_functions(CONFIGS[name], impl)


@pytest.mark.parametrize("name", CFG_IDS)
@pytest.mark.parametrize("route", ["paged", "dense"])
def test_engine_turns_match_jax(name, route):
    check_engine_turns(CONFIGS[name], route)


@pytest.mark.parametrize("name", CFG_IDS)
@pytest.mark.parametrize("paged", [True, False])
def test_batched_wave_matches_jax(name, paged):
    check_batched_wave(CONFIGS[name], paged)


def test_serve_launcher_serves_nemotron(monkeypatch, capsys):
    check_launcher("nemotron-4-340b", monkeypatch, capsys, kv_heads=4)


def test_plans_at_nemotrons_head_group():
    """K1 and K5 hold at most 1024 / Dh = 5 rows of 192 per block: the 12
    rows of a KV head are three groups of 4, each its own cluster (grid y =
    8 KV heads x 3); K2 holds at most 2048 / 192 = 10, so two groups of 6
    with one lane per block."""
    assert row_groups(12, 192) == (3, 4)
    assert row_groups(5, 192) == (1, 5)
    assert row_groups(16, 192) == (4, 4)
    assert row_groups(12, 192, K2_MAX_ROWS_DH) == (2, 6)
    assert row_groups(5, 192, K2_MAX_ROWS_DH) == (1, 5)
    # B = 1 over a 1024-token walk: 24 clusters of 8 splits; B = 8: one each
    assert paged_plan(1, 8, 64, 16, 0, 3) == (8, (8, 24, 1))
    assert paged_plan(8, 8, 128, 16, 0, 3) == (1, (1, 24, 8))
    assert decode_plan(1, 8, 2048, 3) == (8, (8, 24, 1))
    assert decode_plan(8, 8, 2048, 3) == (1, (1, 24, 8))
    # K2: the batched wave's 8 lanes over a 512-token run, one lane and six
    # rows per block; five rows of 192 fit two lanes per block
    assert shared_prefix_plan(8, 8, 12, 192, 512) == (1, 1, (1, 16, 8))
    assert shared_prefix_plan(1, 8, 12, 192, 1024) == (1, 8, (8, 16, 1))
    assert shared_prefix_plan(8, 1, 5, 192, 512) == (2, 4, (4, 1, 4))
    # the shapes of every earlier model keep their plans
    assert shared_prefix_plan(8, 16, 1, 64, 64 * 16) == (8, 8, (8, 16, 1))
    assert shared_prefix_plan(8, 2, 16, 128, 512) == (1, 4, (4, 2, 8))


def test_head_dim_lists_take_192():
    """Every attention kernel is built for d_head 192 now; a head dim
    outside the lists (96, 256) is still refused by each wrapper."""
    for dims in (paged_kernel.HEAD_DIMS, chunk_kernel.HEAD_DIMS, flash_kernel.HEAD_DIMS):
        assert 192 in dims and 96 not in dims and 256 not in dims
