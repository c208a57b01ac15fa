"""The split walk that K2 (shared prefix) and K5 (flash decode) share on the
card, held to the JAX package on the CPU: the host's split planner, and the
merge by which a cluster combines its blocks' partial softmax states.

The run or cache is cut into 1-8 splits exactly as the kernels cut it
(``split_ranges``, whole 128-token tiles, some splits empty); each split's
state comes from the port's plain versions restricted to its tokens
(``shared_prefix_ref(span=...)``, ``decode_stats_ref(span=...)``), and
``merge_stats`` of them must equal the Pallas kernels in interpret mode on
the same numpy inputs, including lanes whose whole run is masked. f32,
rtol = atol = 1e-5: the same products, summed in another order."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.kernel import decode_attention_pallas as jax_k5
from repro.kernels.paged_attention.kernel import shared_prefix_pallas as jax_k2
from repro_torch.kernels.decode_attention.kernel import decode_plan
from repro_torch.kernels.decode_attention.ref import decode_stats_ref
from repro_torch.kernels.paged_attention.kernel import (
    MAX_SPLITS,
    SPLIT_TILE,
    TARGET_BLOCKS,
    plan_splits,
    shared_prefix_plan,
    split_ranges,
)
from repro_torch.kernels.paged_attention.ref import NEG_INF, merge_stats, shared_prefix_ref

TOL = dict(rtol=1e-5, atol=1e-5)
SPLITS = list(range(1, MAX_SPLITS + 1))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 128, 129, 320, 1024, 1250, 2048])
def test_split_ranges_cover_every_token_once(n):
    """For every split count the ranges tile [0, n) in order, each split a
    run of whole 128-token tiles; with no more splits than tiles none is
    empty."""
    tiles = -(-n // SPLIT_TILE)
    for splits in SPLITS:
        ranges = split_ranges(n, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2
        for lo, hi in ranges:
            assert lo <= hi and lo % SPLIT_TILE == 0
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        assert np.array_equal(covered, np.arange(n))
        if splits <= tiles:
            assert all(hi > lo for lo, hi in ranges), (n, splits, ranges)


def test_plan_splits_rule():
    """A power of two of at most 8, at most the tile count, the smallest
    that brings the grid to TARGET_BLOCKS when those caps allow."""
    for blocks in range(1, 300, 7):
        for n in (1, 100, 128, 200, 640, 1024, 2048, 8192):
            s = plan_splits(blocks, n)
            tiles = -(-n // SPLIT_TILE)
            assert s in (1, 2, 4, 8)
            assert s <= max(1, tiles)
            if s > 1:
                assert blocks * (s // 2) < TARGET_BLOCKS
            if blocks * s < TARGET_BLOCKS:
                assert s == MAX_SPLITS or 2 * s > tiles
            assert all(hi > lo for lo, hi in split_ranges(n, s))


def test_plan_main_path_shapes():
    """The grids of the main path: the grid's first axis is the cluster
    axis and holds exactly `splits` blocks."""
    # K2, the batched server: 8 lanes of G = 1 x 64 past a 64-page run
    assert shared_prefix_plan(8, 16, 1, 64, 64 * 16) == (8, 8, (8, 16, 1))
    # K2 at 64 lanes: two lane tiles of 32
    assert shared_prefix_plan(64, 16, 1, 64, 1024) == (32, 4, (4, 16, 2))
    # K2 at GQA G = 8 x 128: one lane per block
    assert shared_prefix_plan(3, 2, 8, 128, 1024) == (2, 8, (8, 2, 2))
    # K5: paper model B = 1 and 8 over 2048 slots, Zamba2 B = 1 (32 heads)
    assert decode_plan(1, 16, 2048) == (8, (8, 16, 1))
    assert decode_plan(8, 16, 2048) == (1, (1, 16, 8))
    assert decode_plan(1, 32, 2048) == (4, (4, 32, 1))
    # a short cache: one tile, one split
    assert decode_plan(1, 16, 100) == (1, (1, 16, 1))
    for (s, kvh, z) in ((8, 16, 1), (4, 32, 1)):
        assert s * kvh * z == 128


# ---------------------------------------------------------------------------
# the merge, against the Pallas kernels
# ---------------------------------------------------------------------------

def _k2_inputs(seed, n_shared, suffixes, ps, H, KV, Dh):
    """A run of ``n_shared`` pages every lane's table starts with; lane b's
    query sits at ``n_shared * ps + suffixes[b] - 1`` (negative: inside the
    run)."""
    rng = np.random.default_rng(seed)
    B = len(suffixes)
    q = rng.standard_normal((B, KV, H // KV, Dh)).astype(np.float32)
    pool_k = rng.standard_normal((1 + n_shared, ps, KV, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((1 + n_shared, ps, KV, Dh)).astype(np.float32)
    shared = np.arange(1, 1 + n_shared, dtype=np.int32)
    q_pos = np.asarray([n_shared * ps + s - 1 for s in suffixes], np.int32)
    return q, pool_k, pool_v, shared, q_pos


K2_CASES = {
    # 20 pages of 16 = 320 tokens = 3 tiles; queries inside and past the run
    "gqa": (dict(n_shared=20, suffixes=(-200, -129, 0, 1, 40), ps=16, H=8, KV=2, Dh=16),
            dict(window=0, softcap=0.0)),
    # window 60 masks the last lane's whole run and most of the others'
    "window-cap": (dict(n_shared=20, suffixes=(-200, -1, 17, 77), ps=16, H=4, KV=4, Dh=32),
                   dict(window=60, softcap=8.0)),
}


@functools.lru_cache(maxsize=None)
def _k2_case(name):
    shape, kw = K2_CASES[name]
    args = _k2_inputs(0, **shape)
    want = jax_k2(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    return args, kw, [np.asarray(w) for w in want], shape["n_shared"] * shape["ps"]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", list(K2_CASES))
def test_merged_k2_splits_match_pallas(case, splits):
    """K2's split walk: the merged states of every split of the run equal
    shared_prefix_pallas's (acc, m, l), empty splits and masked lanes
    included."""
    args, kw, want, n = _k2_case(case)
    targs = [torch.from_numpy(a) for a in args]
    parts = [shared_prefix_ref(*targs, span=r, **kw) for r in split_ranges(n, splits)]
    got = merge_stats(parts)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    if kw["window"]:
        # the last lane's whole run is masked: exactly the empty state
        assert (got[1][-1] == NEG_INF).all() and (got[2][-1] == 0).all()
        assert (got[0][-1] == 0).all()


def _k5_inputs(seed, lens, T, H, KV, Dh):
    """Lane b holds ``lens[b]`` valid slots from slot 0 and queries at
    ``lens[b] - 1``; a lane of length 0 has no valid slot at all."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, KV, H // KV, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    slot = np.arange(T, dtype=np.int32)[None, :].repeat(B, 0)
    valid = (slot < np.asarray(lens)[:, None]).astype(np.int32)
    kv_pos = np.where(valid != 0, slot, -1).astype(np.int32)
    q_pos = np.asarray([max(n - 1, 0) for n in lens], np.int32)
    return q, k, v, q_pos, kv_pos, valid


K5_CASES = {
    # T = 320: 3 tiles; lanes of 1, 129 (a tile boundary), 300 slots, and none
    "gqa": (dict(lens=(1, 129, 300, 0), T=320, H=8, KV=2, Dh=32), dict(window=0, softcap=0.0)),
    "d112-window-cap": (dict(lens=(70, 250, 320, 0), T=320, H=2, KV=2, Dh=112),
                        dict(window=100, softcap=30.0)),
}


@functools.lru_cache(maxsize=None)
def _k5_case(name):
    shape, kw = K5_CASES[name]
    q, k, v, q_pos, kv_pos, valid = args = _k5_inputs(1, **shape)
    want = jax_k5(*(jnp.asarray(a) for a in (q, k, v, q_pos[:, None], kv_pos, valid)),
                  block_k=64, interpret=True, **kw)
    return args, kw, np.asarray(want), shape["T"]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", list(K5_CASES))
def test_merged_k5_splits_match_pallas(case, splits):
    """K5's split walk: the merged state of every split of the cache,
    normalised as the cluster's writers normalise it, equals
    decode_attention_pallas's output on every lane that sees a key. The
    lane with no valid slot keeps the empty state and gives exact zeros,
    the port's convention (JAX's kernel gives the mean of V there; no
    caller reads such a row)."""
    args, kw, want, T = _k5_case(case)
    targs = [torch.from_numpy(a) for a in args]
    parts = [decode_stats_ref(*targs, span=r, **kw) for r in split_ranges(T, splits)]
    acc, m, l = merge_stats(parts)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    np.testing.assert_allclose(out[:-1].numpy(), want[:-1], **TOL)
    assert (m[-1] == NEG_INF).all() and (l[-1] == 0).all() and (out[-1] == 0).all()


def test_merge_stats_empty_parts_add_nothing():
    """Empty parts (m = -1e30, l = 0, acc = 0) anywhere in the order leave
    the merge bit-identical, and parts that are all empty merge to the
    empty state with no NaN."""
    args, kw, _, n = _k2_case("gqa")
    targs = [torch.from_numpy(a) for a in args]
    whole = shared_prefix_ref(*targs, **kw)
    empty = tuple(torch.full_like(t, NEG_INF) if i == 1 else torch.zeros_like(t)
                  for i, t in enumerate(whole))
    for parts in ([empty, whole], [whole, empty, empty], [empty, whole, empty]):
        got = merge_stats(parts)
        for g, w in zip(got, merge_stats([whole])):
            assert torch.equal(g, w)
    acc, m, l = merge_stats([empty] * 8)
    assert (m == NEG_INF).all() and (l == 0).all() and (acc == 0).all()
    assert torch.isfinite(acc).all()
