"""The split walk that K1 (paged decode), K2 (shared prefix) and K5 (flash
decode) share on the card, held to the JAX package on the CPU: the host's
split planners, and the merge by which a cluster combines its blocks'
partial softmax states.

The run or cache is cut into 1-8 splits exactly as the kernels cut it
(``split_ranges``, whole 128-token tiles, some splits empty; K1 cuts each
lane's own range on the device, mirrored by ``paged_split_ranges``); each
split's state comes from the port's plain versions restricted to its
tokens (``shared_prefix_ref(span=...)``, ``decode_stats_ref(span=...)``,
``paged_stats_ref(span=...)``), and ``merge_stats`` of them (K1's
continuation seed first) must equal the Pallas kernels in interpret mode
on the same numpy inputs, including lanes whose whole run is masked. f32,
rtol = atol = 1e-5: the same products, summed in another order."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.kernel import decode_attention_pallas as jax_k5
from repro.kernels.paged_attention.kernel import paged_attention_pallas as jax_k1
from repro.kernels.paged_attention.kernel import shared_prefix_pallas as jax_k2
from repro_torch.kernels.decode_attention.kernel import decode_plan
from repro_torch.kernels.decode_attention.ref import decode_stats_ref
from repro_torch.kernels.paged_attention.kernel import (
    MAX_SPLITS,
    SPLIT_TILE,
    TARGET_BLOCKS,
    paged_lane_range,
    paged_plan,
    paged_split_ranges,
    plan_splits,
    shared_prefix_plan,
    split_ranges,
)
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF,
    merge_stats,
    paged_stats_ref,
    shared_prefix_ref,
)

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
    # K1: the paper model's B = 1 lane over a 64-page (1024-token) table
    # takes all 8 splits, none empty; the engine's 128-page table too
    assert paged_plan(1, 16, 64, 16) == (8, (8, 16, 1))
    assert paged_split_ranges(1023, 64, 16, 8) == [(128 * k, 128 * (k + 1)) for k in range(8)]
    assert paged_plan(1, 16, 128, 16) == (8, (8, 16, 1))
    assert all(hi > lo for lo, hi in paged_split_ranges(1249, 79, 16, 8))
    # K1 at B = 8 (the batched server): one block per (lane, KV head), in
    # the single pass and in the cascade's continuation over a few suffix
    # pages past a 64-page run, which no planner splits
    assert paged_plan(8, 16, 69, 16) == (1, (1, 16, 8))
    assert paged_plan(8, 16, 69, 16, start=64) == (1, (1, 16, 8))
    assert paged_plan(1, 16, 69, 16, start=64) == (1, (1, 16, 1))


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


# ---------------------------------------------------------------------------
# K1: each lane's own range, split on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_split_ranges_cover_each_lane_once(ps):
    """K1's split of a lane's range [lo, hi): lo is the first page walked or
    the window's first position, hi the page bound; the splits tile it in
    order with whole 128-token tiles from lo, and with no more splits than
    tiles none is empty. A lane whose bound is at or before ``start`` walks
    nothing."""
    mp = -(-2048 // ps)
    for q_pos in (0, 1, 127, 128, 300, 1023, 1250, 2047):
        bound = min(mp, max(1, -(-(q_pos + 1) // ps)))
        for window in (0, 100, 1000):
            for start in (0, 2, 5, 40):
                if start >= mp:
                    continue
                lo, hi = paged_lane_range(q_pos, bound, ps, start, window)
                assert lo == max(start * ps, q_pos - window + 1 if window else 0)
                assert hi == max(lo, bound * ps)
                if bound <= start:
                    assert hi == lo
                tiles = -(-(hi - lo) // SPLIT_TILE)
                for splits in (1, 2, 4, 8):
                    ranges = paged_split_ranges(q_pos, bound, ps, splits, start, window)
                    assert len(ranges) == splits
                    assert ranges[0][0] == lo and ranges[-1][1] == hi
                    for (a, b), (a2, _) in zip(ranges, ranges[1:]):
                        assert b == a2
                    for a, b in ranges:
                        assert a <= b and (a - lo) % SPLIT_TILE == 0
                    covered = np.concatenate([np.arange(a, b) for a, b in ranges])
                    assert np.array_equal(covered, np.arange(lo, hi))
                    if splits <= tiles:
                        assert all(b > a for a, b in ranges), (q_pos, window, start, ranges)


def _k1_inputs(seed, n_shared, suffixes, ps, H, KV, Dh):
    """Lane b holds ``n_shared * ps + suffixes[b]`` tokens (a negative suffix
    puts its query inside the shared run); its table starts with the
    ``n_shared`` shared pages and goes on with fresh pages for a positive
    suffix. A lane of 0 tokens has no valid slot (query at 0). Returns the
    Pallas kernel's arguments (q, pools, table, bound, q_pos, kv_pos
    (B, MP, ps)) and the shared pages."""
    rng = np.random.default_rng(seed)
    B = len(suffixes)
    pages_of = lambda n: -(-max(n, 0) // ps)  # noqa: E731
    mp = n_shared + max(1, max(pages_of(s) for s in suffixes))
    n_pages = 1 + n_shared + sum(pages_of(s) for s in suffixes)
    q = rng.standard_normal((B, KV, H // KV, Dh)).astype(np.float32)
    pool_k = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    shared = np.arange(1, 1 + n_shared, dtype=np.int32)
    table = np.zeros((B, mp), np.int32)
    kv_pos = np.full((B, mp * ps), -1, np.int32)
    used = 1 + n_shared
    for b, sfx in enumerate(suffixes):
        table[b, :n_shared] = shared
        for j in range(pages_of(sfx)):
            table[b, n_shared + j] = used
            used += 1
        n = n_shared * ps + sfx
        kv_pos[b, :n] = np.arange(n)
    q_pos = np.asarray([max(n_shared * ps + s - 1, 0) for s in suffixes], np.int32)
    bound = np.clip(-(-(q_pos + 1) // ps), 1, mp).astype(np.int32)
    return (q, pool_k, pool_v, table, bound, q_pos, kv_pos.reshape(B, mp, ps)), shared


K1_CASES = {
    # ragged lanes up to 4+ tiles, and an empty lane (no valid slot)
    "ragged": (dict(n_shared=0, suffixes=(0, 1, 35, 300, 517), H=4, KV=2, Dh=16),
               dict(window=0, softcap=0.0)),
    # a window that starts mid-tile: each lane's range starts there
    "window-cap": (dict(n_shared=0, suffixes=(1, 150, 517), H=4, KV=4, Dh=16),
                   dict(window=200, softcap=8.0)),
    # the cascade's suffix pass over 256 shared tokens: queries inside the
    # run (bound <= start: the seed alone), at its end, and past it
    "continuation": (dict(n_shared=256, suffixes=(-100, -1, 1, 21, 300), H=4, KV=2, Dh=16),
                     dict(window=0, softcap=0.0)),
}


@functools.lru_cache(maxsize=None)
def _k1_case(name, ps):
    shape, kw = K1_CASES[name]
    shape = dict(shape, n_shared=shape["n_shared"] // ps)
    args, shared = _k1_inputs(2, ps=ps, **shape)
    start, init = shape["n_shared"], None
    jargs = [jnp.asarray(a) for a in args]
    if start:
        q, pk, pv, _, _, q_pos, _ = jargs
        init = jax_k2(q, pk, pv, jnp.asarray(shared), q_pos, interpret=True, **kw)
        init = tuple(np.array(t) for t in init)
    want = jax_k1(*jargs, interpret=True, start=start,
                  init=None if init is None else tuple(jnp.asarray(t) for t in init), **kw)
    return args, kw, start, init, np.asarray(want)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_merged_k1_splits_match_pallas(case, ps, splits):
    """K1's split walk: each block's state over its split of its lane's
    range, merged after the continuation seed (rank 0's order) and
    normalised, equals paged_attention_pallas; a lane with no valid slot
    gives exact zeros and one whose bound is <= start the seed alone."""
    args, kw, start, init, want = _k1_case(case, ps)
    q, pk, pv, table, bound, q_pos, kv_pos = (torch.from_numpy(a) for a in args)
    B = q.shape[0]
    kv_pos = kv_pos.reshape(B, -1)
    ranges = [paged_split_ranges(int(q_pos[b]), int(bound[b]), ps, splits, start,
                                 kw["window"]) for b in range(B)]
    parts = [] if init is None else [tuple(torch.from_numpy(t) for t in init)]
    for k in range(splits):
        span = (torch.tensor([r[k][0] for r in ranges]), torch.tensor([r[k][1] for r in ranges]))
        parts.append(paged_stats_ref(q, pk, pv, table, q_pos, kv_pos, span=span, **kw))
    acc, m, l = merge_stats(parts)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    if case == "ragged":
        assert (out[0] == 0).all() and (m[0] == NEG_INF).all() and (l[0] == 0).all()
    if case == "continuation":
        walked = [hi - lo for lo, hi in (paged_lane_range(int(q_pos[b]), int(bound[b]), ps,
                                                          start) for b in range(B))]
        assert walked[0] == 0 and walked[-1] > 0
        seed_only = merge_stats([parts[0]])
        assert torch.equal(acc[0], seed_only[0][0]) and torch.equal(l[0], seed_only[2][0])
