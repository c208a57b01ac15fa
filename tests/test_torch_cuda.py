"""The CUDA kernels against their plain PyTorch versions over the shapes
the kernels accept — page sizes 8/16/64, head dims 16-128 (and Zamba2's
112 for K4/K5), MHA/GQA/MQA, f32 and bf16, window x softcap, ragged and
empty lanes, chunk boundaries; the SSD chunk kernel (K6) over chunks
64/128, state dims 16-128, head dims 32/64, with and without an initial
state, and large decays.
K3 and K4 in bf16 run on the tensor cores and in f32 on the FMA units:
both are checked, and the bf16 edges (ragged row tiles, p0 inside a key
tile, windows that mask whole tiles) have cases of their own.
``chip_smoke.py`` checks only the main path's shapes; this matrix covers
the rest. Needs a CUDA GPU (sm_90a) and nvcc; skips elsewhere.

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention, chunked_prefill_ref
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref

pytestmark = pytest.mark.cuda

# f32: the kernel sums in another order than the plain version's einsum
# (the JAX kernel tests' own bound); bf16: one bf16 ulp on [1, 4)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged(dev, lens, ps, H, KV, Dh, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    pages_of = lambda n: max(1, -(-n // ps))
    mp = max(pages_of(n) for n in lens)
    n_pages = 1 + sum(pages_of(n) for n in lens)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    table = torch.zeros(B, mp, dtype=torch.int32)
    kv_pos = torch.full((B, mp * ps), -1, dtype=torch.int32)
    used = 1
    for bi, n in enumerate(lens):
        for pj in range(pages_of(n)):
            table[bi, pj] = used
            used += 1
        kv_pos[bi, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32)
    return q, pk, pv, table.to(dev), q_pos.to(dev), kv_pos.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (4, 1, 64), (16, 16, 64), (8, 1, 128)],
    ids=["mha16", "gqa32", "mqa64", "paper", "mqa128"],
)
def test_paged_kernel_matches_plain(dev, dtype, ps, H, KV, Dh):
    lens = (0, 1, ps - 1, ps, 2 * ps + 3, 300)
    args = _paged(dev, lens, ps, H, KV, Dh, dtype)
    before = paged_attention.launches
    out = paged_attention(*args)
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert (out[0] == 0).all()                     # the empty lane
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(0, 30.0), (17, 0.0), (40, 50.0)])
def test_paged_kernel_window_softcap(dev, dtype, window, softcap):
    args = _paged(dev, (3, 23, 48, 500), 16, 8, 2, 64, dtype, seed=1)
    out = paged_attention(*args, window=window, softcap=softcap)
    want = paged_attention_ref(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def _chunk(dev, p0s, lens, S, ps, H, KV, Dh, mp, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(p0s)
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(1 + B * mp, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(1 + B * mp, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    table = (1 + torch.arange(B * mp, dtype=torch.int32, device=dev)).reshape(B, mp)
    return (q, pk, pv, table, torch.tensor(p0s, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (16, 16, 64), (8, 1, 128)],
    ids=["mha16", "gqa32", "paper", "mqa128"],
)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (37, 30.0)])
def test_chunk_kernel_matches_plain(dev, dtype, ps, H, KV, Dh, window, softcap):
    """Chunks starting at a page boundary, inside a page and one token
    long; only the rows that are read are compared."""
    S, mp = 96, 48
    p0s, lens = (0, 5, 130, 300), (96, 70, 1, 41)
    args = _chunk(dev, p0s, lens, S, ps, H, KV, Dh, mp, dtype)
    before = chunked_prefill_attention.launches
    out = chunked_prefill_attention(*args, window=window, softcap=softcap)
    assert chunked_prefill_attention.launches == before + 1
    want = chunked_prefill_ref(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    for b, n in enumerate(lens):
        torch.testing.assert_close(out[b, :n].float(), want[b, :n].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# ragged chunk lengths, chunk starts inside a key tile and inside a page
EDGE_S = (1, 15, 17, 150, 333)
EDGE_HEADS = [(4, 4), (8, 2), (8, 1)]
EDGE_WINDOWS = [(0, 0.0), (37, 30.0), (20, 0.0)]


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("H,KV", EDGE_HEADS, ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("window,softcap", EDGE_WINDOWS, ids=["plain", "window-cap", "window20"])
def test_chunk_kernel_bf16_edges(dev, ps, Dh, H, KV, window, softcap):
    """The bf16 tensor-core K3 at chunk lengths that leave ragged 16- and
    64-row tiles, p0 that is no multiple of the 64-key tile, every page
    size, and a window of 20 that masks whole key tiles for some rows of a
    block; only the rows that are read are compared."""
    p0s = (0, 5, 77, 130)
    for S in EDGE_S:
        lens = (S, max(S - 3, 1), 1, S)
        mp = -(-(max(p0s) + S) // ps) + 1
        args = _chunk(dev, p0s, lens, S, ps, H, KV, Dh, mp, torch.bfloat16, seed=S)
        out = chunked_prefill_attention(*args, window=window, softcap=softcap)
        want = chunked_prefill_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        for b, n in enumerate(lens):
            torch.testing.assert_close(out[b, :n].float(), want[b, :n].float(),
                                       rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16],
                                       msg=lambda m, S=S, b=b: f"S {S} lane {b}: {m}")


def _kernel_names(fn) -> list:
    """Names of the device kernels that one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.self_device_time_total > 0]


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "_mma"), (torch.float32, "_simt")],
                         ids=["bf16", "f32"])
def test_prefill_kernels_are_chosen_by_dtype(dev, dtype, kernel):
    """bf16 runs the tensor-core K3 and K4, f32 the f32 FMA kernels."""
    from repro_torch.kernels.flash_attention import flash_attention

    chunk = _chunk(dev, (0, 70), (96, 40), 96, 16, 8, 2, 64, 16, dtype)
    lin = _linear(dev, 2, 96, 200, 8, 2, 64, dtype, (0, 70), (96, 40))
    for fn, name in ((lambda: chunked_prefill_attention(*chunk), "chunked_prefill"),
                     (lambda: flash_attention(*lin), "flash_attention")):
        names = [n for n in _kernel_names(fn) if "repro_torch" in n]
        assert len(names) == 1 and f"{name}{kernel}<" in names[0], names


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, pk, pv, table, q_pos, kv_pos = _paged(dev, (5, 9), 16, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q, pk, pv, table, q_pos, kv_pos)
    q, pk, pv, table, q_pos, kv_pos = _paged(dev, (5, 9), 16, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention(q, pk.half(), pv.half(), table, q_pos, kv_pos)


def _shared(dev, n_shared, suffixes, ps, H, KV, Dh, dtype, seed=0):
    """Every lane's first ``n_shared`` pages are the same physical pages
    (a shared system prompt); each lane owns fresh pages for its ragged
    suffix. Returns the paged args plus the shared run."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(suffixes)
    pages_of = lambda n: -(-n // ps)
    mp = n_shared + max(max(pages_of(n) for n in suffixes), 1)
    n_pages = 1 + n_shared + sum(pages_of(n) for n in suffixes)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    shared = list(range(1, 1 + n_shared))
    table = torch.zeros(B, mp, dtype=torch.int32)
    kv_pos = torch.full((B, mp * ps), -1, dtype=torch.int32)
    used = 1 + n_shared
    for bi, sfx in enumerate(suffixes):
        n = n_shared * ps + sfx
        table[bi, :n_shared] = torch.tensor(shared, dtype=torch.int32)
        for pj in range(pages_of(sfx)):
            table[bi, n_shared + pj] = used
            used += 1
        kv_pos[bi, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([[n_shared * ps + s - 1] for s in suffixes], dtype=torch.int32)
    sp = torch.tensor(shared, dtype=torch.int32, device=dev)
    return (q, pk, pv, table.to(dev), q_pos.to(dev), kv_pos.to(dev)), sp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (4, 1, 64), (16, 16, 64), (8, 1, 128)],
    ids=["mha16", "gqa32", "mqa64", "paper", "mqa128"],
)
def test_shared_prefix_kernel_matches_plain(dev, dtype, ps, H, KV, Dh):
    """K2 against its plain version on all of (acc, m, l): suffixes of
    0 (query inside the run), 1, ps - 1, ps and 2 ps + 3 tokens."""
    from repro_torch.kernels.paged_attention import shared_prefix, shared_prefix_ref

    (q, pk, pv, _, q_pos, _), sp = _shared(dev, 3, (0, 1, ps - 1, ps, 2 * ps + 3),
                                           ps, H, KV, Dh, dtype)
    qr = q.reshape(q.shape[0], KV, H // KV, Dh)
    before = shared_prefix.launches
    got = shared_prefix(qr, pk, pv, sp, q_pos.reshape(-1))
    assert shared_prefix.launches == before + 1
    want = shared_prefix_ref(qr, pk, pv, sp, q_pos.reshape(-1))
    torch.cuda.synchronize()
    # stats are f32 sums of bf16 or f32 products in another order
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (4, 1, 64), (16, 16, 64), (8, 1, 128)],
    ids=["mha16", "gqa32", "mqa64", "paper", "mqa128"],
)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (-3, 30.0)], ids=["plain", "window-cap"])
def test_cascade_matches_single_pass(dev, dtype, ps, H, KV, Dh, window, softcap):
    """K2 then K1 in continuation mode equals the single-pass K1 and the
    plain versions; ``window = -3`` stands for ps + 3, a window that cuts
    into the shared run. The run of 3 pages also clamps to MP - 1 for the
    lanes whose table is one page past it."""
    from repro_torch.kernels.paged_attention import shared_prefix

    window = ps + 3 if window < 0 else window
    args, sp = _shared(dev, 3, (0, 1, ps - 1, ps, 2 * ps + 3), ps, H, KV, Dh, dtype, seed=2)
    k1, k2 = paged_attention.launches, shared_prefix.launches
    fused = paged_attention(*args, sp, window=window, softcap=softcap)
    assert paged_attention.launches == k1 + 1 and shared_prefix.launches == k2 + 1
    single = paged_attention(*args, window=window, softcap=softcap)
    want = paged_attention_ref(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    for other in (single, want):
        torch.testing.assert_close(fused.float(), other.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_cascade_run_clamps_to_table_width(dev):
    """Every lane holds exactly the shared run (table width == run length):
    the run clamps to MP - 1 so K1 still walks the last page."""
    args, sp = _shared(dev, 3, (0, 0, 0), 8, 4, 2, 16, torch.float32, seed=3)
    q, pk, pv, table, q_pos, kv_pos = args
    args = (q, pk, pv, table[:, :3].contiguous(), q_pos, kv_pos[:, :24].contiguous())
    fused = paged_attention(*args, sp)
    want = paged_attention_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(fused, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K4 (flash attention) and K5 (flash decode) on linear caches
# ---------------------------------------------------------------------------

def _linear(dev, B, S, T, H, KV, Dh, dtype, p0s, lens, seed=0):
    """Queries at positions p0 + [0, S) against a T-slot cache whose slot t
    holds position t, valid below p0 + len (the dense route's layout)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    p0 = torch.tensor(p0s, dtype=torch.int32, device=dev)[:, None]
    q_pos = p0 + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    slot = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
    end = p0 + torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
    valid = slot < end
    kv_pos = torch.where(valid, slot, torch.full_like(slot, -1)).contiguous()
    return q, k, v, q_pos, kv_pos, valid


def _read_rows(q_pos, kv_pos, valid, window):
    """(B, S) rows with at least one unmasked key: the only rows compared."""
    m = (kv_pos[:, None, :] <= q_pos[:, :, None]) & valid[:, None, :]
    if window > 0:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return m.any(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (4, 1, 64), (16, 16, 64), (8, 1, 128), (4, 4, 112),
                (8, 2, 112)],
    ids=["mha16", "gqa32", "mqa64", "paper", "mqa128", "zamba112", "gqa112"],
)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (37, 30.0)])
def test_flash_kernel_matches_plain(dev, dtype, H, KV, Dh, window, softcap):
    """A full prefill (S = T, ragged true_len) and appends whose p0 is not
    a multiple of the key tile; S and T not multiples of the tiles."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    for S, T, p0s, lens in ((150, 150, (0, 0, 0), (150, 97, 1)),
                            (70, 300, (0, 5, 130), (70, 33, 1))):
        args = _linear(dev, 3, S, T, H, KV, Dh, dtype, p0s, lens)
        before = flash_attention.launches
        out = flash_attention(*args, window=window, softcap=softcap)
        assert flash_attention.launches == before + 1
        want = flash_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        rows = _read_rows(args[3], args[4], args[5], window)
        torch.testing.assert_close(out[rows].float(), want[rows].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("Dh", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("H,KV", EDGE_HEADS, ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("window,softcap", EDGE_WINDOWS, ids=["plain", "window-cap", "window20"])
def test_flash_kernel_bf16_edges(dev, Dh, H, KV, window, softcap):
    """The bf16 tensor-core K4 at query lengths that leave ragged 16- and
    64-row tiles: full prefills (S = T, ragged true_len) and appends at p0
    5, 63 and 130 (no multiple of the key tile) into a cache with slack
    slots; a window of 20 masks whole key tiles for some rows of a block."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    for S in EDGE_S:
        for T, p0s, lens in ((S, (0, 0), (S, max(S - 3, 1))),
                             (130 + S + 40, (5, 63, 130), (S, max(S // 2, 1), S))):
            args = _linear(dev, len(p0s), S, T, H, KV, Dh, torch.bfloat16, p0s, lens, seed=S)
            out = flash_attention(*args, window=window, softcap=softcap)
            want = flash_attention_ref(*args, window=window, softcap=softcap)
            torch.cuda.synchronize()
            rows = _read_rows(args[3], args[4], args[5], window)
            torch.testing.assert_close(out[rows].float(), want[rows].float(),
                                       rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16],
                                       msg=lambda m, S=S, T=T: f"S {S} T {T}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 16), (8, 2, 32), (4, 1, 64), (16, 16, 64), (8, 1, 128), (4, 4, 112),
                (8, 2, 112)],
    ids=["mha16", "gqa32", "mqa64", "paper", "mqa128", "zamba112", "gqa112"],
)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (37, 30.0)])
def test_decode_kernel_matches_plain(dev, dtype, H, KV, Dh, window, softcap):
    """One query per lane at ragged positions (1, a tile boundary, mid-tile,
    the last slot) against T = 600 slots."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    lens = (1, 128, 333, 600)
    args = _linear(dev, 4, 1, 600, H, KV, Dh, dtype, [n - 1 for n in lens], [1] * 4)
    before = decode_attention.launches
    out = decode_attention(*args, window=window, softcap=softcap)
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_kernel_reads_kv_pos(dev):
    """K5 masks by each slot's kv_pos, not by its index: a permuted cache
    (slot != position, as a ring would hold) gives the same output as the
    ordered one."""
    from repro_torch.kernels.decode_attention import decode_attention

    q, k, v, q_pos, kv_pos, valid = _linear(dev, 2, 1, 400, 8, 2, 64, torch.float32,
                                            (250, 399), (1, 1))
    perm = torch.randperm(400, device=dev)
    out = decode_attention(q, k, v, q_pos, kv_pos, valid)
    shuffled = decode_attention(q, k[:, perm].contiguous(), v[:, perm].contiguous(), q_pos,
                                kv_pos[:, perm].contiguous(), valid[:, perm].contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(out, shuffled, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The split walk of K2 and K5: cluster launches of 1-8 blocks per (KV head,
# lanes) whose partial states merge in a fixed order
# ---------------------------------------------------------------------------

BATCHES = [1, 3, 8, 64]


def _force_splits(monkeypatch, module, splits):
    """Make the binding's planner return ``splits`` (None: the planner's own
    choice)."""
    if splits is not None:
        monkeypatch.setattr(module, "plan_splits", lambda blocks, n_tokens: splits)


# K2 over a 37-page run (592 tokens: 4.6 tiles, no multiple of splits x 128),
# each lane's query position drawn in turn from the tuple
K2_SPLIT_CASES = {
    # queries inside the first tile, mid-run, at its end and past it: the
    # last splits are empty for a B = 1 block
    "causal": (0, (40, 300, 591, 700)),
    # lanes at 100 and 560 attend tokens 37-100 and 497-560: the middle
    # splits are empty for the block; a lane at 700 sees none of the run
    "window-middle": (64, (100, 560, 700)),
    # every lane past the run by more than the window: nothing attended
    "all-masked": (50, (700, 710, 750)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("case", list(K2_SPLIT_CASES))
def test_shared_prefix_split_edges(dev, monkeypatch, dtype, B, case):
    """K2 with 1 split, with 8 and with the planner's choice, each against
    the plain version on (acc, m, l); the same inputs twice give identical
    bits (the merge's fixed order); a lane whose whole run is masked keeps
    m = -1e30, l = 0, acc = 0."""
    from repro_torch.kernels.paged_attention import kernel, shared_prefix, shared_prefix_ref

    window, positions = K2_SPLIT_CASES[case]
    H, KV, Dh, ps, n_shared = 16, 16, 64, 16, 37
    gen = torch.Generator(device=dev).manual_seed(B)
    q = torch.randn(B, KV, H // KV, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(1 + n_shared, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(1 + n_shared, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    sp = torch.arange(1, 1 + n_shared, dtype=torch.int32, device=dev)
    q_pos = torch.tensor([positions[b % len(positions)] for b in range(B)],
                         dtype=torch.int32, device=dev)
    want = shared_prefix_ref(q, pk, pv, sp, q_pos, window=window)
    for splits in (1, 8, None):
        with monkeypatch.context() as mp:
            _force_splits(mp, kernel, splits)
            got = shared_prefix(q, pk, pv, sp, q_pos, window=window)
            again = shared_prefix(q, pk, pv, sp, q_pos, window=window)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a), splits
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-4,
                                       msg=lambda m, s=splits: f"splits {s}: {m}")
        masked = q_pos >= n_shared * ps - 1 + window if window else torch.zeros_like(q_pos) > 0
        if masked.any():
            assert (got[1][masked] == -1e30).all() and (got[2][masked] == 0).all()
            assert (got[0][masked] == 0).all()
    if case == "all-masked":
        assert masked.all()


# K5 against T = 1000 slots (7.8 tiles); lane b takes the (valid slots,
# query position) of entry b of the tuple in turn, and with B >= 3 the
# last lane has no valid slot at all
K5_SPLIT_CASES = {
    # queries at 0, 128, 639 and 999: the last splits are empty for most lanes
    "causal": (0, (((0, 1),), 0), (((0, 129),), 128), (((0, 640),), 639),
               (((0, 1000),), 999)),
    # window 150 from 899 and from 400: the first splits are empty
    "window": (150, (((0, 1000),), 899), (((0, 1000),), 400)),
    # valid slots [0, 100) and [700, 900): the middle splits are empty
    "hole": (0, (((0, 100), (700, 900)), 899), (((0, 100), (700, 900)), 950)),
}


def _k5_split_inputs(dev, B, H, KV, Dh, dtype, lanes, T=1000, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    valid = torch.zeros(B, T, dtype=torch.bool)
    q_pos = torch.zeros(B, 1, dtype=torch.int32)
    for b in range(B if B < 3 else B - 1):
        spans, qp = lanes[b % len(lanes)]
        for lo, hi in spans:
            valid[b, lo:hi] = True
        q_pos[b, 0] = qp
    slot = torch.arange(T, dtype=torch.int32)[None, :].expand(B, T)
    kv_pos = torch.where(valid, slot, torch.full_like(slot, -1)).contiguous()
    return q, k, v, q_pos.to(dev), kv_pos.to(dev), valid.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H,KV,Dh", [(16, 16, 64), (8, 2, 112)], ids=["paper", "gqa112"])
@pytest.mark.parametrize("case", list(K5_SPLIT_CASES))
def test_decode_split_edges(dev, monkeypatch, dtype, B, H, KV, Dh, case):
    """K5 with 1 split, with 8 and with the planner's choice, each against
    the plain version on every lane that sees a key; the same inputs twice
    give identical bits; a lane with no valid slot writes zeros."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref, kernel

    window, *lanes = K5_SPLIT_CASES[case]
    args = _k5_split_inputs(dev, B, H, KV, Dh, dtype, lanes)
    want = decode_attention_ref(*args, window=window)
    rows = _read_rows(args[3], args[4], args[5], window)[:, 0]
    for splits in (1, 8, None):
        with monkeypatch.context() as mp:
            _force_splits(mp, kernel, splits)
            out = decode_attention(*args, window=window)
            again = decode_attention(*args, window=window)
        torch.cuda.synchronize()
        assert torch.equal(out, again), splits
        torch.testing.assert_close(out[rows].float(), want[rows].float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=lambda m, s=splits: f"splits {s}: {m}")
        assert (out[~rows] == 0).all()
    if B >= 3:
        assert not rows[-1]


# ---------------------------------------------------------------------------
# K6 (the SSD chunk)
# ---------------------------------------------------------------------------

def _ssd(dev, B, L, H, P, N, decay=1.0, seed=0):
    """x, dt (post-softplus), A < 0, B and C (one group), f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(B, L, H, generator=gen, device=dev)) * decay
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
    Bv = torch.randn(B, L, 1, N, generator=gen, device=dev)
    Cv = torch.randn(B, L, 1, N, generator=gen, device=dev)
    return x, dt, A, Bv, Cv


@pytest.mark.parametrize("Q", [64, 128])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
@pytest.mark.parametrize("P", [32, 64])
def test_ssd_chunk_kernel_matches_plain(dev, Q, N, P):
    """All three outputs (y_intra, states, dA_cs) over 3 chunks, 2 lanes."""
    from repro_torch.kernels.ssd import ssd_chunk_ref
    from repro_torch.kernels.ssd.kernel import ssd_chunk_cuda

    x, dt, A, Bv, Cv = _ssd(dev, 2, 3 * Q, 5, P, N)
    args = (x, dt, A, Bv[:, :, 0].contiguous(), Cv[:, :, 0].contiguous())
    got = ssd_chunk_cuda(*args, Q)
    want = ssd_chunk_ref(*args, Q)
    torch.cuda.synchronize()
    for name, g, w in zip(("y_intra", "states", "dA_cs"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("decay", [1.0, 50.0], ids=["moderate", "large"])
@pytest.mark.parametrize("N,P", [(128, 64), (64, 64), (16, 32)], ids=["mamba2", "zamba2", "small"])
def test_ssd_wrapper_matches_plain(dev, with_h0, decay, N, P):
    """ops.ssd launches K6 once and matches its plain version (the same
    wrapper on CPU copies of the inputs: the plain chunk function, then the
    same chain); large decays take the clamp-before-exp path and stay
    finite."""
    from repro_torch.kernels.ssd import ssd

    x, dt, A, Bv, Cv = _ssd(dev, 2, 256, 4, P, N, decay=decay, seed=1)
    gen = torch.Generator(device=dev).manual_seed(2)
    h0 = torch.randn(2, 4, P, N, generator=gen, device=dev) if with_h0 else None
    before = ssd.launches
    y, f = ssd(x, dt, A, Bv, Cv, 128, h0)
    assert ssd.launches == before + 1
    cpu = [t.cpu() for t in (x, dt, A, Bv, Cv)]
    wy, wf = ssd(*cpu, 128, None if h0 is None else h0.cpu())
    assert ssd.launches == before + 1
    wy, wf = wy.to(dev), wf.to(dev)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(f).all()
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(f, wf, rtol=1e-4, atol=1e-4)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd.kernel import ssd_chunk_cuda

    x, dt, A, Bv, Cv = _ssd(dev, 1, 192, 2, 64, 64)
    with pytest.raises(AssertionError):
        ssd(x, dt, A, Bv, Cv, 128)                       # 192 is no multiple of 128
    with pytest.raises(ValueError):
        ssd_chunk_cuda(x, dt, A, Bv[:, :, 0, :48].contiguous(), Cv[:, :, 0, :48].contiguous(), 64)
    with pytest.raises(ValueError):
        ssd_chunk_cuda(x, dt, A, Bv[:, :, 0].contiguous(), Cv[:, :, 0].contiguous(), 192)
