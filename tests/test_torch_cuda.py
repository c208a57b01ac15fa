"""The CUDA kernels against their plain PyTorch versions over the shapes
the kernels accept — page sizes 8/16/64, head dims 16-128, MHA/GQA/MQA,
f32 and bf16, window x softcap, ragged and empty lanes, chunk boundaries.
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, pk, pv, table, q_pos, kv_pos = _paged(dev, (5, 9), 16, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention(q, pk, pv, table, q_pos, kv_pos)
    q, pk, pv, table, q_pos, kv_pos = _paged(dev, (5, 9), 16, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention(q, pk.half(), pv.half(), table, q_pos, kv_pos)
