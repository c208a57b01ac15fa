"""The port's kernel modules against the JAX package: the plain PyTorch
versions of K1 (paged decode attention) and K3 (chunked paged prefill) are
held to both the Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) and the JAX oracles, at the bound of
tests/test_kernels.py (rtol = atol = 2e-5). On CPU tensors the port's ops
dispatch to the plain versions and launch no kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.chunked_prefill import ops as jax_chunk_ops
from repro.kernels.chunked_prefill.ref import chunked_prefill_ref as jax_chunk_ref
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.chunked_prefill import ops as chunk_ops
from repro_torch.kernels.chunked_prefill import chunked_prefill_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import paged_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)


def _paged_inputs(seed, lens, ps, H, KV, Dh, mp=None):
    """Pool + per-lane tables for ragged lengths ``lens`` (0 = empty lane),
    as tests/test_kernels.py builds them, drawn with numpy."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    pages_of = lambda n: max(1, -(-n // ps))
    if mp is None:
        mp = max(pages_of(n) for n in lens)
    n_pages = 1 + sum(pages_of(n) for n in lens)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    pool_k = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    table = np.zeros((B, mp), np.int32)
    kvpos = np.full((B, mp * ps), -1, np.int32)
    used = 1
    for bi, n in enumerate(lens):
        for pj in range(pages_of(n)):
            table[bi, pj] = used
            used += 1
        kvpos[bi, :n] = np.arange(n)
    q_pos = np.asarray([[max(n - 1, 0)] for n in lens], np.int32)
    return q, pool_k, pool_v, table, q_pos, kvpos


def _both_paged(args, **kw):
    ours = paged_attention_ref(*(torch.from_numpy(a) for a in args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    return ours, np.asarray(jax_paged(*jargs, **kw)), np.asarray(jax_paged_ref(*jargs, **kw))


# ragged lane lengths: empty, sub-page, exact page boundary, multi-page+tail
RAGGED = (0, 5, 16, 41)


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 32), (8, 2, 32), (4, 1, 64)], ids=["mha", "gqa", "mqa"]
)
def test_paged_ref_matches_jax(ps, H, KV, Dh):
    ours, pallas, ref = _both_paged(_paged_inputs(0, RAGGED, ps, H, KV, Dh))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("window", [0, 17])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_ref_window_softcap(window, softcap):
    ours, pallas, ref = _both_paged(
        _paged_inputs(2, (3, 23, 48), 8, 4, 2, 32), window=window, softcap=softcap
    )
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_paged_ref_bf16_gqa_matches_jax():
    """The serving dtype (tests/test_kernels.py's bf16 GQA case, tol 2e-2)."""
    import ml_dtypes

    args = _paged_inputs(1, RAGGED, 16, 8, 2, 32)
    bf = [a.astype(ml_dtypes.bfloat16) if a.dtype == np.float32 else a for a in args]
    targs = [torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
             if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a) for a in bf]
    ours = paged_attention_ref(*targs).float().numpy()
    pallas = np.asarray(jax_paged(*[jnp.asarray(a) for a in bf]), np.float32)
    np.testing.assert_allclose(ours, pallas, rtol=2e-2, atol=2e-2)


def test_paged_ref_empty_lane_is_exact_zero():
    ours, pallas, _ = _both_paged(_paged_inputs(3, (0, 12), 8, 4, 2, 16))
    assert np.all(ours[0] == 0.0) and np.all(pallas[0] == 0.0)
    np.testing.assert_allclose(ours, pallas, **TOL)


def _chunk_inputs(seed, p0s, lens, S, ps, H, KV, Dh, mp):
    """A post-write pool holding each lane's prefix [0, p0 + true_len) in
    its own pages (slot == position), and the chunk's rope'd queries."""
    rng = np.random.default_rng(seed)
    B = len(p0s)
    n_pages = 1 + B * mp
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    pool_k = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    table = (1 + np.arange(B * mp, dtype=np.int32)).reshape(B, mp)
    return (q, pool_k, pool_v, table,
            np.asarray(p0s, np.int32), np.asarray(lens, np.int32))


# chunk boundaries: at a page start, inside a page, across pages, and a
# degenerate one-token chunk (ps = 16, S = 32, table of 6 pages)
CHUNKS = [
    ((0, 16), (32, 20)),
    ((5, 37), (32, 9)),
    ((30, 44), (1, 32)),
]


@pytest.mark.parametrize("p0s,lens", CHUNKS, ids=["at", "inside", "across"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (13, 30.0)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_chunk_ref_matches_jax(p0s, lens, window, softcap, H, KV):
    S, ps, Dh, mp = 32, 16, 32, 6
    args = _chunk_inputs(4, p0s, lens, S, ps, H, KV, Dh, mp)
    kw = dict(window=window, softcap=softcap)
    ours = chunked_prefill_ref(*(torch.from_numpy(a) for a in args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jax_chunk_ops.chunked_prefill_attention(*jargs, **kw))
    ref = np.asarray(jax_chunk_ref(*jargs, **kw))
    for b, n in enumerate(lens):  # only rows that are read
        np.testing.assert_allclose(ours[b, :n], pallas[b, :n], **TOL)
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)


def test_cpu_tensors_dispatch_to_plain_versions():
    """On the CPU, ops run the plain version and count no launch."""
    paged_ops.paged_attention.launches = 0
    chunk_ops.chunked_prefill_attention.launches = 0
    args = [torch.from_numpy(a) for a in _paged_inputs(5, (7, 20), 8, 4, 2, 16)]
    out = paged_ops.paged_attention(*args)
    assert torch.equal(out, paged_attention_ref(*args))
    cargs = [torch.from_numpy(a) for a in
             _chunk_inputs(6, (0, 16), (32, 20), 32, 16, 4, 2, 32, 6)]
    out = chunk_ops.chunked_prefill_attention(*cargs)
    assert torch.equal(out, chunked_prefill_ref(*cargs))
    assert paged_ops.paged_attention.launches == 0
    assert chunk_ops.chunked_prefill_attention.launches == 0
