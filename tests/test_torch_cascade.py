"""The shared-prefix cascade against the JAX package: the port's plain
K2 (``shared_prefix_ref``) and K1 continuation (``paged_attention_ref``
with ``start``/``init``) against the Pallas kernels in interpret mode, and
the port's ``ops.paged_attention(..., shared_pages)`` against JAX's, at
the bound of tests/test_kernels.py (rtol = atol = 2e-5). The matrix
mirrors tests/test_kernels.py's cascade tests: ragged suffixes
(0, 1, ps - 1, ps, 2 ps + 3), page sizes 8 and 16, MHA/GQA/MQA, a window
that cuts into the run, softcap, and a run that clamps to MP - 1. On CPU
tensors no kernel launches."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention.kernel import (
    paged_attention_pallas as jax_k1,
    shared_prefix_pallas as jax_k2,
)
from repro_torch.kernels.chunked_prefill import ops as chunk_ops
from repro_torch.kernels.paged_attention import ops, paged_attention_ref, shared_prefix_ref

TOL = dict(rtol=2e-5, atol=2e-5)


def _shared_inputs(seed, n_shared, suffix_lens, ps, H, KV, Dh, mp=None):
    """Pool + tables where every lane's first ``n_shared`` pages are the
    same physical pages and each lane owns fresh pages for its ragged
    suffix (tests/test_kernels.py's ``_shared_paged_inputs``, drawn with
    numpy). Returns (q, pool_k, pool_v, table, q_pos, kv_pos), shared."""
    rng = np.random.default_rng(seed)
    B = len(suffix_lens)
    pages_of = lambda n: -(-n // ps)
    if mp is None:
        mp = max(n_shared + max(pages_of(n) for n in suffix_lens), n_shared)
    n_pages = 1 + n_shared + sum(pages_of(n) for n in suffix_lens)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    pool_k = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, ps, KV, Dh)).astype(np.float32)
    shared = np.arange(1, 1 + n_shared, dtype=np.int32)
    table = np.zeros((B, mp), np.int32)
    kv_pos = np.full((B, mp * ps), -1, np.int32)
    used = 1 + n_shared
    for bi, sfx in enumerate(suffix_lens):
        n = n_shared * ps + sfx
        table[bi, :n_shared] = shared
        for pj in range(pages_of(sfx)):
            table[bi, n_shared + pj] = used
            used += 1
        kv_pos[bi, :n] = np.arange(n)
    q_pos = np.asarray([[n_shared * ps + s - 1] for s in suffix_lens], np.int32)
    return (q, pool_k, pool_v, table, q_pos, kv_pos), shared


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _grouped(q, KV):
    b, _, h, dh = q.shape
    return q.reshape(b, KV, h // KV, dh)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (11, 0.0), (0, 8.0)])
def test_shared_prefix_ref_matches_pallas(window, softcap):
    """All three outputs — acc, m and l — of the plain K2 equal the Pallas
    K2's, including lanes whose query sits inside the run and, with the
    window, rows of the run that are masked."""
    (q, pk, pv, _, q_pos, _), sp = _shared_inputs(0, 3, (0, 1, 7, 8, 19), 8, 8, 2, 16)
    kw = dict(window=window, softcap=softcap)
    want = jax_k2(jnp.asarray(_grouped(q, 2)), jnp.asarray(pk), jnp.asarray(pv),
                  jnp.asarray(sp), jnp.asarray(q_pos[:, 0]), interpret=True, **kw)
    got = shared_prefix_ref(*_t((_grouped(q, 2), pk, pv, sp, q_pos[:, 0])), **kw)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_shared_prefix_ref_fully_masked_lane():
    """A window that masks a lane's whole run leaves m = -1e30 (not -inf),
    l = 0 and acc = 0, as the kernel recurrence leaves them."""
    (q, pk, pv, _, q_pos, _), sp = _shared_inputs(1, 2, (20, 3), 8, 4, 2, 16)
    acc, m, l = shared_prefix_ref(*_t((_grouped(q, 2), pk, pv, sp, q_pos[:, 0])), window=4)
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(acc[0] == 0)
    assert torch.all(l[1] > 0)


@pytest.mark.parametrize("window", [0, 11])
def test_continuation_ref_matches_pallas(window):
    """K1 with start/init, seeded with K2's stats, equals the Pallas K1 in
    continuation mode (lanes with bound <= start finalise from init)."""
    args, sp = _shared_inputs(2, 3, (0, 1, 7, 8, 19), 8, 8, 2, 16)
    q, pk, pv, table, q_pos, kv_pos = args
    b, mp, ps = q.shape[0], table.shape[1], pk.shape[1]
    start = 3
    init_j = jax_k2(jnp.asarray(_grouped(q, 2)), jnp.asarray(pk), jnp.asarray(pv),
                    jnp.asarray(sp), jnp.asarray(q_pos[:, 0]), window=window, interpret=True)
    bound = np.clip((q_pos[:, 0] + ps) // ps, 1, mp).astype(np.int32)
    want = jax_k1(jnp.asarray(_grouped(q, 2)), jnp.asarray(pk), jnp.asarray(pv),
                  jnp.asarray(table), jnp.asarray(bound), jnp.asarray(q_pos[:, 0]),
                  jnp.asarray(kv_pos.reshape(b, mp, ps)), window=window, interpret=True,
                  start=start, init=init_j)
    init_t = tuple(torch.from_numpy(np.array(x)) for x in init_j)
    got = paged_attention_ref(*_t(args), window=window, start=start, init=init_t)
    np.testing.assert_allclose(got.numpy().reshape(np.asarray(want).shape),
                               np.asarray(want), **TOL)


# (ps, H, KV, Dh, n_shared): MHA / GQA / MQA at both page sizes, run of 1
# and of 3 pages
MATRIX = [
    (8, 4, 4, 16, 1), (8, 8, 2, 32, 3), (8, 4, 1, 32, 3),
    (16, 4, 4, 16, 3), (16, 8, 2, 32, 1), (16, 4, 1, 32, 1),
    (16, 12, 1, 192, 3),   # nemotron's G = 12 at d_head 192
]


@pytest.mark.parametrize("ps,H,KV,Dh,n_shared", MATRIX,
                         ids=[f"ps{m[0]}-h{m[1]}-kv{m[2]}-s{m[4]}" for m in MATRIX])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (-3, 30.0)], ids=["plain", "window-cap"])
def test_cascade_ops_match_jax(ps, H, KV, Dh, n_shared, window, softcap):
    """The port's ops cascade vs JAX's ops cascade vs the port's single
    pass, over ragged suffixes; ``window = -3`` stands for ps + 3, which
    cuts into the run."""
    window = ps + 3 if window < 0 else window
    args, sp = _shared_inputs(3, n_shared, (0, 1, ps - 1, ps, 2 * ps + 3), ps, H, KV, Dh)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(jax_ops.paged_attention(*[jnp.asarray(a) for a in args],
                                              jnp.asarray(sp), **kw))
    fused = ops.paged_attention(*_t(args), torch.from_numpy(sp), **kw).numpy()
    single = ops.paged_attention(*_t(args), **kw).numpy()
    np.testing.assert_allclose(fused, want, **TOL)
    np.testing.assert_allclose(fused, single, **TOL)


def test_cascade_run_clamps_to_table_width():
    """Every lane is the shared run itself (table width == run length):
    start clamps to MP - 1 and the result equals JAX's and the single pass."""
    args, sp = _shared_inputs(4, 3, (0, 0, 0), 8, 4, 2, 16, mp=3)
    want = np.asarray(jax_ops.paged_attention(*[jnp.asarray(a) for a in args], jnp.asarray(sp)))
    fused = ops.paged_attention(*_t(args), torch.from_numpy(sp)).numpy()
    np.testing.assert_allclose(fused, want, **TOL)
    np.testing.assert_allclose(fused, ops.paged_attention(*_t(args)).numpy(), **TOL)


def test_cpu_cascade_launches_no_kernel(monkeypatch):
    """On CPU tensors the cascade runs the plain K2 and K1 and counts no
    launch of K1, K2 or K3."""
    calls = []
    monkeypatch.setattr(ops, "shared_prefix_ref",
                        lambda *a, **k: calls.append(1) or shared_prefix_ref(*a, **k))
    ops.paged_attention.launches = ops.shared_prefix.launches = 0
    chunk_ops.chunked_prefill_attention.launches = 0
    args, sp = _shared_inputs(5, 2, (3, 9), 8, 4, 2, 16)
    ops.paged_attention(*_t(args), torch.from_numpy(sp))
    assert calls == [1]
    assert ops.paged_attention.launches == ops.shared_prefix.launches == 0
    assert chunk_ops.chunked_prefill_attention.launches == 0
