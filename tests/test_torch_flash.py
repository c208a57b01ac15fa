"""The port's flash attention kernel module (K4, the dense route's prefill
and chunk append) against the JAX package: its plain PyTorch version is
held to both the Pallas kernel (interpret mode on the CPU, as
tests/test_kernels.py runs them, with small blocks so that S and T are not
block multiples) and the JAX oracle, at rtol = atol = 2e-5 in f32 (the
bound of tests/test_torch_kernels.py: the same f32 sums in another order).
Only rows with at least one unmasked key are compared: a fully masked row
is the mean of V in JAX's kernel (over its padded block) and oracle, and
zeros in the port's CUDA kernel; no caller reads one. On CPU tensors the
port's op dispatches to the plain version and launches no kernel. K5's
module is held the same way in tests/test_torch_decode.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)
HEADS = pytest.mark.parametrize(
    "H,KV,Dh", [(4, 4, 32), (8, 2, 32), (4, 1, 64), (12, 1, 192)],
    ids=["mha", "gqa", "mqa", "g12x192"],   # the last: nemotron's G = 12 at d_head 192
)


def _linear(seed, S, T, H, KV, Dh, p0s, lens, shuffle=False):
    """Queries at p0 + [0, S) against T slots; slot t holds position t and
    is valid below p0 + len (the dense route's layout), or, with
    ``shuffle``, a permuted copy of it (slot != position) with a few
    invalid slots holding positions."""
    rng = np.random.default_rng(seed)
    B = len(p0s)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    p0 = np.asarray(p0s, np.int32)[:, None]
    q_pos = (p0 + np.arange(S, dtype=np.int32)[None]).astype(np.int32)
    slot = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    valid = slot < (p0 + np.asarray(lens, np.int32)[:, None])
    kv_pos = np.where(valid, slot, -1).astype(np.int32)
    if shuffle:
        perm = rng.permutation(T)
        kv_pos, valid = slot[:, perm].copy(), valid[:, perm].copy()
        k, v = k[:, perm].copy(), v[:, perm].copy()
    return q, k, v, q_pos, kv_pos, valid


def _read_rows(q_pos, kv_pos, valid, window):
    m = (kv_pos[:, None, :] <= q_pos[:, :, None]) & valid[:, None, :]
    if window > 0:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    return m.any(-1)


def _check(ours, pallas, ref, rows):
    np.testing.assert_allclose(ours[rows], pallas[rows], **TOL)
    np.testing.assert_allclose(ours[rows], ref[rows], **TOL)


# a full prefill with ragged true_len (S = T, causal), an append chunk
# whose p0 is not a multiple of the key block (rows past the cache's valid
# span included), and a cache whose slots are not their positions
CASES = {
    "prefill": (40, 40, (0, 0, 0), (40, 23, 1), False),
    "append": (13, 72, (0, 5, 37), (13, 9, 1), False),
    "shuffled": (9, 50, (10, 30), (9, 4), True),
}


@HEADS
@pytest.mark.parametrize("case,window,softcap", [
    ("prefill", 0, 0.0), ("prefill", 11, 30.0), ("append", 0, 0.0), ("append", 11, 30.0),
    ("shuffled", 11, 30.0),
])
def test_flash_ref_matches_jax(H, KV, Dh, case, window, softcap):
    S, T, p0s, lens, shuffle = CASES[case]
    args = _linear(0, S, T, H, KV, Dh, p0s, lens, shuffle)
    kw = dict(window=window, softcap=softcap)
    before = flash_attention.launches
    ours = flash_attention(*(torch.from_numpy(a) for a in args), **kw).numpy()
    assert flash_attention.launches == before                 # plain version on CPU
    assert np.array_equal(
        ours, flash_attention_ref(*(torch.from_numpy(a) for a in args), **kw).numpy())
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jax_flash(*jargs, block_q=16, block_k=16, **kw))
    ref = np.asarray(jax_flash_ref(*jargs, **kw))
    rows = _read_rows(args[3], args[4], args[5], window)
    assert rows.sum() > 0
    _check(ours, pallas, ref, rows)


def test_flash_ref_bf16_matches_jax():
    """bf16 inputs: the f32 softmax of both, rounded to bf16 at the end."""
    import ml_dtypes

    q, k, v, qp, kp, valid = _linear(3, 24, 24, 8, 2, 32, (0, 0), (24, 17))
    bf = [a.astype(ml_dtypes.bfloat16) for a in (q, k, v)]
    ours = flash_attention(*(torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                             for a in bf),
                           *(torch.from_numpy(a) for a in (qp, kp, valid))).float().numpy()
    ref = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (*bf, qp, kp, valid)))).astype(np.float32)
    rows = _read_rows(qp, kp, valid, 0)
    np.testing.assert_allclose(ours[rows], ref[rows], rtol=1e-2, atol=1e-2)
