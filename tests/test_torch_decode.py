"""The port's flash decode kernel module (K5, the dense route's decode)
against the JAX package: its plain PyTorch version is held to both the
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs it,
with a block that does not divide the cache length) and the JAX oracle, at
rtol = atol = 2e-5 in f32 (the bound of tests/test_torch_kernels.py).
Only lanes with at least one unmasked key are compared (see
tests/test_torch_flash.py). On CPU tensors the port's op dispatches to the
plain version and launches no kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from test_torch_flash import HEADS, _check, _linear, _read_rows


@HEADS
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 30.0)])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_decode_ref_matches_jax(H, KV, Dh, window, softcap, shuffle):
    """One query per lane at ragged positions (first slot, mid-block, last
    slot) against T = 70 slots, a non-multiple of the block."""
    lens = (1, 29, 70)
    args = _linear(1, 1, 70, H, KV, Dh, [n - 1 for n in lens], [1] * 3, shuffle)
    kw = dict(window=window, softcap=softcap)
    before = decode_attention.launches
    ours = decode_attention(*(torch.from_numpy(a) for a in args), **kw).numpy()
    assert decode_attention.launches == before
    assert np.array_equal(
        ours, decode_attention_ref(*(torch.from_numpy(a) for a in args), **kw).numpy())
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jax_decode(*jargs, block_k=32, **kw))
    ref = np.asarray(jax_decode_ref(*jargs, **kw))
    _check(ours, pallas, ref, _read_rows(args[3], args[4], args[5], window))
