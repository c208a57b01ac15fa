"""K6's operand rounding, held to the JAX package on the CPU: the SSD chunk
as K6 runs its products on the tensor cores (CB = C Bᵀ in f64, rounded to
f32 once; W x and the states in split TF32, ``a_hi b_hi + a_hi b_lo +
a_lo b_hi``, ``x_hi = tf32(x)``, ``x_lo = tf32(x - x_hi)``) against ``ssd_chunk_pallas`` in interpret mode, at the
input statistics ``chip_smoke.py`` feeds K6 (``_ssd_case``: x, B and C of
std 0.5, dt = softplus(N(-1, 1)), A = -linspace(1, 16)), within K6's bound
``1e-4 (1 + |ref|)`` on all three outputs; and the same chunk with W x and
the states in one-pass TF32, which must NOT meet the bound (so the correction terms
cannot be dropped unnoticed). The emulation is ``kernels/ssd/ref.py``'s
``ssd_chunk_tf32``; ``tf32`` rounds by integer masking of the f32 bits."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ssd_chunk_pallas
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_chunk_tf32, tf32

K6_TOL = 1e-4   # chip_smoke.K6_TOL: |kernel - plain| <= 1e-4 (1 + |plain|)
NAMES = ("y_intra", "states", "dA_cs")


def _inputs(seed, B, L, H, P, N):
    """chip_smoke._ssd_case's statistics, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, L, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) - 1.0)).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, H)).astype(np.float32)
    Bv = (0.5 * rng.standard_normal((B, L, N))).astype(np.float32)
    Cv = (0.5 * rng.standard_normal((B, L, N))).astype(np.float32)
    return x, dt, A, Bv, Cv


# (B, L, H, P, N, Q): N 128 (Mamba2) and 64 (Zamba2) at P 64, a chunk of
# 128 rows, and a ragged chunk of 72 rows (no multiple of the 16-row tile)
CASES = {
    "n128": (1, 256, 16, 64, 128, 128),
    "n64": (1, 256, 16, 64, 64, 128),
    "n128-q72": (1, 144, 8, 64, 128, 72),
}


@pytest.fixture(autouse=True, scope="module")
def _started_thread_pool():
    """Run one parallel transcendental op before the cases. On some virtual
    machines the first parallel exp/sin/tanh of a fresh process has been
    seen to return one worker's slice off by ~1e-4 relative (a later call
    on the same input is exact), which would reach K6's bound."""
    torch.exp(torch.zeros(1 << 20))


@functools.lru_cache(maxsize=None)
def _case(name):
    B, L, H, P, N, Q = CASES[name]
    args = _inputs(0, B, L, H, P, N)
    want = ssd_chunk_pallas(*(jnp.asarray(a) for a in args), Q, interpret=True)
    return [torch.from_numpy(a) for a in args], Q, [torch.from_numpy(np.array(w)) for w in want]


def _excess(got, want):
    """Per output, the largest |got - want| - 1e-4 (1 + |want|): <= 0 meets
    K6's bound."""
    return [((g - w).abs() - K6_TOL * (1 + w.abs())).max().item() for g, w in zip(got, want)]


def test_tf32_rounds_to_ten_mantissa_bits():
    """Round to nearest on the 13 dropped bits, ties away from zero; values
    with 10 mantissa bits or fewer are unchanged."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp, 1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp,
                      -(1.0 + 0.5 * one_ulp), 3.0 + 0.51 * 2 * one_ulp, 0.0, -2.5])
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, 1.0 + one_ulp, -(1.0 + one_ulp),
                         3.0 + 2 * one_ulp, 0.0, -2.5])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    hi = tf32(r)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert ((r - hi).abs() <= r.abs() * 2.0 ** -11).all()
    lo = tf32(r - hi)
    assert ((r - hi - lo).abs() <= r.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_chunk_meets_k6_bound(case):
    """Split TF32 products stay within 1e-4 (1 + |ref|) of the Pallas
    kernel on y_intra, the states and dA_cs."""
    args, Q, want = _case(case)
    got = ssd_chunk_tf32(*args, Q, split=True)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
    excess = _excess(got, want)
    assert max(excess) <= 0, dict(zip(NAMES, excess))
    # the plain f32 version is within the bound too, and split TF32 stays
    # within a small multiple of its distance to Pallas
    plain = ssd_chunk_ref(*args, Q)
    assert max(_excess(plain, want)) <= 0
    for g, p, w in zip(got, plain, want):
        assert (g - w).abs().max() <= 20 * (p - w).abs().max() + 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_tf32_misses_k6_bound(case):
    """W x and the states in one TF32 product each (10 mantissa bits per
    operand) miss the bound on y_intra: the split's correction terms are
    what meets it."""
    args, Q, want = _case(case)
    got = ssd_chunk_tf32(*args, Q, split=False)
    excess = _excess(got, want)
    assert excess[0] > 0, dict(zip(NAMES, excess))
    assert excess[2] <= 0           # dA_cs takes no product: the f64 cumsum
