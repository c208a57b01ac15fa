"""The port's SSD kernel package and Mamba2 mixer against the JAX package,
in f32 on the same inputs (made from a numpy seed):

- the SSD chunk function's plain version (``kernels/ssd/ref.py:
  ssd_chunk_ref``, what K6 computes) against the TPU kernel
  ``ssd_chunk_pallas`` in interpret mode, all three outputs;
- the SSD wrapper ``kernels.ssd.ops.ssd`` (CPU tensors: the plain chunk
  function, then the inter-chunk chain) against JAX's ``ops.ssd`` and the
  exact recurrence ``ssd_sequential``, with and without an initial state,
  at two chunk sizes, and half-then-half with the carried state against
  the whole;
- ``ssd_reference`` against JAX's, large decays included (the clamp before
  exp);
- ``ssm_forward`` (both paths) and ``ssm_decode_step`` against JAX's on
  bridged weights of ``mamba2_1_3b.reduced()``.

Tolerance: JAX's own for the SSD, rtol = atol = 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mamba2_1_3b import CONFIG as JAX_MAMBA2
from repro.kernels.ssd import ops as jax_ssd_ops
from repro.kernels.ssd import ssd_chunk_pallas, ssd_sequential as jax_ssd_sequential
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd_chunk_ref, ssd_sequential
from repro_torch.models import ModelConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.weights import tensor_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, L, H, P, N, decay=1.0):
    """x, dt (post-softplus), A < 0, B and C with one group, as numpy f32;
    ``decay`` scales dt (large decays take the overflow path)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, H)))) * decay).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bv = rng.standard_normal((B, L, 1, N)).astype(np.float32)
    Cv = rng.standard_normal((B, L, 1, N)).astype(np.float32)
    return x, dt, A, Bv, Cv


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("Q", [8, 16])
@pytest.mark.parametrize("H,P,N", [(2, 8, 4), (3, 16, 8)])
def test_chunk_function_matches_pallas_kernel(Q, H, P, N):
    """y_intra, the per-chunk states (B, NC, H, N, P) and dA_cs."""
    x, dt, A, Bv, Cv = _inputs(0, 2, 4 * Q, H, P, N, decay=3.0)
    want = ssd_chunk_pallas(*_j(x, dt, A, Bv[:, :, 0], Cv[:, :, 0]), Q, interpret=True)
    got = ssd_chunk_ref(*_t(x, dt, A, Bv[:, :, 0], Cv[:, :, 0]), Q)
    for name, g, w in zip(("y_intra", "states", "dA_cs"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
def test_ssd_wrapper_matches_jax_and_recurrence(chunk, with_h0):
    x, dt, A, Bv, Cv = _inputs(1, 2, 48, 2, 16, 8)
    h0 = (np.random.default_rng(2).standard_normal((2, 2, 16, 8)).astype(np.float32)
          if with_h0 else None)
    before = ssd_ops.ssd.launches
    y, f = ssd_ops.ssd(*_t(x, dt, A, Bv, Cv), chunk, None if h0 is None else _t(h0)[0])
    assert ssd_ops.ssd.launches == before            # CPU tensors: the plain version
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jf = jax_ssd_ops.ssd(*_j(x, dt, A, Bv, Cv), chunk, jh0)
    sy, sf = jax_ssd_sequential(*_j(x, dt, A, Bv, Cv), jh0)
    ty, tf = ssd_sequential(*_t(x, dt, A, Bv, Cv), None if h0 is None else _t(h0)[0])
    for got, want in ((y, jy), (y, sy), (f, jf), (f, sf), (ty, sy), (tf, sf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_state_continuation():
    """The first half, then the second half from the carried state, equals
    the whole sequence — the basis of chunked prefill and of state
    migration for SSMs."""
    x, dt, A, Bv, Cv = _inputs(4, 1, 64, 2, 16, 8)
    ya, fa = ssd_ops.ssd(*_t(x, dt, A, Bv, Cv), 8)
    h = 32
    _, f1 = ssd_ops.ssd(*_t(x[:, :h], dt[:, :h], A, Bv[:, :h], Cv[:, :h]), 8)
    y2, f2 = ssd_ops.ssd(*_t(x[:, h:], dt[:, h:], A, Bv[:, h:], Cv[:, h:]), 16, f1)
    np.testing.assert_allclose(y2.numpy(), ya[:, h:].numpy(), **TOL)
    np.testing.assert_allclose(f2.numpy(), fa.numpy(), **TOL)
    _, jf1 = jax_ssd_ops.ssd(*_j(x[:, :h], dt[:, :h], A, Bv[:, :h], Cv[:, :h]), 8)
    np.testing.assert_allclose(f1.numpy(), np.asarray(jf1), **TOL)


@pytest.mark.parametrize("decay", [1.0, 40.0], ids=["moderate", "large"])
def test_ssd_reference_matches_jax(decay):
    """The chunked plain SSD; large decays make the masked segment sums
    overflow unless they are clamped before exp."""
    x, dt, A, Bv, Cv = _inputs(5, 2, 32, 3, 8, 4, decay=decay)
    h0 = np.random.default_rng(6).standard_normal((2, 3, 8, 4)).astype(np.float32)
    y, f = tssm.ssd_reference(*_t(x, dt, A, Bv, Cv), 8, _t(h0)[0])
    jy, jf = jssm.ssd_reference(*_j(x, dt, A, Bv, Cv), 8, jnp.asarray(h0))
    assert torch.isfinite(y).all() and torch.isfinite(f).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    ky, kf = ssd_ops.ssd(*_t(x, dt, A, Bv, Cv), 8, _t(h0)[0])
    np.testing.assert_allclose(ky.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(kf.numpy(), np.asarray(jf), **TOL)


def test_ragged_sequence_raises_like_jax():
    """A length that is no multiple of the chunk raises JAX's assertion,
    (L, chunk), on both paths; nothing is padded."""
    x, dt, A, Bv, Cv = _inputs(7, 1, 24, 2, 8, 4)
    with pytest.raises(AssertionError) as jerr:
        jssm.ssd_reference(*_j(x, dt, A, Bv, Cv), 16)
    for fn in (tssm.ssd_reference, ssd_ops.ssd):
        with pytest.raises(AssertionError) as err:
            fn(*_t(x, dt, A, Bv, Cv), 16)
        assert err.value.args == jerr.value.args == ((24, 16),)


def _mixer(jcfg, seed):
    """JAX init_ssm weights as numpy, the zero-initialised conv_b,
    dt_bias and gate_norm perturbed (else a bug there is invisible)."""
    p = jax.tree_util.tree_map(np.array, jssm.init_ssm(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 50)
    for name in ("conv_b", "dt_bias", "gate_norm", "D"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_ssm_forward_and_decode_match_jax(impl):
    """A 32-row forward with and without h0 (final and conv states
    included), a 2-row forward (conv state left-padded), then 5 decode
    steps carrying the state."""
    jcfg = JAX_MAMBA2.reduced().replace(attn_impl="reference" if impl == "reference" else "pallas")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(
        attn_impl="reference" if impl == "reference" else "cuda")
    jp = _mixer(jcfg, 0)
    tp = {k: tensor_from_numpy(v, torch.device("cpu")) for k, v in jp.items()}
    assert tp["A_log"].dtype == torch.float32 and tp["in_proj"].shape == jp["in_proj"].shape
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    nh, hd, n = jcfg.n_ssm_heads, jcfg.d_inner // jcfg.n_ssm_heads, jcfg.ssm_state
    h0 = rng.standard_normal((2, nh, hd, n)).astype(np.float32)
    for h in (None, h0):
        got = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg,
                               None if h is None else torch.from_numpy(h))
        want = jssm.ssm_forward(jp, jnp.asarray(x), jcfg, None if h is None else jnp.asarray(h))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # fewer rows than the conv window (chunk 2 so that 2 rows are legal)
    short = tssm.ssm_forward(tp, torch.from_numpy(x[:, :2]), tcfg.replace(ssm_chunk=2))
    jshort = jssm.ssm_forward(jp, jnp.asarray(x[:, :2]), jcfg.replace(ssm_chunk=2))
    for g, w in zip(short, jshort):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    st = tssm.init_ssm_state(tcfg, 2, torch.float32)
    jst = jssm.init_ssm_state(jcfg, 2, jnp.float32)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in jst.items()}
    st = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(np.array(want[2]))}
    jst = {"h": jnp.asarray(h0), "conv": want[2]}
    for i in range(5):
        xi = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        out, st = tssm.ssm_decode_step(tp, torch.from_numpy(xi), st, tcfg)
        jout, jst = jssm.ssm_decode_step(jp, jnp.asarray(xi), jst, jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), err_msg=str(i), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), err_msg=k, **TOL)


def test_init_ssm_keeps_jax_shapes_dtypes_and_scales():
    """A bf16 mixer drawn on a torch.Generator: JAX's shapes and dtypes
    (A_log, D and dt_bias f32), the deterministic parts equal."""
    jcfg = JAX_MAMBA2.reduced(param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    gen = torch.Generator().manual_seed(0)
    tp = tssm.init_ssm(tcfg, gen, torch.device("cpu"))
    jp = jssm.init_ssm(jax.random.key(0), jcfg)
    for k, w in jp.items():
        assert tuple(tp[k].shape) == w.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("conv_b", "A_log", "D", "dt_bias", "gate_norm"):
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k]).astype(np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    d = jcfg.d_model
    assert abs(tp["in_proj"].float().std().item() * np.sqrt(d) - 1) < 0.05
    assert abs(tp["conv_w"].float().std().item() / 0.2 - 1) < 0.1
