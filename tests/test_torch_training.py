"""The port's training modules (``repro_torch.training``) against the JAX
package's (``repro.training``) on the CPU, in f32 unless a case says
otherwise: the schedule, AdamW on random trees (f32 and bf16, clipped and
not), the cross entropy, three train steps of the reduced paper model,
gradient accumulation, remat, and the refusal of a kernel config by both
trainers. Weights are JAX's ``init_params``, bridged into the port
(``params_from_numpy``); the port's trees come back through
``params_to_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.data import BatchIterator as JaxBatchIterator
from repro.models import init_params as jax_init_params
from repro.training import OptConfig as JaxOptConfig
from repro.training import adamw_update as jax_adamw_update
from repro.training import cross_entropy as jax_cross_entropy
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro.training import schedule as jax_schedule
from repro.training.trainer import _split_microbatches as jax_split_microbatches
from repro.training.trainer import grads_fn as jax_grads_fn
from repro_torch.data import BatchIterator
from repro_torch.models import ModelConfig, params_from_numpy, params_to_numpy
from repro_torch.training import (
    OptConfig,
    adamw_update,
    cross_entropy,
    grads_fn,
    init_opt_state,
    loss_fn,
    make_train_step,
    schedule,
)
from repro_torch.training.trainer import _split_microbatches

PAPER = "paper-qwen1.5-0.5b"


def _tcfg(jcfg, **kw):
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(**kw)


def _bridge(jcfg, seed=0):
    """JAX's weights as a numpy tree, and the port's params made from it."""
    tree = jax.tree_util.tree_map(np.array, jax_init_params(jax.random.key(seed), jcfg))
    return tree, params_from_numpy(tree, _tcfg(jcfg), device="cpu")


def _batch(jcfg, b, s, seed=0):
    """One ``BatchIterator`` batch: the port's copy draws JAX's tokens."""
    jb = next(JaxBatchIterator(jcfg, batch_size=b, seq_len=s, seed=seed))
    tb = next(BatchIterator(_tcfg(jcfg), batch_size=b, seq_len=s, seed=seed))
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    return {k: jnp.asarray(v) for k, v in jb.items()}, {k: torch.from_numpy(v) for k, v in tb.items()}


def _rel_leaf_err(jax_tree, port_tree):
    """Per leaf: max |jax - port| / max |jax|."""
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.max(np.abs(np.asarray(a, np.float32) - b)))
        / max(1e-30, float(np.max(np.abs(np.asarray(a, np.float32))))),
        jax_tree, port_tree)
    return jax.tree_util.tree_leaves(errs)


@pytest.mark.parametrize("kw", [dict(lr=1e-3, warmup_steps=10, total_steps=100),
                                dict(lr=3e-4, warmup_steps=5, total_steps=20, min_lr_ratio=0.3)])
def test_schedule_matches_jax(kw):
    steps = [0, 1, 5, 10, 50, 100]
    want = [float(jax_schedule(JaxOptConfig(**kw), jnp.asarray(s, jnp.int32))) for s in steps]
    got = [float(schedule(OptConfig(**kw), torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def _random_tree(rng, dtype):
    shapes = {"w": (12, 7), "b": (7,), "blk": {"a": (3, 5, 4), "c": (9,)}}

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return rng.standard_normal(shape).astype(np.float32)

    params, grads = draw(shapes), draw(shapes)
    if dtype == "bfloat16":
        import ml_dtypes

        params = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16), params)
        grads = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16), grads)
    return params, grads


def _to_torch(tree):
    from repro_torch.models.weights import tensor_from_numpy

    return jax.tree_util.tree_map(lambda a: tensor_from_numpy(a, torch.device("cpu")), tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16).astype(np.int32) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(dtype, clip):
    """Three updates on the same random trees (bias corrections past step
    1). f32: params, m, v, grad_norm and lr within 1e-6 relative (the
    global norm sums its leaves in another order); bf16 params within one
    bf16 ulp of JAX's."""
    from repro_torch.models.weights import tensor_to_numpy

    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jp, _ = _random_tree(rng, dtype)
    tp = _to_torch(jp)
    jst, tst = jax_init_opt_state(jp), init_opt_state(tp)
    for _ in range(3):
        _, jg = _random_tree(rng, dtype)
        jp, jst, jm = jax_adamw_update(jp, jg, jst, JaxOptConfig(**cfg))
        tp, tst, tm = adamw_update(tp, _to_torch(jg), tst, OptConfig(**cfg))
        assert int(tst["step"]) == int(jst["step"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for name in ("m", "v"):
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                                        atol=1e-7), jst[name], tst[name])
        if clip == 1.0:
            assert float(jm["grad_norm"]) > clip           # the clip took effect
        for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
            if dtype == "float32":
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
            else:
                assert b.dtype == torch.bfloat16
                assert np.max(np.abs(_bits(tensor_to_numpy(b)) - _bits(a))) <= 1


@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("case", ["plain", "mask", "codebooks"])
def test_cross_entropy_matches_jax(impl, case):
    rng = np.random.default_rng(1)
    shape = (2, 9, 4, 50) if case == "codebooks" else (2, 9, 50)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, 50, size=shape[:-1]).astype(np.int32)
    mask = None
    if case == "mask":
        mask = np.ones((2, 9), bool)
        mask[1, 5:] = False
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask), impl=impl)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask), impl=impl)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_three_train_steps_match_jax():
    """The reduced paper model, f32: three steps of ``make_train_step``.
    Loss and grad_norm per step within 1e-5 relative. Params within 1e-4
    absolute, and at least 99.99 % of elements within 1e-5: Adam divides
    each gradient by its own running RMS, so an element whose gradient is
    at the f32 noise floor of both packages' sums (``bk``'s is 0 in exact
    arithmetic) still moves by about lr per step, in a direction the noise
    picks; measured on the CPU, 9 of 1.44 M elements differ by more than
    1e-5, the largest by 2.45e-5 (loss and grad_norm within 1.6e-7)."""
    jcfg = jax_get_config(PAPER).reduced()
    tree, params = _bridge(jcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxOptConfig(**kw)))
    tstep = make_train_step(_tcfg(jcfg), OptConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jst, tst = jax_init_opt_state(jp), init_opt_state(params)
    jit_ = JaxBatchIterator(jcfg, batch_size=4, seq_len=64)
    tit = BatchIterator(_tcfg(jcfg), batch_size=4, seq_len=64)
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in jb.items()})
        params, tst, tm = tstep(params, tst, {k: torch.from_numpy(v) for k, v in tb.items()})
        for k in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    got = params_to_numpy(params, _tcfg(jcfg))
    diffs = np.concatenate([np.abs(np.asarray(a) - b).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(got))])
    assert diffs.max() <= 1e-4, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.9999, np.sum(diffs > 1e-5)


def test_split_microbatches_like_jax():
    """JAX's rule: a leading axis that n divides is split, any other array
    (M-RoPE's (3, B, S) positions at n = 2) broadcast to every microbatch."""
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "positions": rng.integers(0, 9, (3, 4, 6)).astype(np.int32),
             "mask": np.ones((4, 6), bool)}
    want = jax_split_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = _split_microbatches({k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", [PAPER, "granite-moe-3b-a800m"])
def test_grad_accum_matches_jax(arch):
    """``grad_accum=2``: the port's microbatch loop against JAX's scan
    (loss 1e-5 relative, each gradient leaf within 1e-4 of its max), and
    for the dense model against the port's own full batch within JAX's
    test bounds (rtol 2e-4, atol 2e-5). The MoE's loss carries each
    microbatch's aux, while the metrics report JAX's ``{"ce": loss, "aux":
    0}``; its expert capacity and aux are per microbatch, so its full batch
    is another function."""
    jcfg = jax_get_config(arch).reduced(grad_accum=2)
    tree, params = _bridge(jcfg)
    jb, tb = _batch(jcfg, 4, 32)
    jl, jm, jg = jax.jit(lambda p, b: jax_grads_fn(p, jcfg, b))(
        jax.tree_util.tree_map(jnp.asarray, tree), jb)
    tcfg = _tcfg(jcfg)
    tl, tm, tg = grads_fn(params, tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["ce"]) == float(tl) and float(tm["aux"]) == 0.0
    assert max(_rel_leaf_err(jg, params_to_numpy(tg, tcfg))) <= 1e-4
    if jcfg.n_experts:
        return
    l1, _, g1 = grads_fn(params, tcfg.replace(grad_accum=1), tb)
    np.testing.assert_allclose(float(l1), float(tl), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(g1, tcfg)),
                    jax.tree_util.tree_leaves(params_to_numpy(tg, tcfg))):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", [PAPER, "granite-moe-3b-a800m", "gemma2-27b", "mamba2-1.3b",
                                  "zamba2-7b"])
def test_remat_changes_no_gradient(arch):
    """Each block kind recomputed in the backward (dense, moe with its aux,
    gemma pair, mamba, zamba group) gives the gradients of the kept
    activations, bit for bit, and the same loss. Deterministic algorithms
    are on: the embedding's backward (``index_put_`` with accumulate) adds
    repeated tokens' rows in a thread-dependent order otherwise, which
    moves two runs of the same config apart by an f32 ulp at B 4 x 256."""
    jcfg = jax_get_config(arch).reduced()
    _, params = _bridge(jcfg)
    _, tb = _batch(jcfg, 2, 32)
    tcfg = _tcfg(jcfg)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        l_on, m_on, g_on = grads_fn(params, tcfg.replace(remat=True), tb)
        l_off, m_off, g_off = grads_fn(params, tcfg.replace(remat=False), tb)
    finally:
        torch.use_deterministic_algorithms(was)
    assert float(l_on) == float(l_off) and float(m_on["aux"]) == float(m_off["aux"])
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(g_on, tcfg)),
                    jax.tree_util.tree_leaves(params_to_numpy(g_off, tcfg))):
        np.testing.assert_array_equal(a, b)


def test_kernel_config_is_refused_by_both_trainers():
    """No kernel has a backward: JAX's trainer fails in Pallas' JVP rule
    with ``attn_impl="pallas"``; the port's refuses any kernel config
    before the forward, on any device."""
    jcfg = jax_get_config(PAPER).reduced()
    tree, params = _bridge(jcfg)
    jb, tb = _batch(jcfg, 1, 16)
    with pytest.raises(AssertionError):
        jax_grads_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                     dataclasses.replace(jcfg, attn_impl="pallas"), jb)
    for impl in ("cuda", "pallas"):
        tcfg = _tcfg(jcfg, attn_impl=impl)
        with pytest.raises(NotImplementedError, match="attn_impl='reference'"):
            grads_fn(params, tcfg, tb)
        with pytest.raises(NotImplementedError, match="no kernel has a backward"):
            loss_fn(params, tcfg, tb)
        st = init_opt_state(params)
        with pytest.raises(NotImplementedError):
            make_train_step(tcfg, OptConfig())(params, st, tb)
