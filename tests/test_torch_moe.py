"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` in f32, on the same (bridged) weights and
inputs drawn with numpy from a seed: ``expert_capacity``, ``_route``
(top_idx, top_w, aux), ``_sort_dispatch`` (xe, slot_token, slot_w) and
``moe_forward``, with capacity drops (the config's capacity factor 1.25),
swiglu experts and the other expert MLPs JAX's ``_expert_mlp`` supports
(relu2, gelu). f32 inputs make an exact tie in the router improbable, so
``torch.topk`` and ``jax.lax.top_k`` pick the same experts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dbrx_132b import CONFIG as JAX_DBRX
from repro.configs.granite_moe_3b_a800m import CONFIG as JAX_GRANITE
from repro.models import moe as jmoe
from repro_torch.models import ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import tensor_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(mlp_type="swiglu", base=JAX_GRANITE, **kw):
    jcfg = base.reduced(mlp_type=mlp_type, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.key(seed), jcfg))
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: tensor_from_numpy(v, torch.device("cpu")) for k, v in p.items()})


def _x(t, d, seed=1, skew=0.0, router=None):
    """(T, D) f32 rows; with ``skew`` each row leans toward the router's
    first column, so most tokens pick expert 0 and its capacity overflows."""
    x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    if skew:
        x += skew * np.asarray(router)[:, 0] / np.linalg.norm(np.asarray(router)[:, 0])
    return x


@pytest.mark.parametrize("base", [JAX_GRANITE, JAX_DBRX], ids=["granite", "dbrx"])
def test_expert_capacity_matches_jax(base):
    for cfg in (base, base.reduced()):
        tcfg = ModelConfig(**dataclasses.asdict(cfg))
        for t in (1, 3, 8, 16, 40, 64, 100, 256, 1000, 4096):
            assert tmoe.expert_capacity(tcfg, t) == jmoe.expert_capacity(cfg, t), (cfg.name, t)


@pytest.mark.parametrize("skew", [0.0, 6.0], ids=["spread", "skewed"])
def test_route_and_dispatch_match_jax(skew):
    """Route 150 rows (capacity 96 per expert), then dispatch: the same
    experts and weights, the same aux loss, and the same (E, C, D) buffers,
    slot tokens and slot weights — in the skewed case with drops."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x(150, jcfg.d_model, skew=skew, router=jp["router"])
    ji, jw, ja = jmoe._route(jp, jnp.asarray(x), jcfg)
    ti, tw, ta = tmoe._route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    e, cap = jcfg.n_experts, jmoe.expert_capacity(jcfg, 150)
    jxe, jst, jsw = jmoe._sort_dispatch(jnp.asarray(x), ji, jw, e, cap)
    txe, tst, tsw = tmoe._sort_dispatch(torch.from_numpy(x), ti, tw, e, cap)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(tsw.numpy(), np.asarray(jsw), **TOL)
    np.testing.assert_array_equal(txe.numpy(), np.asarray(jxe))
    kept = int((tst.numpy() < 150).sum())
    if skew:
        assert kept < 150 * jcfg.top_k            # capacity drops happened
        assert (tst.numpy().reshape(e, cap)[0] < 150).all()   # expert 0 is full
    else:
        assert kept == 150 * jcfg.top_k


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("shape,skew", [((2, 40), 0.0), ((3, 50), 6.0), ((8, 1), 0.0)],
                         ids=["prefill", "prefill-drops", "decode-lanes"])
def test_moe_forward_matches_jax(mlp_type, shape, skew):
    """``moe_forward`` over (B, S, D): the same output and aux loss, also
    when tokens drop (their MoE output is zero in both)."""
    jcfg, tcfg = _cfgs(mlp_type)
    jp, tp = _params(jcfg, seed=2)
    b, s = shape
    x = _x(b * s, jcfg.d_model, seed=3, skew=skew, router=jp["router"]).reshape(b, s, -1)
    jo, ja = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    to, ta = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    assert to.dtype == torch.float32 and ta.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if skew:
        cap = tmoe.expert_capacity(tcfg, b * s)
        top_idx = tmoe._route(tp, torch.from_numpy(x.reshape(b * s, -1)), tcfg)[0]
        dropped = tmoe._dispatch_plan(top_idx, tcfg.n_experts, cap) == tcfg.n_experts * cap
        assert dropped.any()


def test_moe_combine_is_run_to_run_identical():
    """The combine adds each token's slots in a fixed order: two runs give
    the same bits (bf16, as served)."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(96, jcfg.d_model, seed=4)).to(torch.bfloat16).view(2, 48, -1)
    a, _ = tmoe.moe_forward(tp, x, tcfg)
    b, _ = tmoe.moe_forward(tp, x, tcfg)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_init_moe_shapes_and_scales_match_jax():
    """Torch-drawn experts have JAX's shapes, dtypes and scales (the draws
    differ: tests bridge JAX's weights instead)."""
    for mlp_type in ("swiglu", "gelu"):
        jcfg, tcfg = _cfgs(mlp_type, param_dtype="bfloat16")
        jp = jmoe.init_moe(jax.random.key(0), jcfg)
        gen = torch.Generator().manual_seed(0)
        tp = tmoe.init_moe(tcfg, gen, torch.device("cpu"))
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.bfloat16, k
            np.testing.assert_allclose(float(tp[k].float().std()),
                                       float(jnp.std(jp[k].astype(jnp.float32))), rtol=0.05)


def test_geglu_experts_raise_like_jax():
    """JAX's ``init_moe`` draws ``w_gate`` for swiglu only while
    ``_expert_mlp`` reads it for geglu too (reference fault R6): both
    packages raise the same ``KeyError`` at a geglu MoE's first forward."""
    jcfg, tcfg = _cfgs("geglu")
    jp, tp = _params(jcfg)
    assert "w_gate" not in jp and "w_gate" not in tp
    x = _x(8, jcfg.d_model).reshape(1, 8, -1)
    with pytest.raises(KeyError, match="w_gate"):
        jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    with pytest.raises(KeyError, match="w_gate"):
        tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
