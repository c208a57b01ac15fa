"""The multi-device launch's spec and analysis modules of the port
(``repro_torch.launch.{mesh,shapes,dryrun}``, ``repro_torch.core.
mesh_context``, ``repro_torch.roofline``, ``abstract_params`` and the
trainer's ``grad_specs``) against the JAX package's, on the CPU.

Shapes, state sizes and FLOP models are metadata: all eleven
configurations run at full width, on meta tensors in the port and
ShapeDtypeStructs in JAX. The port prices its analysis with the H100's
constants, JAX with a TPU's, so times compare through the ratio of the
constants. Then the JAX package's own tests of these modules
(``tests/test_mesh_context.py``, ``test_grad_specs_noop_without_specs`` of
``tests/test_perf_features.py``) run on the port, and ``step_flops``'s
meta count is held to the count on real CPU tensors."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.core import mesh_context as jax_mc
from repro.launch import mesh as jax_mesh
from repro.launch import shapes as jax_shapes
from repro.launch import sharding as jax_sharding
from repro.models import abstract_params as jax_abstract_params
from repro.models import ModelConfig as JaxModelConfig
from repro.models import init_params as jax_init_params
from repro.roofline import analysis as jax_roofline
from repro.training.trainer import grads_fn as jax_grads_fn
from repro_torch.configs import ALL, get_config
from repro_torch.core.mesh_context import (
    MigrationAnalysis,
    internal_state_bytes,
    migration_vs_reprefill,
)
from repro_torch.launch import mesh
from repro_torch.launch.dryrun import step_flops
from repro_torch.launch.shapes import (
    NATIVE_LONG,
    SHAPES,
    InputShape,
    arch_for_shape,
    decode_cache_abstract,
    decode_inputs_abstract,
    prefill_inputs_abstract,
    train_batch_abstract,
)
from repro_torch.launch.sharding import cache_specs
from repro_torch.models import ModelConfig, abstract_params, init_params
from repro_torch.models.weights import jax_layout, tree_leaves
from repro_torch.roofline import RooflineResult, model_flops
from repro_torch.training import grads_fn, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state

ARCHS = sorted(ALL)
ASSIGNED = sorted(a for a in ALL if a != "paper-qwen1.5-0.5b")
CONTEXTS = (4_096, 32_768, 524_288)
# the port's times over JAX's: the same work priced on another card
FLOPS_RATIO = jax_mesh.PEAK_FLOPS_BF16 / mesh.PEAK_FLOPS_BF16
HBM_RATIO = jax_mesh.HBM_BW / mesh.HBM_BW
LINK_RATIO = jax_mesh.ICI_BW_PER_LINK / mesh.ICI_BW_PER_LINK
REL = 1e-12


def jax_flat(tree, is_leaf=None):
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def port_flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() for p, x in port_flat(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree) for p, x in port_flat(v, path + (i,)).items()}
    return {path: tree}


def assert_abstract_equal(jax_tree, port_tree, where):
    """Leaf for leaf by path: the same shape and dtype; every port leaf on
    the meta device."""
    want, got = jax_flat(jax_tree), port_flat(port_tree)
    assert want.keys() == got.keys(), (where, set(want) ^ set(got))
    for path, leaf in want.items():
        t = got[path]
        assert t.is_meta, (where, path)
        assert tuple(t.shape) == tuple(leaf.shape), (where, path, t.shape, leaf.shape)
        assert str(t.dtype).replace("torch.", "") == str(jnp.dtype(leaf.dtype)), \
            (where, path, t.dtype, leaf.dtype)


def close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# Against JAX, full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_and_allocate_nothing(arch):
    cfg = get_config(arch)
    tree = abstract_params(cfg)
    assert all(t.is_meta for t in tree_leaves(tree))
    assert_abstract_equal(jax_abstract_params(jax_get_config(arch)),
                          jax_layout(tree, torch.stack), arch)


def test_abstract_params_have_init_params_structure():
    """On meta, ``init_params`` makes the tree it makes on the CPU: the same
    leaves in the same order, shapes and dtypes."""
    for arch in ("zamba2-7b", "granite-moe-3b-a800m", "gemma2-27b"):
        cfg = get_config(arch).reduced()
        real, meta = tree_leaves(init_params(cfg, device="cpu")), tree_leaves(abstract_params(cfg))
        assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in meta], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_caches_and_cache_specs_match_jax(arch):
    """For the four shapes (the variant each selects): the abstract train
    batch, prefill and decode inputs, the decode caches (leaf by path name:
    k, v, kv_pos, h, conv) and their specs (x multi_pod; seq_shard at batch
    1, long_500k) equal JAX's."""
    for name, shape in SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        cfg = arch_for_shape(get_config(arch), shape)
        jcfg = jax_shapes.arch_for_shape(jax_get_config(arch), jshape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert_abstract_equal(jax_shapes.train_batch_abstract(jcfg, jshape),
                              train_batch_abstract(cfg, shape), (arch, name, "train"))
        assert_abstract_equal(jax_shapes.prefill_inputs_abstract(jcfg, jshape),
                              prefill_inputs_abstract(cfg, shape), (arch, name, "prefill"))
        assert_abstract_equal(jax_shapes.decode_inputs_abstract(jcfg, jshape),
                              decode_inputs_abstract(cfg, shape), (arch, name, "decode"))
        jcaches, caches = jax_shapes.decode_cache_abstract(jcfg, jshape), \
            decode_cache_abstract(cfg, shape)
        assert_abstract_equal(jcaches, caches, (arch, name, "caches"))
        seq_shard = shape.global_batch == 1
        for multi_pod in (False, True):
            want = jax_flat(jax_sharding.cache_specs(jcfg, jcaches, multi_pod,
                                                     seq_shard=seq_shard),
                            lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = port_flat(cache_specs(cfg, caches, multi_pod, seq_shard=seq_shard))
            assert want.keys() == got.keys()
            assert all(tuple(got[p]) == tuple(s) for p, s in want.items()), (arch, name)
    assert NATIVE_LONG == jax_shapes.NATIVE_LONG


def test_long_context_caches_on_meta():
    """long_500k's 524288 slots: JAX's shapes, no storage."""
    shape = SHAPES["long_500k"]
    gemma = decode_cache_abstract(arch_for_shape(get_config("gemma2-27b"), shape), shape)
    assert tuple(gemma[0]["global"]["k"].shape) == (23, 1, 524288, 16, 128)
    assert tuple(gemma[0]["local"]["k"].shape) == (23, 1, 4096, 16, 128)
    zamba = decode_cache_abstract(arch_for_shape(get_config("zamba2-7b"), shape), shape)
    assert tuple(zamba[0]["ssm"]["conv"].shape) == (78, 1, 4, 7296)
    assert all(t.is_meta for t in tree_leaves(gemma) + tree_leaves(zamba))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_migration_flops_and_roofline_match_jax(arch):
    """internal_state_bytes, MigrationAnalysis, model_flops and
    RooflineResult equal JAX's; times scaled by the constants' ratio."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for ctx in CONTEXTS:
        assert internal_state_bytes(cfg, ctx) == jax_mc.internal_state_bytes(jcfg, ctx)
        assert internal_state_bytes(cfg, ctx, batch=3) == \
            jax_mc.internal_state_bytes(jcfg, ctx, batch=3)
        for chips in (256, 1):
            got = migration_vs_reprefill(cfg, ctx, chips_per_pod=chips)
            want = jax_mc.migration_vs_reprefill(jcfg, ctx, chips_per_pod=chips)
            assert isinstance(got, MigrationAnalysis)
            assert (got.arch, got.context_len, got.state_bytes, got.token_bytes,
                    got.reprefill_flops) == (want.arch, want.context_len, want.state_bytes,
                                             want.token_bytes, want.reprefill_flops)
            assert close(got.migrate_s, want.migrate_s * LINK_RATIO)
            assert close(got.reprefill_s, want.reprefill_s * FLOPS_RATIO)
            assert got.winner == ("migrate-state" if got.migrate_s < got.reprefill_s
                                  else "reprefill-tokens")
    for kind in ("train", "prefill", "decode"):
        mf = model_flops(cfg, kind, 8, 1024)
        assert mf == jax_roofline.model_flops(jcfg, kind, 8, 1024)
        args = dict(arch=arch, shape=kind, mesh="16x16", chips=256, hlo_flops=3.7e15,
                    hlo_bytes=2.1e12, collective_bytes=4.4e10, model_flops=mf)
        got, want = RooflineResult(**args).to_dict(), jax_roofline.RooflineResult(**args).to_dict()
        assert got.keys() == want.keys()
        for key in ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
                    "collective_bytes", "collectives", "model_flops", "peak_memory_bytes",
                    "useful_flops_ratio"):
            assert got[key] == want[key], key
        assert close(got["compute_s"], want["compute_s"] * FLOPS_RATIO)
        assert close(got["memory_s"], want["memory_s"] * HBM_RATIO)
        assert close(got["collective_s"], want["collective_s"] * LINK_RATIO)
        assert got["dominant"] == max(("compute", "memory", "collective"),
                                      key=lambda t: got[t + "_s"])


def test_mesh_axes_and_card_constants():
    for multi_pod in (False, True):
        assert mesh.data_axes(multi_pod) == jax_mesh.data_axes(multi_pod)
        assert mesh.n_chips(multi_pod) == jax_mesh.n_chips(multi_pod)
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW_PER_LINK) == (989e12, 3.35e12, 25e9)
    r = RooflineResult("a", "s", "m", 1, hlo_flops=989e12, hlo_bytes=0.0, collective_bytes=0.0)
    assert r.compute_s == 1.0 and r.dominant == "compute" and r.useful_flops_ratio == 0.0


# ---------------------------------------------------------------------------
# tests/test_mesh_context.py, on the port (the H100's constants)
# ---------------------------------------------------------------------------

def test_ssm_state_constant_in_context():
    cfg = get_config("mamba2-1.3b")
    assert internal_state_bytes(cfg, 4_096) == internal_state_bytes(cfg, 524_288)


def test_dense_state_linear_in_context():
    cfg = get_config("qwen2-0.5b")
    assert internal_state_bytes(cfg, 8_192) == 2 * internal_state_bytes(cfg, 4_096)


def test_gemma_local_layers_capped():
    cfg = get_config("gemma2-27b")
    big = internal_state_bytes(cfg, 524_288)
    full = 2 * cfg.n_layers * 524_288 * cfg.n_kv_heads * cfg.d_head * 2
    assert big < full


def test_migration_wins_for_ssm_long_context():
    cfg = get_config("mamba2-1.3b")
    res = migration_vs_reprefill(cfg, 524_288)
    assert res.winner == "migrate-state"
    assert res.migrate_s < res.reprefill_s / 10


def test_migration_analysis_all_archs():
    for name in ASSIGNED:
        res = migration_vs_reprefill(get_config(name), 32_768)
        assert res.state_bytes > 0 and res.reprefill_s > 0


# ---------------------------------------------------------------------------
# The cost count: meta vs real tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_meta_equals_cpu(arch):
    """Reduced configs: the meta count of a train, prefill and decode step
    equals the count of the same step on real CPU tensors, and is positive;
    a kernel config is refused."""
    cfg = get_config(arch).reduced()
    counts = {}
    for kind, s in (("train", 32), ("prefill", 32), ("decode", 64)):
        shape = InputShape(f"{kind}_test", s, 2, kind)
        counts[kind] = step_flops(cfg, shape)
        assert counts[kind] == step_flops(cfg, shape, device="cpu") > 0, kind
    assert counts["train"] > counts["prefill"] > counts["decode"]
    with pytest.raises(ValueError, match="plain path"):
        step_flops(cfg.replace(attn_impl="cuda"), InputShape("t", 32, 2, "train"))


def test_step_flops_full_width_on_meta():
    """The paper model at full width, B 8 x 1024 train step: counted on meta
    with nothing allocated; remat recomputes the forward, so the count lies
    between the 6·N·D model and 6·N·D plus one forward's 2·N·D."""
    cfg = get_config("paper-qwen1.5-0.5b")
    shape = InputShape("train_8x1024", 1024, 8, "train")
    f = step_flops(cfg, shape)
    mf = model_flops(cfg, "train", 8, 1024)
    assert mf < f < mf * 1.5, (f, mf)


# ---------------------------------------------------------------------------
# grad_specs
# ---------------------------------------------------------------------------

TINY = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            d_ff=64, vocab_size=300, param_dtype="float32", compute_dtype="float32",
            grad_accum=2)


def test_grad_specs_noop_without_specs():
    """``grad_specs=None`` is a no-op: bit for bit the loss and gradients of
    a call without it (JAX's test asks a finite loss)."""
    cfg = ModelConfig(**TINY)
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 300, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    l0, _, g0 = grads_fn(params, cfg, batch)
    l1, _, g1 = grads_fn(params, cfg, batch, grad_specs=None)
    assert np.isfinite(float(l1)) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    _, _, m = make_train_step(cfg, OptConfig(), grad_specs=None)(
        params, init_opt_state(params), batch)
    assert torch.equal(m["loss"], l0)


def test_grad_specs_without_a_mesh_raise_as_in_jax():
    """A spec tree with no mesh bound raises RuntimeError, in JAX (at its
    sharding constraint) and in the port."""
    from repro_torch.launch.sharding import param_specs

    cfg = ModelConfig(**TINY)
    params = init_params(cfg, device="cpu")
    specs = param_specs(cfg, params)
    batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32),
             "labels": torch.zeros((4, 16), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="mesh"):
        grads_fn(params, cfg, batch, grad_specs=specs)
    with pytest.raises(RuntimeError, match="mesh"):
        make_train_step(cfg, OptConfig(), grad_specs=specs)(params, init_opt_state(params), batch)
    jcfg = JaxModelConfig(**TINY)
    jparams = jax_init_params(jax.random.key(0), jcfg)
    jspecs = jax_sharding.param_specs(jcfg, jparams)
    jbatch = {"tokens": jnp.zeros((4, 16), jnp.int32), "labels": jnp.zeros((4, 16), jnp.int32)}
    with pytest.raises(RuntimeError, match="mesh"):
        jax_grads_fn(jparams, jcfg, jbatch, grad_specs=jspecs)



def test_train_dry_run_names_the_missing_half(monkeypatch):
    """``launch.train --dry-run`` no longer exits 2: the launch's execution
    half is ported, and it runs the port's dry-run (``python -m
    repro_torch.launch.dryrun ... --shape train_4k``) and exits with its
    code."""
    import subprocess
    import sys

    from repro_torch.launch import train

    calls, codes = [], iter((0, 3))
    monkeypatch.setattr(subprocess, "run", lambda cmd, env=None: calls.append(cmd) or
                        types.SimpleNamespace(returncode=next(codes)))
    for flags, code in (([], 0), (["--multi-pod"], 3)):
        with pytest.raises(SystemExit) as e:
            train.main(["--arch", "qwen2-0.5b", "--dry-run", *flags, "--device", "cpu"])
        assert e.value.code == code
        assert calls.pop() == [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               "qwen2-0.5b", "--shape", "train_4k", *flags, "--device", "cpu"]
