"""The multi-device launch's execution half of the port (``repro_torch.
models.pjit_rules.constrain`` / ``placements``, ``launch.mesh.
make_production_mesh``, ``launch.sharding.layer_specs`` /
``distribute_tree``, the trainer's ``grad_specs`` on a mesh, the shard-map
MoE, ``core.mesh_context``'s migrations, ``launch.dryrun``) against the JAX
package's, on the CPU.

In-process: the spec-to-placements converter, ``constrain`` as a no-op
without a mesh, the per-layer cut of the eleven configurations' specs at
full width on meta, one device's FLOPs of a column-parallel product on a
fake 16-way mesh. Then three runs at once:
a JAX subprocess (8 host devices, meshes with Auto axes) writes its
results to an ``.npz``; an 8-rank gloo spawn (``tests/_torch_mesh.py``,
``file://`` rendezvous) runs the port's counterparts on the same inputs
and weights (bridged by ``params_from_numpy``); a subprocess runs the
port's dry-run of the full-width paper model at train_4k on a fake 16 x 16
group. Tolerances are ``tests/test_perf_features.py``'s shard-map check's:
logits 2e-4, gradients rtol 5e-3 / atol 1e-5; migration is exact."""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALL, PAPER_QWEN15_0_5B, get_config
from repro_torch.launch.sharding import (
    fsdp_param_specs,
    layer_specs,
    opt_state_specs,
    param_specs,
)
from repro_torch.models import (
    ModelConfig,
    abstract_params,
    forward_full,
    init_params,
    params_from_numpy,
)
from repro_torch.models.pjit_rules import P, constrain, placements, rules_for, sharding_rules
from repro_torch.models.weights import jax_layout, params_to_numpy, tree_leaves
from repro_torch.training import init_opt_state
from repro_torch.training.trainer import grads_fn

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
MESH_16 = {"data": 16, "model": 16}
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)

DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=256, param_dtype="float32", compute_dtype="float32",
             grad_accum=2)
MOE = dict(name="m", arch_type="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=128, vocab_size=256, n_experts=4, top_k=2, capacity_factor=8.0,
           param_dtype="float32", compute_dtype="float32", moe_impl="shard_map")
TOKENS = np.random.default_rng(1).integers(0, 256, (8, 16)).astype(np.int32)
BUF = np.arange(2 * 3 * 4, dtype=np.int32).reshape(2, 3, 4)
CACHE = {"k": np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4),
         "v": np.ones((2, 4, 4), np.float32) * np.arange(2, dtype=np.float32)[:, None, None]}


def fake_mesh(**axes):
    """What ``placements`` reads of a ``DeviceMesh``."""
    return types.SimpleNamespace(mesh_dim_names=tuple(axes), ndim=len(axes),
                                 size=lambda i: list(axes.values())[i])


# ---------------------------------------------------------------------------
# In-process
# ---------------------------------------------------------------------------

def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh(pod=2, data=16, model=16)
    assert placements(P(), mesh) == [Replicate()] * 3
    assert placements(P(None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    assert placements(P(("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements(P("data", "model"), fake_mesh(data=4, model=2)) == [Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="twice"):
        placements(P("model", "model"), mesh)
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)


def test_constrain_is_a_noop_without_a_mesh():
    """No rules, rules without ``"_mesh"``, a plain tensor, a rank
    mismatch: ``constrain`` returns its argument, and the forward of a
    config under rules without a mesh is bit for bit the one without."""
    x = torch.randn(2, 3, 4)
    assert constrain(x, "batch", None, None) is x
    rules = rules_for(ModelConfig(**DENSE), False, model_size=2)
    with sharding_rules(rules):
        assert constrain(x, "batch", None, None) is x
        assert constrain(x, "batch") is x
    with sharding_rules(dict(rules, _mesh=fake_mesh(data=4, model=2))):
        assert constrain(x, "batch", None, None) is x
    cfg = ModelConfig(**DENSE)
    params = params_from_numpy(weights(DENSE), cfg, device="cpu")
    toks = torch.from_numpy(TOKENS)
    want, _ = forward_full(params, cfg, toks)
    with sharding_rules(rules):
        got, _ = forward_full(params, cfg, toks)
    assert torch.equal(want, got)


def _shards(spec, shape, mesh=MESH_16):
    n = 1
    for axis, dim in zip(tuple(spec), shape):
        for a in () if axis is None else (axis,) if isinstance(axis, str) else axis:
            assert dim % mesh[a] == 0
            n *= mesh[a]
    return n


def _bytes_per_device(tree, specs):
    return sum(t.numel() * t.element_size() // _shards(s, t.shape)
               for t, s in zip(tree_leaves(tree), tree_leaves(specs)))


@pytest.mark.parametrize("arch", sorted(ALL))
def test_layer_specs_cut_the_stack_entries(arch):
    """``layer_specs`` cuts the stacked specs into the per-layer tree: each
    leaf's spec has its rank and divides it on 16 x 16, and the bytes per
    device equal the stacked specs' (JAX's), but for Mamba2-1.3B's five
    SSM leaves, whose ``data`` entry on the stack axis (FSDP, ZeRO-1) is
    dropped: replicated per layer, they keep 124,560 more bytes per device
    as parameters (132,864 against 8,304) and 246,960 more as an f32
    moment."""
    cfg = get_config(arch)
    tree = abstract_params(cfg)
    moments = init_opt_state(tree)["m"]
    extra = {}
    for kind, leaves, specs in (
            ("tp", tree, param_specs(cfg, tree)), ("fsdp", tree, fsdp_param_specs(cfg, tree)),
            ("zero1", moments, opt_state_specs(cfg, init_opt_state(tree), zero1=True)["m"])):
        cut = layer_specs(leaves, specs)
        for leaf, spec in zip(tree_leaves(leaves), tree_leaves(cut)):
            assert isinstance(spec, P) and len(spec) == leaf.ndim, (kind, spec, leaf.shape)
        extra[kind] = (_bytes_per_device(leaves, cut)
                       - _bytes_per_device(jax_layout(leaves, torch.stack), specs))
    if arch == "mamba2-1.3b":
        assert extra == {"tp": 0, "fsdp": 124_560, "zero1": 246_960}, extra
    else:
        assert extra == {"tp": 0, "fsdp": 0, "zero1": 0}, extra


def test_per_device_flops_of_a_column_parallel_product():
    """On a fake 16-way model axis, the dry-run's counter gives one
    device's FLOPs of a (64, 1024) @ (1024, 4096) product with the weight's
    columns sharded: the global count / 16 (``FlopCounterMode`` over the
    DTensors counts the global product)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import _LocalCost, _fake_group

    _fake_group(16)
    try:
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
        x = distribute_tensor(torch.empty(64, 1024, device="meta"), mesh, [Replicate()])
        w = distribute_tensor(torch.empty(1024, 4096, device="meta"), mesh, [Shard(1)])
        with FlopCounterMode(display=False) as whole:
            x @ w
        with _LocalCost() as local:
            y = x @ w
        assert y.placements == (Shard(1),) and y.to_local().shape == (64, 256)
        assert whole.get_total_flops() == 2 * 64 * 1024 * 4096
        assert local.flops == whole.get_total_flops() // 16 and local.ops == []
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX subprocess, the gloo spawn and the dry-run, run at once
# ---------------------------------------------------------------------------

JAX_RUN = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    SRC, INPUTS, OUT = sys.argv[1:]
    sys.path.insert(0, SRC)
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.core.mesh_context import migrate_kv_cache, migrate_tokens
    from repro.launch.sharding import param_specs
    from repro.models import ModelConfig, forward_full
    from repro.models.pjit_rules import rules_for, sharding_rules
    from repro.training.trainer import grads_fn, loss_fn

    def mesh(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

    with open(INPUTS, "rb") as f:
        given = pickle.load(f)
    out = {}
    m3 = mesh((2, 2, 2), ("pod", "data", "model"))
    with m3:
        out["tokens"] = np.asarray(migrate_tokens(m3, jnp.asarray(given["buf"]), 0, 1))
        moved = migrate_kv_cache(m3, {k: jnp.asarray(v) for k, v in given["cache"].items()},
                                 1, 0)
    out.update({"cache_" + k: np.asarray(v) for k, v in moved.items()})

    m2 = mesh((4, 2), ("data", "model"))
    toks = jnp.asarray(given["tokens"])
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    moe_rules = {"batch": ("data",), "seq": None, "heads": None, "kv_heads": None,
                 "d_ff": None, "d_model": None, "vocab": None, "ssm_inner": None}
    for name in ("dense", "moe"):
        cfg = ModelConfig(**given[name + "_cfg"])
        params = jax.tree.map(jnp.asarray, given[name + "_params"])
        if name == "dense":
            rules, specs = rules_for(cfg, False, model_size=2), param_specs(cfg, params, 2)
        else:
            rules, specs = moe_rules, None
        with m2, sharding_rules(dict(rules, _mesh=m2)):
            logits, aux = jax.jit(lambda p, t: forward_full(p, cfg, t))(params, toks)
            if name == "dense":
                loss, _, g = jax.jit(lambda p, b: grads_fn(p, cfg, b, grad_specs=specs))(
                    params, batch)
            else:
                loss, g = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, cfg, batch)[0]))(
                    params)
        out[name + "_logits"] = np.asarray(logits)
        out[name + "_aux"] = np.asarray(aux)
        out[name + "_loss"] = np.asarray(loss)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            out[f"{name}_g{i}"] = np.asarray(leaf)
    np.savez(OUT, **out)
    print("JAX_OK")
    """
)


def weights(kw):
    """Seed-0 weights of a config as a JAX parameter tree of numpy arrays:
    the JAX subprocess takes them as they are, the port through
    ``params_from_numpy``."""
    cfg = ModelConfig(**kw)
    return params_to_numpy(init_params(cfg, seed=0, device="cpu"), cfg)


ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module", autouse=True)
def dry_run(tmp_path_factory):
    """The port's dry-run of the full-width paper model at train_4k on a
    fake 16 x 16 group, started first (the longest run) so that it runs
    beside the in-process tests."""
    out = str(tmp_path_factory.mktemp("dryrun") / "dryrun.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", PAPER_QWEN15_0_5B.name,
         "--shape", "train_4k", "--device", "cpu", "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=os.path.dirname(out))
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dry_run):
    """Start the JAX subprocess, run the gloo spawn meanwhile, then wait
    for it and for the dry-run; returns the three results."""
    import torch.multiprocessing as mp

    import _torch_mesh

    tmp = tmp_path_factory.mktemp("mesh")
    inputs, jax_out, port_out = (str(tmp / n) for n in ("inputs.pkl", "jax.npz", "port.pkl"))
    with open(inputs, "wb") as f:
        pickle.dump({"buf": BUF, "cache": CACHE, "tokens": TOKENS,
                     "dense_cfg": DENSE, "dense_params": weights(DENSE),
                     "moe_cfg": MOE, "moe_params": weights(MOE)}, f)
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_RUN, SRC, inputs, jax_out],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=ENV)
    try:
        mp.spawn(_torch_mesh.run_rank, args=(8, str(tmp / "rdzv"), inputs, port_out),
                 nprocs=8, join=True)
        jax_stdout, jax_stderr = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert "JAX_OK" in jax_stdout, jax_stdout + jax_stderr
    with open(port_out, "rb") as f:
        port = pickle.load(f)
    proc, dry_out = dry_run
    dry_stdout, dry_stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, dry_stdout + dry_stderr
    with open(dry_out) as f:
        record = json.load(f)[0]
    return {"jax": dict(np.load(jax_out)), "port": port, "dry": record, "dry_stdout": dry_stdout}


def test_migration_moves_the_pod_shard_exactly(runs):
    jx, port = runs["jax"], runs["port"]
    np.testing.assert_array_equal(port["tokens"].numpy(), jx["tokens"])
    np.testing.assert_array_equal(jx["tokens"][1], BUF[0])   # dst got src's shard
    np.testing.assert_array_equal(jx["tokens"][0], BUF[0])   # src unchanged
    for k in CACHE:
        np.testing.assert_array_equal(port["cache"][k].numpy(), jx["cache_" + k])
    np.testing.assert_array_equal(jx["cache_k"][0], CACHE["k"][1])


def _grad_leaves(grads, kw):
    return jax.tree.leaves(params_to_numpy(grads, ModelConfig(**kw)))


def test_dense_forward_and_grad_specs_on_a_mesh_match_jax(runs):
    """The tiny dense config on a (4, 2) mesh, parameters placed by
    ``param_specs(model_size=2)`` under ``rules_for``: logits, loss and the
    ``grad_specs`` gradients (two microbatches) match JAX's on its Auto
    mesh, and each gradient leaf comes back in its parameter's placements."""
    jx, port = runs["jax"], runs["port"]["dense"]
    np.testing.assert_allclose(port["logits"].numpy(), jx["dense_logits"], **LOGIT_TOL)
    np.testing.assert_allclose(float(port["loss"]), float(jx["dense_loss"]), **LOGIT_TOL)
    got = _grad_leaves(port["grads"], DENSE)
    assert len(got) == len([k for k in jx if k.startswith("dense_g")])
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, jx[f"dense_g{i}"], **GRAD_TOL)
    cfg = ModelConfig(**DENSE)
    params = params_from_numpy(weights(DENSE), cfg, device="cpu")
    mesh = fake_mesh(data=4, model=2)
    want = [str(tuple(placements(s, mesh)))
            for s in tree_leaves(layer_specs(params, param_specs(cfg, params, 2)))]
    assert port["placements"] == want


def test_shard_map_moe_matches_jax_and_the_gspmd_path(runs):
    """The shard-map MoE config of ``tests/test_perf_features.py`` on the
    (4, 2) mesh: logits, aux and gradients match JAX's shard map on its
    Auto mesh and the port's single-device gspmd path on the same weights."""
    jx, port = runs["jax"], runs["port"]["moe"]
    cfg = ModelConfig(**MOE)
    params = params_from_numpy(weights(MOE), cfg, device="cpu")
    toks = torch.from_numpy(TOKENS)
    gspmd = cfg.replace(moe_impl="gspmd")
    ref_logits, ref_aux = forward_full(params, gspmd, toks)
    _, _, ref_grads = grads_fn(params, gspmd, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    n = len([k for k in jx if k.startswith("moe_g")])
    for want_logits, want_aux, want_grads in (
            (jx["moe_logits"], jx["moe_aux"], [jx[f"moe_g{i}"] for i in range(n)]),
            (ref_logits.numpy(), ref_aux.numpy(), _grad_leaves(ref_grads, MOE))):
        np.testing.assert_allclose(port["logits"].numpy(), want_logits, **LOGIT_TOL)
        np.testing.assert_allclose(float(port["aux"]), float(want_aux), rtol=1e-5)
        got = _grad_leaves(port["grads"], MOE)
        assert len(got) == len(want_grads)
        for g, w in zip(got, want_grads):
            np.testing.assert_allclose(g, w, **GRAD_TOL)


def _argument_bytes(cfg, shape):
    """The specs' arithmetic on 16 x 16: parameters under ``param_specs``,
    the two f32 moments under ZeRO-1 and the int32 step, the int32 tokens
    and labels over ``data``."""
    from repro_torch.launch.sharding import batch_specs
    from repro_torch.launch.shapes import train_batch_abstract

    tree = abstract_params(cfg)
    stacked = jax_layout(tree, torch.stack)
    opt = init_opt_state(tree)
    params = _bytes_per_device(stacked, param_specs(cfg, tree))
    moments = 2 * _bytes_per_device(jax_layout(opt["m"], torch.stack),
                                    opt_state_specs(cfg, opt, zero1=True)["m"])
    batch = train_batch_abstract(cfg, shape)
    specs = batch_specs(cfg, False, "train")
    return params + moments + 4 + _bytes_per_device([batch[k] for k in specs],
                                                     [specs[k] for k in specs])


def test_dry_run_of_the_paper_model_at_train_4k(runs):
    """``launch.dryrun`` on a fake 16 x 16 group (``--device cpu``): the
    full-width paper model's train_4k step. Its argument bytes per device
    are the specs' arithmetic; it ran collectives (counted twice, by the
    dry-run's counter and by ``CommDebugMode``, the same number) and
    FLOPs; it prints JAX's lines."""
    from repro_torch.launch.shapes import SHAPES

    rec, out = runs["dry"], runs["dry_stdout"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["argument_bytes_per_device"] == _argument_bytes(PAPER_QWEN15_0_5B,
                                                               SHAPES["train_4k"])
    counts = {k: v for k, v in rec["collectives"].items() if k.endswith("_count")}
    assert sum(counts.values()) > 0 and sum(counts.values()) == rec["comm_debug_count"]
    assert rec["collectives"]["all-reduce_count"] > 0 and rec["collective_bytes"] > 0
    assert 0 < rec["hlo_flops"] < rec["model_flops"] and rec["peak_memory_bytes"] is None
    for head in ("== paper-qwen1.5-0.5b × train_4k × 16x16", "  compile:", "  memory_analysis:",
                 "  cost_analysis:", "  collectives:", "  roofline:", "  MODEL_FLOPS="):
        assert head in out, (head, out)
