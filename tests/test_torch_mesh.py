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
SERVE_STEPS = 4
_F32 = dict(param_dtype="float32", compute_dtype="float32")
_TINY = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=256, **_F32)
_RING = dict(_TINY, attn_variant="sliding_window", sliding_window=8)
SERVE_MAX_LEN, SERVE_APPEND = 20, 4
# serving cases: (config, on the (2, 2, 2) mesh, prompt rows x length, then
# a SERVE_APPEND-token prefill_append). (a) KV heads over model; (b) one KV
# head, slots over model (10 a rank: the prefill straddles them); (c) one
# sequence, slots over data, a window of 8 that wraps in the 10-token
# prefill and again in decode; (d) (c) with slots over (pod, data); (e)
# Mamba2-style, SSM heads over model
SERVE = {
    "a_kv_heads_over_model": (_TINY, False, 8, 12, True),
    "b_slots_over_model": (dict(_TINY, n_kv_heads=1), False, 8, 12, True),
    "c_ring_slots_over_data": (_RING, False, 1, 10, False),
    "d_ring_slots_over_pod_data": (_RING, True, 1, 10, False),
    "e_ssm_heads_over_model": (dict(name="s", arch_type="ssm", n_layers=2, d_model=32, n_heads=0,
                                    n_kv_heads=0, d_ff=0, vocab_size=256, ssm_state=16,
                                    ssm_head_dim=8, ssm_chunk=4, **_F32), False, 8, 12, False),
}
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

    import repro.launch.sharding as jsh
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.models import decode_step, prefill, prefill_append

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from paths(tree[k], f"{prefix}.{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from paths(v, f"{prefix}.{i}")
        else:
            yield prefix, tree

    def place(m, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(m, s)), tree, specs,
                            is_leaf=lambda x: isinstance(x, JP))

    m2 = mesh((4, 2), ("data", "model"))
    for name, case in given["serve"].items():
        cfg = ModelConfig(**case["cfg"])
        m = m3 if case["pod"] else m2
        multi = case["pod"]
        toks = jnp.asarray(case["tokens"])
        seq = toks.shape[0] == 1
        dp = ("pod", "data") if multi else ("data",)
        tok_spec, lanes = (JP(None, None), JP(None)) if seq else (JP(dp, None), JP(dp))
        params = jax.tree.map(jnp.asarray, case["params"])
        params = place(m, params, jsh.param_specs(cfg, params, 2))
        with m, sharding_rules(dict(rules_for(cfg, multi, 2, kind="prefill"), _mesh=m)):
            logits, caches, pos = jax.jit(lambda p, t: prefill(p, cfg, t, case["max_len"]))(
                params, jax.device_put(toks, NamedSharding(m, tok_spec)))
        caches = place(m, caches, jsh.cache_specs(cfg, caches, multi, 2, seq_shard=seq))
        step = jax.jit(lambda p, c, t, q: decode_step(p, cfg, c, t, q))
        logits, tokens = [np.asarray(logits)], [np.asarray(logits).argmax(-1)]
        for _ in range(case["steps"]):
            with m, sharding_rules(dict(rules_for(cfg, multi, 2, kind="decode"), _mesh=m)):
                lg, caches = step(params, caches,
                                  jax.device_put(jnp.asarray(tokens[-1])[:, None],
                                                 NamedSharding(m, tok_spec)),
                                  jax.device_put(pos, NamedSharding(m, lanes)))
            logits.append(np.asarray(lg)[:, 0])
            tokens.append(logits[-1].argmax(-1))
            pos = pos + 1
        if case["append"] is not None:
            with m, sharding_rules(dict(rules_for(cfg, multi, 2, kind="prefill"), _mesh=m)):
                lg, caches, _ = jax.jit(lambda p, c, t, q: prefill_append(p, cfg, c, t, q))(
                    params, caches,
                    jax.device_put(jnp.asarray(case["append"]), NamedSharding(m, tok_spec)), pos)
            logits.append(np.asarray(lg))
            tokens.append(logits[-1].argmax(-1))
        out[f"serve_{name}_logits"] = np.stack(logits)
        out[f"serve_{name}_tokens"] = np.stack(tokens)
        for k, v in paths(caches):
            out[f"serve_{name}_cache{k}"] = np.asarray(v)

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


SERVE_SHAPES = ("decode_32k", "long_500k", "prefill_32k")
# JAX's dry-run of qwen2-0.5b at the serving shapes (512 host devices, set
# by the module on import): each record's argument bytes per device
JAX_DRY = textwrap.dedent(
    """
    import json, re, sys
    SRC, OUT, *SHAPES = sys.argv[1:]
    sys.path.insert(0, SRC)
    from repro.launch.dryrun import lower_combo
    recs = {}
    for shape in SHAPES:
        rec = lower_combo("qwen2-0.5b", shape, verbose=False)
        arg = re.search(r"argument_size_in_bytes=(\\d+)", rec["memory_analysis"])
        recs[shape] = {"argument_size_in_bytes": int(arg.group(1)),
                       "collective_bytes": rec["collective_bytes"]}
    with open(OUT, "w") as f:
        json.dump(recs, f)
    """
)


@pytest.fixture(scope="module", autouse=True)
def dry_run(tmp_path_factory):
    """The port's dry-run of the full-width paper model at train_4k, and of
    qwen2-0.5b at the three serving shapes, each on a fake 16 x 16 group,
    and JAX's of the latter, started first (the longest runs) so that they
    run beside the in-process tests."""
    tmp = tmp_path_factory.mktemp("dryrun")
    outs = {k: str(tmp / f"{k}.json") for k in ("train", "serve", "jax")}
    procs = {
        "train": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                  PAPER_QWEN15_0_5B.name, "--shape", "train_4k", "--device", "cpu",
                  "--out", outs["train"]],
        "serve": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
                  "--shape", *SERVE_SHAPES, "--device", "cpu", "--out", outs["serve"]],
        "jax": [sys.executable, "-c", JAX_DRY, SRC, outs["jax"], *SERVE_SHAPES],
    }
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, env=ENV, cwd=str(tmp))
             for k, cmd in procs.items()}
    yield procs, outs
    for proc in procs.values():
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
                     "moe_cfg": MOE, "moe_params": weights(MOE),
                     "serve": {name: {"cfg": kw, "params": weights(kw), "pod": pod,
                                      "tokens": TOKENS[:b, :s], "max_len": SERVE_MAX_LEN,
                                      "steps": SERVE_STEPS,
                                      "append": TOKENS[:b, s:s + SERVE_APPEND] if app else None}
                               for name, (kw, pod, b, s, app) in SERVE.items()}}, f)
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
    procs, outs = dry_run
    stdout = {}
    for k, proc in procs.items():
        stdout[k], err = proc.communicate(timeout=300)
        assert proc.returncode == 0, stdout[k] + err
    with open(outs["train"]) as f:
        record = json.load(f)[0]
    with open(outs["serve"]) as f:
        serve = {r["shape"]: r for r in json.load(f)}
    with open(outs["jax"]) as f:
        jax_serve = json.load(f)
    return {"jax": dict(np.load(jax_out)), "port": port, "dry": record,
            "dry_stdout": stdout["train"], "dry_serve": serve, "jax_serve": jax_serve}


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


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_on_a_mesh_matches_jax(runs, case):
    """``prefill`` then greedy ``decode_step``s of a serving case (then, on
    full caches, a ``prefill_append`` of the next tokens), each package on
    its mesh under ``rules_for(..., kind=...)`` with the caches in
    ``cache_specs``' placements (JAX places them so, the port's
    ``prefill`` returns them so): the greedy tokens are identical, the
    logits and the final K/V / h / conv within ``LOGIT_TOL``, every
    ``kv_pos`` exact, and every cache leaf the port returns keeps its
    ``cache_specs`` placements."""
    jx, port = runs["jax"], runs["port"]["serve"][case]
    np.testing.assert_array_equal(port["tokens"].numpy(), jx[f"serve_{case}_tokens"])
    np.testing.assert_allclose(port["logits"].numpy(), jx[f"serve_{case}_logits"], **LOGIT_TOL)
    want = {k[len(f"serve_{case}_cache"):]: v for k, v in jx.items()
            if k.startswith(f"serve_{case}_cache")}
    assert sorted(port["caches"]) == sorted(want)
    for path, got in port["caches"].items():
        if path.endswith("kv_pos"):
            np.testing.assert_array_equal(got.numpy(), want[path], err_msg=path)
        else:
            np.testing.assert_allclose(got.numpy(), want[path], err_msg=path, **LOGIT_TOL)
    assert port["placements"] == port["want"]


@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_dry_run_serving_shapes_match_jax(runs, shape):
    """The port's dry-run of qwen2-0.5b at a serving shape on a fake 16 x 16
    group holds JAX's argument bytes per device (XLA's
    ``argument_size_in_bytes``: parameters, caches or tokens, positions)
    exactly, and at decode its collectives move under 32 MB per device
    (JAX's 4.6 and 0.2 MB): the slot-sharded cache is attended on its
    shards, never gathered (3.2 GB at decode_32k)."""
    rec, want = runs["dry_serve"][shape], runs["jax_serve"][shape]
    assert rec["status"] == "ok" and rec["shape"] == shape
    assert rec["argument_bytes_per_device"] == want["argument_size_in_bytes"]
    if shape != "prefill_32k":
        assert rec["collective_bytes"] < 32e6, rec["collectives"]
        assert rec["collectives"]["all-reduce_count"] > 0
