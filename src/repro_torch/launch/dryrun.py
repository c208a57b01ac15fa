"""Multi-pod dry-run (``repro.launch.dryrun``): run one step of every
(architecture x input shape) on the production mesh of a fake process
group, on meta tensors, and report what one device would run: its FLOPs,
the bytes its operators touch, its collectives, and its argument bytes,
with the roofline terms.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k long_500k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The fake group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``) gives this one process rank 0 of 256 (or 512) ranks whose
collectives do nothing; parameters, moments, batch and caches are placed
on the mesh as DTensors by ``launch.sharding``'s specs, with meta shards,
so a full-size configuration allocates nothing. A process has one default
group, so the group is made in ``main`` (one per mesh) and never at
import. ``--device`` is the mesh's device type (default the card;
``cpu`` without one). DTensor redistributes over a CPU-typed mesh
without all-to-all: it gathers and chunks instead, so there an all-to-all
counts as an all-gather.

Where JAX compiles the step and reads XLA's cost analysis, the port runs
the step itself under ``_LocalCost``, a dispatch mode that sees the
operators each DTensor operator runs on this rank's shards: so the FLOPs
are one device's share (``FlopCounterMode`` over DTensors counts the
global operator), and the whole depth is counted as it runs (JAX probes
two depths because XLA counts a loop body once). The counter sees PyTorch
operators only, not the kernels' ``ctypes`` calls, so a kernel
configuration is refused; the mesh path is the plain path, as JAX's.
The serving steps run as they would on real ranks: ``prefill`` builds its
caches on the shards in ``cache_specs``' placements, ``decode_step``
writes each rank's shard of the caches and splits attention's softmax
over a slot-sharded cache (``models.attention._sdpa_split``), so their
collectives are the functional ones the counter sees.

``step_flops`` counts one step's FLOPs on one device, without a mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs import ALL, get_config
from ..device import DeviceLike, resolve_device
from ..models import abstract_params, decode_step, forward_full, init_params, prefill
from ..models.config import ModelConfig
from ..models.pjit_rules import P, rules_for, sharding_rules
from ..models.weights import tree_leaves
from ..roofline.analysis import RooflineResult, collective_bytes_by_type, model_flops
from ..training import OptConfig, init_opt_state, make_train_step
from ..training.trainer import grads_fn
from .mesh import make_production_mesh, n_chips
from .shapes import (
    SHAPES,
    InputShape,
    arch_for_shape,
    decode_cache_abstract,
    decode_inputs_abstract,
    prefill_inputs_abstract,
    train_batch_abstract,
)
from .sharding import (
    batch_specs,
    cache_specs,
    distribute_tree,
    fsdp_param_specs,
    opt_state_specs,
    param_specs,
)


def _on(tree: Any, dev: torch.device) -> Any:
    """An abstract tree's tensors as zeros on ``dev`` (itself on meta)."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    if dev.type == "meta":
        return tree
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def _step_inputs(cfg: ModelConfig, shape: InputShape, device: DeviceLike = "meta") -> Dict:
    """What one step of ``shape.kind`` takes: ``params`` (seed 0 on a real
    device) and the batch, or the tokens (and patch embeddings), or the
    tokens, positions and caches, all zeros."""
    dev = resolve_device(device)
    params = abstract_params(cfg) if dev.type == "meta" else init_params(cfg, device=dev)
    if shape.kind == "train":
        return {"params": params, "batch": _on(train_batch_abstract(cfg, shape), dev)}
    if shape.kind == "prefill":
        return {"params": params, **_on(prefill_inputs_abstract(cfg, shape), dev)}
    if shape.kind == "decode":
        return {"params": params, "caches": _on(decode_cache_abstract(cfg, shape), dev),
                **_on(decode_inputs_abstract(cfg, shape), dev)}
    raise ValueError(f"unknown step kind {shape.kind!r}")


def _run_step(cfg: ModelConfig, kind: str, inputs: Dict) -> None:
    """One step of ``kind`` on ``_step_inputs``' tensors."""
    if kind == "train":
        grads_fn(inputs["params"], cfg, inputs["batch"])
        return
    with torch.no_grad():
        if kind == "prefill":
            forward_full(inputs["params"], cfg, inputs["tokens"],
                         patch_embeds=inputs.get("patch_embeds"))
        else:
            decode_step(inputs["params"], cfg, inputs["caches"], inputs["tokens"],
                        inputs["pos"])


def _require_reference(cfg: ModelConfig, what: str) -> None:
    if cfg.attn_impl != "reference":
        raise ValueError(
            f"{cfg.name}: {what} counts the plain path (attn_impl='reference'), got "
            f"{cfg.attn_impl!r}: FlopCounterMode does not see the kernels' calls")


def step_flops(cfg: ModelConfig, shape: InputShape, device: DeviceLike = "meta") -> int:
    """FLOPs of one step of ``cfg`` at ``shape`` (kind train, prefill or
    decode), on one device, by ``FlopCounterMode``: train is ``grads_fn``
    (AdamW's elementwise updates count no FLOPs), prefill ``forward_full``,
    decode ``decode_step``. The caller selects the variant
    (``shapes.arch_for_shape``). ``device="meta"`` (the default) allocates
    nothing; any other device runs the step on zeros, for the same count."""
    _require_reference(cfg, "step_flops")
    inputs = _step_inputs(cfg, shape, device)
    with FlopCounterMode(display=False) as counter:
        _run_step(cfg, shape.kind, inputs)
    return counter.get_total_flops()


# ---------------------------------------------------------------------------
# One device's share of a step on the mesh
# ---------------------------------------------------------------------------

# collective operators (``func.name()``) under JAX's five HLO names
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "c10d::allreduce_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts: List[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _LocalCost(TorchDispatchMode):
    """What this rank runs: it declines every operator on DTensors, so
    DTensor dispatches it and the mode sees the operators on the local
    shards (and the collectives of the redistributions) instead. DTensor's
    shape inference runs operators on FakeTensors at global shapes; those
    are not counted. Records ``flops`` (``torch.utils.flop_counter``'s
    formulas), ``bytes`` (the tensor operands and results of every
    operator that returns no view, each once, no fusion: XLA's "bytes
    accessed" after fusion is smaller) and ``ops``: (JAX's collective
    name, result bytes) per collective, the result of an in-place one
    being its tensors."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        name = func.name()
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            result = _tensors(out) if name.startswith("_c10d_functional") else _tensors(args[0])
            self.ops.append((coll, _nbytes(result)))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins = _tensors(list(args) + list(kwargs.values()))
        if ins and not _aliases(func) and not name.startswith(("c10d", "_c10d")):
            self.bytes += _nbytes(ins) + _nbytes(_tensors(out))
        return out


def _aliases(func) -> bool:
    """Whether an operator returns views of its input (a view, ``chunk``,
    ``split``): it moves no bytes."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of a DTensor tree."""
    return _nbytes([t.to_local() for t in tree_leaves(tree)])


def _compile_variant(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
                     zero1: bool, fsdp: bool = False, act_seq: bool = False) -> Dict:
    """One step of one configuration variant on ``mesh`` (JAX lowers and
    compiles it): the inputs placed as DTensors on meta by the specs, the
    step run under ``_LocalCost`` and ``CommDebugMode`` with the rules
    bound (``"_mesh"`` set, as JAX's dry-run sets it). Train is the whole
    ``make_train_step`` with ``grad_specs``, prefill ``models.prefill``,
    decode ``models.decode_step`` on the caches. Returns the cost counts
    and ``argument_bytes`` (per device: parameters, moments, batch or
    caches)."""
    from torch.distributed.tensor.debug import CommDebugMode

    _require_reference(cfg, "the dry-run")
    rules = rules_for(cfg, multi_pod, kind=shape.kind)
    rules["_mesh"] = mesh  # shard-map paths (MoE expert-parallel) need it
    if act_seq and shape.kind != "decode":
        rules = dict(rules, act_seq="model")
    params_abs = abstract_params(cfg)
    pspecs = fsdp_param_specs(cfg, params_abs) if fsdp else param_specs(cfg, params_abs)
    params = distribute_tree(params_abs, pspecs, mesh)

    if shape.kind == "train":
        opt_abs = init_opt_state(params_abs)
        opt = distribute_tree(opt_abs, opt_state_specs(cfg, opt_abs, zero1=zero1), mesh)
        batch = distribute_tree(train_batch_abstract(cfg, shape),
                                batch_specs(cfg, multi_pod, "train"), mesh)
        args = (params, opt, batch)
        run = partial(make_train_step(cfg, OptConfig(), grad_specs=pspecs), *args)
    elif shape.kind == "prefill":
        inputs = distribute_tree(prefill_inputs_abstract(cfg, shape),
                                 batch_specs(cfg, multi_pod, "prefill"), mesh)
        args = (params, inputs)
        run = partial(prefill, params, cfg, inputs["tokens"], shape.seq_len,
                      patch_embeds=inputs.get("patch_embeds"))
    else:  # decode
        caches_abs = decode_cache_abstract(cfg, shape)
        seq_shard = shape.global_batch == 1
        caches = distribute_tree(
            caches_abs, cache_specs(cfg, caches_abs, multi_pod, seq_shard=seq_shard), mesh)
        inputs = decode_inputs_abstract(cfg, shape)
        dp = ("pod", "data") if multi_pod else ("data",)
        tok_nd = inputs["tokens"].ndim
        specs = {"tokens": P(*(None,) * tok_nd) if seq_shard else P(dp, *(None,) * (tok_nd - 1)),
                 "pos": P(None) if seq_shard else P(dp)}
        inputs = distribute_tree(inputs, specs, mesh)
        args = (params, caches, inputs)
        run = partial(decode_step, params, cfg, caches, inputs["tokens"], inputs["pos"])

    argument_bytes = _local_bytes(args)
    with CommDebugMode() as comm, _LocalCost() as cost, sharding_rules(rules), \
            torch.set_grad_enabled(shape.kind == "train"):
        run()
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "collectives": collective_bytes_by_type(cost.ops),
            "comm_debug_count": comm.get_total_counts(), "argument_bytes": argument_bytes}


def lower_combo(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    zero1: bool = True,
    verbose: bool = True,
    fsdp: Optional[bool] = None,
    act_seq: bool = False,
    mesh=None,
) -> Dict[str, Any]:
    """Run one (arch x shape x mesh) step on the production mesh and return
    its roofline record. ``mesh`` defaults to ``make_production_mesh`` on
    the default process group (of ``n_chips(multi_pod)`` ranks, as ``main``
    makes it). One pass at full depth gives every count (JAX compiles a
    production program, then unrolled depth probes for the costs). The
    record's ``peak_memory_bytes`` stays ``None``: meta tensors allocate
    nothing, so there is no memory analysis; ``argument_bytes`` is what
    the arguments hold per device."""
    cfg = arch_for_shape(get_config(arch), SHAPES[shape_name])
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    chips = n_chips(multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if fsdp is None:
        # auto-FSDP when TP-only parameter shards exceed half a TPU's HBM
        # (JAX's rule, kept so the specs are JAX's)
        fsdp = cfg.param_count() * 2 / 16 > 8e9

    t0 = time.perf_counter()
    cost = _compile_variant(cfg, shape, mesh, multi_pod, zero1, fsdp=fsdp, act_seq=act_seq)
    step_s = time.perf_counter() - t0
    coll = cost["collectives"]
    coll_bytes = sum(v for k, v in coll.items() if not k.endswith("_count"))
    mf = model_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    res = RooflineResult(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=cost["flops"],
        hlo_bytes=cost["bytes"],
        collective_bytes=float(coll_bytes),
        collectives=coll,
        model_flops=mf,
        peak_memory_bytes=None,
    )
    rec = res.to_dict()
    rec.update({
        "status": "ok",
        "step_s": step_s,
        "device_type": mesh.device_type,
        "argument_bytes_per_device": cost["argument_bytes"],
        "comm_debug_count": cost["comm_debug_count"],
        "fsdp": bool(fsdp),
        "act_seq": bool(act_seq),
        "attn_variant": cfg.attn_variant,
    })
    if verbose:
        print(f"== {arch} × {shape_name} × {mesh_name} "
              f"({'zero1 ' if zero1 else ''}variant={cfg.attn_variant}) ==")
        print(f"  compile: {step_s:.1f}s (one step on meta shards, mesh device "
              f"{mesh.device_type})")
        print(f"  memory_analysis: argument_bytes_per_device={cost['argument_bytes']} "
              f"peak=None (meta tensors allocate nothing)")
        print(f"  cost_analysis: flops={res.hlo_flops:.3e} bytes={res.hlo_bytes:.3e}")
        print("  collectives: " + ", ".join(
            f"{k}={v/1e6:.1f}MB(n={coll[k + '_count']})"
            for k, v in coll.items()
            if not k.endswith("_count") and coll[k + "_count"]
        ))
        print(f"  roofline: compute={res.compute_s*1e3:.2f}ms "
              f"memory={res.memory_s*1e3:.2f}ms "
              f"collective={res.collective_s*1e3:.2f}ms -> {res.dominant}-bound")
        print(f"  MODEL_FLOPS={mf:.3e} useful-ratio={res.useful_flops_ratio:.3f}")
    return rec


def _fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake default group of ``world_size``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv: Optional[List[str]] = None) -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", default=None, nargs="+", choices=sorted(SHAPES),
                    help="one or more shapes (default: all four)")
    ap.add_argument("--all", action="store_true",
                    help="all 11 configurations (JAX's 10 and the paper model) × the shapes")
    ap.add_argument("--multi-pod", action="store_true", help="2×16×16 mesh (512 devices)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-zero1", action="store_true",
                    help="ablation: replicate optimizer state instead of ZeRO-1")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake mesh: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device_type = resolve_device(args.device).type

    # unlike JAX's, --shape narrows --all to the shapes given
    archs = sorted(ALL) if (args.all or not args.arch) else [args.arch]
    shapes = args.shape or sorted(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    failures = 0
    for mp in meshes:
        _fake_group(n_chips(mp))
        mesh = make_production_mesh(multi_pod=mp, device_type=device_type)
        for arch in archs:
            for shape in shapes:
                try:
                    records.append(lower_combo(arch, shape, multi_pod=mp,
                                               zero1=not args.no_zero1, mesh=mesh))
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures += 1
                    traceback.print_exc()
                    print(f"FAIL {arch} × {shape} × {'2x16x16' if mp else '16x16'}: "
                          f"{type(e).__name__}: {e}")
                    records.append({
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": f"FAIL: {type(e).__name__}: {e}",
                    })
        dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + records, f, indent=1)
    ok = sum(1 for r in records if r.get("status") == "ok")
    print(f"\n{ok}/{len(records)} combos ran successfully")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
