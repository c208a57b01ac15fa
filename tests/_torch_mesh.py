"""One rank of the port's mesh checks (``tests/test_torch_mesh.py``), run
by ``torch.multiprocessing.spawn`` on a gloo group: it imports torch and
the port only, so the spawned processes do not import JAX.

Every rank runs the same programs on its shards; rank 0 writes the whole
results (``full_tensor``) to ``out`` as a pickle of torch tensors:

- ``migrate_tokens`` / ``migrate_kv_cache`` on a (2, 2, 2) (pod, data,
  model) mesh, with ``tests/test_mesh_context.py``'s inputs;
- the dense config's ``forward_full`` and ``grads_fn`` (with
  ``grad_specs``) on a (4, 2) (data, model) mesh under ``rules_for(...,
  model_size=2)``, parameters placed by ``param_specs``;
- the MoE config's shard-map forward and gradients on that mesh under the
  rules of ``tests/test_perf_features.py``'s shard-map check, parameters
  replicated as that check's are;
- each serving case's ``prefill``, greedy ``decode_step``s and, on full
  caches, a ``prefill_append`` on its mesh under ``rules_for(...,
  kind=...)``, parameters placed by ``param_specs``, the tokens over the
  batch (replicated for one sequence), the caches as ``prefill`` returns
  them: the logits, greedy tokens, final caches, and each cache leaf's
  placements beside ``cache_specs``'.
"""

import os
import pickle

import torch
import torch.distributed as dist

MOE_RULES = {"batch": ("data",), "seq": None, "heads": None, "kv_heads": None, "d_ff": None,
             "d_model": None, "vocab": None, "ssm_inner": None}


def _full(tree):
    from repro_torch.models.weights import tree_map

    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


def paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts (keys sorted) and lists, as the JAX
    subprocess names its cache leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _serve(case, mesh):
    """One serving case on ``mesh``: prefill, greedy decode steps, and on
    full caches an append of the given tokens."""
    from repro_torch.launch.sharding import cache_specs, distribute_tree, param_specs
    from repro_torch.models import (
        ModelConfig,
        decode_step,
        params_from_numpy,
        prefill,
        prefill_append,
    )
    from repro_torch.models.pjit_rules import P, placements, rules_for, sharding_rules

    cfg = ModelConfig(**case["cfg"])
    params = params_from_numpy(case["params"], cfg, device="cpu")
    multi = "pod" in mesh.mesh_dim_names
    dp = ("pod", "data") if multi else ("data",)
    toks = torch.from_numpy(case["tokens"])
    seq_shard = toks.shape[0] == 1
    lanes = P(None) if seq_shard else P(dp)
    tok_spec = P(None, None) if seq_shard else P(dp, None)
    dparams = distribute_tree(params, param_specs(cfg, params, 2), mesh)
    with sharding_rules(dict(rules_for(cfg, multi, model_size=2, kind="prefill"), _mesh=mesh)):
        logits, caches, pos = prefill(dparams, cfg, distribute_tree(toks, tok_spec, mesh),
                                      case["max_len"])
    logits = [logits.full_tensor()]
    tokens = [logits[-1].argmax(-1)]
    for _ in range(case["steps"]):
        with sharding_rules(dict(rules_for(cfg, multi, model_size=2, kind="decode"),
                                 _mesh=mesh)):
            step, caches = decode_step(dparams, cfg, caches,
                                       distribute_tree(tokens[-1][:, None], tok_spec, mesh),
                                       distribute_tree(pos, lanes, mesh))
        logits.append(step.full_tensor()[:, 0])
        tokens.append(logits[-1].argmax(-1))
        pos = pos + 1
    if case["append"] is not None:
        with sharding_rules(dict(rules_for(cfg, multi, model_size=2, kind="prefill"),
                                 _mesh=mesh)):
            step, caches, _ = prefill_append(
                dparams, cfg, caches,
                distribute_tree(torch.from_numpy(case["append"]), tok_spec, mesh), int(pos[0]))
        logits.append(step.full_tensor())
        tokens.append(logits[-1].argmax(-1))
    specs = dict(paths(cache_specs(cfg, caches, multi, 2, seq_shard=seq_shard)))
    return {"logits": torch.stack(logits), "tokens": torch.stack(tokens),
            "caches": {k: t.full_tensor() for k, t in paths(caches)},
            "placements": {k: str(tuple(t.placements)) for k, t in paths(caches)},
            "want": {k: str(tuple(placements(s, mesh))) for k, s in specs.items()}}


def run_rank(rank: int, world: int, rdzv: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
    try:
        _run(rank, inputs, out)
    finally:
        dist.destroy_process_group()


def _run(rank: int, inputs: str, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.mesh_context import migrate_kv_cache, migrate_tokens
    from repro_torch.launch.sharding import batch_specs, distribute_tree, param_specs
    from repro_torch.models import ModelConfig, forward_full, params_from_numpy
    from repro_torch.models.pjit_rules import P, placements, rules_for, sharding_rules
    from repro_torch.models.weights import tree_leaves, tree_map
    from repro_torch.training.trainer import grads_fn

    with open(inputs, "rb") as f:
        given = pickle.load(f)
    res = {}

    mesh3 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    pod = lambda a: distribute_tensor(torch.from_numpy(a), mesh3,  # noqa: E731
                                      placements(P("pod", None, None), mesh3))
    res["tokens"] = migrate_tokens(mesh3, pod(given["buf"]), 0, 1).full_tensor()
    moved = migrate_kv_cache(mesh3, {k: pod(v) for k, v in given["cache"].items()}, 1, 0)
    res["cache"] = _full(moved)

    mesh2 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    toks = torch.from_numpy(given["tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    for name in ("dense", "moe"):
        cfg = ModelConfig(**given[name + "_cfg"])
        params = params_from_numpy(given[name + "_params"], cfg, device="cpu")
        if name == "dense":
            specs = param_specs(cfg, params, 2)
            rules = dict(rules_for(cfg, False, model_size=2), _mesh=mesh2)
            dbatch = distribute_tree(batch, batch_specs(cfg, False, "train"), mesh2)
        else:
            specs = tree_map(lambda t: P(), params)
            rules = dict(MOE_RULES, _mesh=mesh2)
            dbatch = distribute_tree(batch, {k: P() for k in batch}, mesh2)
        dparams = distribute_tree(params, specs, mesh2)
        with sharding_rules(rules):
            logits, aux = forward_full(dparams, cfg, dbatch["tokens"])
            loss, _, grads = grads_fn(dparams, cfg, dbatch,
                                      grad_specs=specs if name == "dense" else None)
        res[name] = {"logits": logits.full_tensor(), "aux": _full(aux), "loss": _full(loss),
                     "grads": _full(grads),
                     "placements": [str(g.placements) for g in tree_leaves(grads)]}
    with torch.no_grad():
        res["serve"] = {name: _serve(case, mesh3 if case["pod"] else mesh2)
                        for name, case in given["serve"].items()}
    if rank == 0:
        tmp = out + ".part"
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, out)
