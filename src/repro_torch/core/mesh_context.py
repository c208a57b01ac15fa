"""On-mesh context migration across the ``pod`` axis
(``repro.core.mesh_context``).

The paper replicates *token* context between edge nodes and leaves
"directly manipulating the internal KV cache" as future work (§5). With
the pod axis standing in for edge sites, both levels exist as mesh
programs on a ``DeviceMesh`` with a ``pod`` dim:

- ``migrate_tokens``: the paper's own mechanism, the tokenized session
  context (a (pods, B, L) int32 buffer) moves pod to pod;
- ``migrate_kv_cache``: the model's *internal* state (attention KV caches /
  SSM states) moves pod to pod, so the receiving pod skips re-prefilling
  the context.

``migration_vs_reprefill`` quantifies that trade per architecture: ship
state bytes over the device links vs re-run the prefill's FLOPs, priced
with the card's constants (``launch.mesh``). For SSM archs the state is
O(1) in context length, so migration wins by orders of magnitude.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..launch.mesh import ICI_BW_PER_LINK, PEAK_FLOPS_BF16
from ..models.config import ModelConfig
from ..models.ssm import conv_dim
from ..models.weights import tree_map


# ---------------------------------------------------------------------------
# Mesh programs
# ---------------------------------------------------------------------------

def _migrate_leaf(mesh, x, src_pod: int, dst_pod: int):
    """One DTensor sharded on its leading dim over ``pod``: dst pod's shard
    replaced by src pod's, every other shard unchanged (JAX's ``ppermute``
    [(src, dst)] then ``where(me == dst, moved, x)``). Each rank of src
    sends its block to the rank of dst with the same (data, model)
    coordinates, so the sharding within a pod is untouched."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    pod = mesh.mesh_dim_names.index("pod")
    assert isinstance(x, DTensor) and x.placements[pod] == Shard(0), x
    local = x.to_local()
    me = mesh.get_local_rank(pod)
    if src_pod != dst_pod and me in (src_pod, dst_pod):
        group = mesh.get_group(pod)
        if me == src_pod:
            dist.send(local.contiguous(), dist.get_global_rank(group, dst_pod), group=group)
        else:
            local = torch.empty_like(local)
            dist.recv(local, dist.get_global_rank(group, src_pod), group=group)
    return DTensor.from_local(local, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def migrate_tokens(mesh, token_buffer, src_pod: int, dst_pod: int):
    """Move a (pods, B, L) pod-sharded tokenized-context buffer's src shard
    to dst. Returns the updated buffer (a new DTensor)."""
    return _migrate_leaf(mesh, token_buffer, src_pod, dst_pod)


def migrate_kv_cache(mesh, caches: Any, src_pod: int, dst_pod: int) -> Any:
    """Move every pod-sharded leaf of a cache tree from src to dst pod.
    Leaves carry ``pod`` on their leading dim; their data/model sharding
    within the pod is untouched (the transfer is pure pod-to-pod traffic,
    what the roofline's collective term prices)."""
    return tree_map(lambda leaf: _migrate_leaf(mesh, leaf, src_pod, dst_pod), caches)


@dataclass
class MigrationAnalysis:
    arch: str
    context_len: int
    state_bytes: int
    migrate_s: float        # state_bytes over the device links
    token_bytes: int
    reprefill_flops: float
    reprefill_s: float      # prefill at the receiving pod (compute roofline)
    winner: str

    def to_row(self) -> str:
        return (
            f"{self.arch:22s} ctx={self.context_len:>7d} "
            f"state={self.state_bytes/1e6:9.1f}MB migrate={self.migrate_s*1e3:8.2f}ms "
            f"reprefill={self.reprefill_s*1e3:9.2f}ms -> {self.winner}"
        )


def internal_state_bytes(cfg: ModelConfig, context_len: int, batch: int = 1) -> int:
    """Size of the model's internal decode state for one session."""
    bpe = 2  # bf16
    total = 0
    if cfg.arch_type in ("ssm", "hybrid"):
        nh = cfg.n_ssm_heads
        hd = cfg.d_inner // nh
        n_ssm = cfg.n_layers
        total += n_ssm * batch * nh * hd * cfg.ssm_state * bpe
        total += n_ssm * batch * cfg.ssm_conv * conv_dim(cfg) * bpe
        if cfg.arch_type == "hybrid" and cfg.shared_attn_period:
            n_inv = cfg.n_layers // cfg.shared_attn_period
            total += 2 * n_inv * batch * context_len * cfg.n_kv_heads * cfg.d_head * bpe
    else:
        per_layer_len = context_len
        if cfg.layer_pattern == "local_global":
            # half the layers cache only the window
            w = min(cfg.sliding_window, context_len)
            n_local = cfg.n_layers // 2
            n_global = cfg.n_layers - n_local
            total += 2 * n_local * batch * w * cfg.n_kv_heads * cfg.d_head * bpe
            total += 2 * n_global * batch * context_len * cfg.n_kv_heads * cfg.d_head * bpe
            return total
        if cfg.attn_variant == "sliding_window":
            per_layer_len = min(cfg.sliding_window or 8192, context_len)
        total += 2 * cfg.n_layers * batch * per_layer_len * cfg.n_kv_heads * cfg.d_head * bpe
    return total


def migration_vs_reprefill(
    cfg: ModelConfig, context_len: int, chips_per_pod: int = 256
) -> MigrationAnalysis:
    state = internal_state_bytes(cfg, context_len)
    # pod-to-pod transfer rides one link of each device holding shards;
    # assume the state is spread over the pod's devices
    links = chips_per_pod
    migrate_s = state / (links * ICI_BW_PER_LINK)
    reprefill_flops = 2.0 * cfg.active_param_count() * context_len
    reprefill_s = reprefill_flops / (chips_per_pod * PEAK_FLOPS_BF16)
    token_bytes = context_len * (2 if cfg.vocab_size <= 65536 else 4)
    return MigrationAnalysis(
        arch=cfg.name,
        context_len=context_len,
        state_bytes=state,
        migrate_s=migrate_s,
        token_bytes=token_bytes,
        reprefill_flops=reprefill_flops,
        reprefill_s=reprefill_s,
        winner="migrate-state" if migrate_s < reprefill_s else "reprefill-tokens",
    )
