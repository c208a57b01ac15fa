"""Zamba2-7B — Mamba2 backbone + weight-shared attention blocks.

81 Mamba2 layers (d_model 3584, ssm_state 64, head_dim 64), with a shared
full transformer block (32 heads MHA kv=32 × d_head 112, d_ff 14336)
invoked every 6 layers (13 invocations + 3 trailing mamba layers). A copy
of ``repro.configs.zamba2_7b``, with its adaptation: Zamba2's
per-invocation LoRA deltas on the shared block are simplified to pure
weight sharing. The port serves it on the dense route only.
[arXiv:2411.15242]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="swiglu",
    layer_pattern="zamba_hybrid",
    shared_attn_period=6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    grad_accum=4,
    source="[arXiv:2411.15242]",
)
