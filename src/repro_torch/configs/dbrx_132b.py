"""DBRX-Base — 132B-total / 36B-active fine-grained MoE decoder.

40L, d_model 6144, 48 heads (GQA kv=8, d_head 128), per-expert d_ff 10752,
vocab 100352, 16 experts top-4. A copy of ``repro.configs.dbrx_132b``;
its ~264 GB of bf16 weights fit no single card, so the port serves only its
``reduced()`` form. [hf:databricks/dbrx-base]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    mlp_type="swiglu",
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
    grad_accum=8,
    source="[hf:databricks/dbrx-base]",
)
