"""Granite 3.0 MoE — fine-grained sparse decoder (3B total / 800M active).

32L, d_model 1536, 24 heads (GQA kv=8, d_head 64), per-expert d_ff 512,
vocab 49155, 40 experts top-8. A copy of
``repro.configs.granite_moe_3b_a800m``; the port serves it on both routes,
at full width on the GPU (~6.6 GB bf16) and in ``reduced()`` form in the
CPU tests. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    mlp_type="swiglu",
    n_experts=40,
    top_k=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
