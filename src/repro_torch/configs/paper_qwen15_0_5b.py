"""Qwen1.5-0.5B-Chat — the model the DisCEdge paper itself serves (§A.1).

24L, d_model 1024, 16 heads (MHA), d_ff 2816, vocab 151936. A copy of
``repro.configs.paper_qwen15_0_5b``; the port serves it at full width on
the GPU and in ``reduced()`` form in the CPU tests.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=2816,
    vocab_size=151936,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    source="[paper §4.1 / hf:Qwen/Qwen1.5-0.5B-Chat]",
)
