"""Qwen2-0.5B — small dense GQA decoder with QKV bias.

24L, d_model 896, 14 heads (GQA kv=2, d_head 64), d_ff 4864, vocab 151936.
The same model class as the paper's own Qwen chat model — the most
paper-representative assigned architecture. A copy of
``repro.configs.qwen2_0_5b``; the port serves it on both routes, at full
width on the GPU and in ``reduced()`` form in the CPU tests.
[arXiv:2407.10671]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151936,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="[arXiv:2407.10671]",
)
