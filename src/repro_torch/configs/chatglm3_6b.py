"""ChatGLM3-6B — dense GQA decoder with 2D (half-rotary) RoPE.

28L, d_model 4096, 32 heads (GQA kv=2, d_head 128), d_ff 13696, vocab 65024,
QKV bias, rotary applied to half the head dims (chatglm2d). [arXiv:2406.12793]

A copy of ``repro.configs.chatglm3_6b``; the port serves it on both routes
and the batched server, at full width on the GPU and in ``reduced()`` form
in the CPU tests.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=65024,
    mlp_type="swiglu",
    rope_style="chatglm2d",
    qkv_bias=True,
    source="[arXiv:2406.12793]",
)
