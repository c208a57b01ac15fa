"""Qwen2-VL-7B — vision-language backbone with M-RoPE.

28L, d_model 3584, 28 heads (GQA kv=4, d_head 128), d_ff 18944, vocab
152064, QKV bias, M-RoPE sections (t,h,w)=(16,24,24). The ViT vision encoder
+ projector is the STUB frontend: input_specs provides patch embeddings
(n_patches × d_model) occupying the leading sequence positions; the 3D
position-id streams are real and drive M-RoPE. [arXiv:2409.12191]

A copy of ``repro.configs.qwen2_vl_7b``; the port serves it on both routes
and the batched server (text turns broadcast one position stream to all
three), at full width on the GPU and in ``reduced()`` form in the CPU tests.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    mlp_type="swiglu",
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    qkv_bias=True,
    frontend="vision",
    n_patches=256,
    grad_accum=4,
    source="[arXiv:2409.12191]",
)
