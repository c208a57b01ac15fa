"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

48L, d_model 1536, 24 heads (MHA, kv=24, d_head 64), d_ff 6144, vocab 2048
per codebook, 4 codebooks with delay pattern. The EnCodec conv codec is the
STUB modality frontend: input_specs provides the 4 parallel token streams.
Adaptation: original uses learned sinusoidal positions; we use RoPE.
[arXiv:2306.05284]

A copy of ``repro.configs.musicgen_medium``; the port runs it through its
model functions on (B, S, 4) tokens (the K codebook embeddings summed, one
head of V logits per codebook), at full width on the GPU and in
``reduced()`` form in the CPU tests. As in JAX, neither engine nor batched
server serves it.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    n_codebooks=4,
    frontend="audio_codec",
    source="[arXiv:2306.05284]",
)
