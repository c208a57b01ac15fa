"""Mamba2-1.3B — attention-free SSD (state-space duality) decoder.

48L, d_model 2048 (d_inner 4096, 64 heads × head_dim 64), ssm_state 128,
vocab 50280, tied embeddings. A copy of ``repro.configs.mamba2_1_3b``; the
port serves it on the dense route only (no session reuse: an SSM's state
cannot be extended in place), at full width on the GPU and in
``reduced()`` form in the CPU tests. [arXiv:2405.21060]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
    source="[arXiv:2405.21060]",
)
