"""Gemma 2 27B — alternating local(4096-window)/global attention, softcaps.

46L (23 local/global pairs), d_model 4608, 32 heads (GQA kv=16, d_head 128),
d_ff 36864 (GeGLU), vocab 256000, attention-logit softcap 50, final-logit
softcap 30. Even layers are sliding-window (4096), odd are global.
long_500k runs natively: local layers use ring caches; global layers decode
against the sequence-sharded 500k cache. [arXiv:2408.00118]

A copy of ``repro.configs.gemma2_27b``; the port serves it on the dense
route (ring caches cannot be appended to, so there is no session pool and
the paged route is not taken) and the full-width batched server, at full
width on the GPU (~54 GB of bf16 weights) and in ``reduced()`` form in the
CPU tests.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab_size=256000,
    mlp_type="geglu",
    layer_pattern="local_global",
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    grad_accum=8,
    source="[arXiv:2408.00118]",
)
