"""Nemotron-4-340B — largest assigned config; squared-ReLU MLP.

96L, d_model 18432, 96 heads (GQA kv=8, d_head 192), d_ff 73728 (ReLU²),
vocab 256000. Sharding/memory stress test: trains only with grad
accumulation + full remat + ZeRO-1 optimizer sharding. [arXiv:2402.16819]

A copy of ``repro.configs.nemotron_4_340b``; the port serves it on both
routes and the batched servers. Its ~680 GB of bf16 weights do not fit one
card: on the GPU it runs at every published width with its depth cut
(``replace(n_layers=...)``), and in ``reduced()`` form in the CPU tests.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
    grad_accum=8,  # micro-batch 32 = one sample per chip on the 2x16x16 mesh
    source="[arXiv:2402.16819]",
)
