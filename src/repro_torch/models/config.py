"""Model configuration system — the PyTorch port's own copy of
``repro.models.config`` (field for field, so one config object drives both
packages; the port imports nothing of ``repro``).

One frozen dataclass describes every architecture family in the assigned
pool: dense GQA decoders, MoE, SSM (Mamba2), hybrid (Zamba2), VLM and audio
backbones. ``repro_torch.configs.<arch>`` instantiates the published
configuration; ``reduced()`` derives the CPU smoke variant (≤2 layers,
d_model ≤ 512, ≤4 experts) used by the CPU tests.

In the port, ``attn_impl == "reference"`` selects the plain PyTorch
attention path; any other value selects the hand-written Hopper kernels
(``repro_torch.kernels``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # 0 -> d_model // n_heads

    # --- MLP -------------------------------------------------------------
    mlp_type: str = "swiglu"          # swiglu | relu2 | gelu

    # --- attention ---------------------------------------------------------
    rope_theta: float = 1e4
    rope_style: str = "standard"      # standard | chatglm2d | mrope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w rotary split
    qkv_bias: bool = False
    attn_softcap: float = 0.0         # gemma2: 50.0 on attention logits
    logit_softcap: float = 0.0        # gemma2: 30.0 on final logits
    sliding_window: int = 0           # window size for local attention layers
    layer_pattern: str = "uniform"    # uniform | local_global | zamba_hybrid
    attn_variant: str = "full"        # full | sliding_window (long-context variant)

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0                # 0 -> derived: (expand*d_model)//ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    shared_attn_period: int = 0       # zamba2: shared attn block every k layers

    # --- modality frontends (stubs per brief) ---------------------------------
    frontend: str = "none"            # none | vision | audio_codec
    n_codebooks: int = 0              # musicgen EnCodec streams
    n_patches: int = 0                # VLM patch-embedding count per sample

    # --- numerics / execution ---------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "reference"      # reference (jnp) | pallas
    remat: bool = True
    grad_accum: int = 1               # microbatches per train step
    # Unroll layer stacks instead of lax.scan. Production uses scan (O(1)
    # HLO in depth); the dry-run's *cost* compile unrolls because XLA's
    # cost_analysis counts while-loop bodies once (verified empirically).
    unroll_layers: bool = False
    # Cross-entropy gold-logit extraction: "gather" (take_along_axis — the
    # obvious formulation; GSPMD all-gathers vocab-sharded logits for it) or
    # "onehot" (dot with one-hot labels — stays sharded, psum of a scalar
    # per token). §Perf hillclimb knob.
    ce_impl: str = "gather"
    # MoE dispatch: "gspmd" (einsum/gather formulation, GSPMD chooses the
    # collectives) or "shard_map" (explicit per-shard dispatch + all_to_all
    # over the model/expert axis). §Perf hillclimb knob.
    moe_impl: str = "gspmd"
    source: str = ""                  # citation ([arXiv:...] / [hf:...])

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def group_size(self) -> int:
        """GQA: queries per KV head."""
        return self.n_heads // max(1, self.n_kv_heads)

    def window_for_layer(self, i: int) -> int:
        """Effective attention window for layer i (0 = unbounded)."""
        if self.attn_variant == "sliding_window":
            return self.sliding_window or 8192
        if self.layer_pattern == "local_global":
            return self.sliding_window if i % 2 == 0 else 0  # gemma2: even=local
        return 0

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """CPU smoke variant of the same family: ≤2 layers, d_model ≤ 512,
        ≤4 experts, small vocab. Keeps every structural switch intact."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_model // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            shared_attn_period=2 if self.shared_attn_period else 0,
            n_codebooks=self.n_codebooks,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            mrope_sections=(8, 12, 12) if self.rope_style == "mrope" else self.mrope_sections,
            param_dtype="float32",
            compute_dtype="float32",
            grad_accum=1,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)

    def with_variant(self, attn_variant: str) -> "ModelConfig":
        return replace(self, attn_variant=attn_variant)

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += d * v
        if self.n_codebooks:
            n += (self.n_codebooks - 1) * v * d  # per-codebook embeds + heads
        per_layer = 0
        # attention (dense/moe/vlm/audio and gemma-style)
        if self.arch_type in ("dense", "moe", "vlm", "audio"):
            dh = self.d_head
            per_layer += d * (self.n_heads * dh) + d * (2 * self.n_kv_heads * dh)
            per_layer += (self.n_heads * dh) * d
            per_layer += 2 * d  # norms
            if self.mlp_type in ("swiglu", "geglu"):
                ff = 3 * d * self.d_ff
            else:
                ff = 2 * d * self.d_ff
            if self.n_experts:
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * ff
            else:
                per_layer += ff
            n += self.n_layers * per_layer
        elif self.arch_type in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            g = self.ssm_groups
            m_layer = d * (2 * di + 2 * g * ns + nh)  # in_proj (z,x,B,C,dt)
            m_layer += self.ssm_conv * (di + 2 * g * ns)  # conv
            m_layer += nh * 2 + di  # A_log, D, norm gate
            m_layer += di * d  # out_proj
            m_layer += d  # norm
            n += self.n_layers * m_layer
            if self.shared_attn_period:
                dh = self.d_head
                shared = d * (self.n_heads * dh) + d * (2 * self.n_kv_heads * dh)
                shared += (self.n_heads * dh) * d + 3 * d * self.d_ff + 2 * d
                n += shared  # counted ONCE (weight-shared)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        ff = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * ff
        return full - inactive
