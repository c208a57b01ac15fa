"""Architecture registry of the port (``repro.configs``). ``ASSIGNED``
names JAX's ten assigned architectures — Mamba2-1.3B, Zamba2-7B and
Gemma2-27B (the dense route), Qwen2-0.5B, ChatGLM3-6B, Qwen2-VL-7B,
Nemotron-4-340B and the MoE decoders granite-moe-3b-a800m and dbrx-132b
(both routes), and MusicGen-medium (its model functions only, as in JAX);
``ALL`` adds the paper's own model. ``get_config(name)`` accepts hyphen or underscore spellings;
``--arch <id>`` in the launcher resolves through this registry.
"""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from .chatglm3_6b import CONFIG as CHATGLM3_6B
from .dbrx_132b import CONFIG as DBRX_132B
from .gemma2_27b import CONFIG as GEMMA2_27B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from .mamba2_1_3b import CONFIG as MAMBA2_1_3B
from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from .paper_qwen15_0_5b import CONFIG as PAPER_QWEN15_0_5B
from .qwen2_0_5b import CONFIG as QWEN2_0_5B
from .qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from .zamba2_7b import CONFIG as ZAMBA2_7B

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c
    for c in (DBRX_132B, MUSICGEN_MEDIUM, QWEN2_VL_7B, GEMMA2_27B, ZAMBA2_7B,
              GRANITE_MOE_3B_A800M, QWEN2_0_5B, NEMOTRON_4_340B, MAMBA2_1_3B, CHATGLM3_6B)
}

ALL: Dict[str, ModelConfig] = {**ASSIGNED, PAPER_QWEN15_0_5B.name: PAPER_QWEN15_0_5B}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-").lower()
    for k, v in ALL.items():
        if k.lower() == key:
            return v
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ALL)}")


def list_archs() -> List[str]:
    return sorted(ASSIGNED)


__all__ = [
    "ALL", "ASSIGNED", "CHATGLM3_6B", "DBRX_132B", "GEMMA2_27B", "GRANITE_MOE_3B_A800M",
    "MAMBA2_1_3B", "MUSICGEN_MEDIUM", "NEMOTRON_4_340B", "PAPER_QWEN15_0_5B", "QWEN2_0_5B",
    "QWEN2_VL_7B", "ZAMBA2_7B", "get_config", "list_archs",
]
