"""Architecture registry of the port (``repro.configs``). ``ASSIGNED``
names the assigned architectures the port serves so far — Mamba2-1.3B and
Zamba2-7B (the dense route), Qwen2-0.5B and the MoE decoders
granite-moe-3b-a800m and dbrx-132b (both routes); ``ALL`` adds the paper's
own model. ``get_config(name)`` accepts hyphen or underscore spellings;
``--arch <id>`` in the launcher resolves through this registry.
"""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from .dbrx_132b import CONFIG as DBRX_132B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from .mamba2_1_3b import CONFIG as MAMBA2_1_3B
from .paper_qwen15_0_5b import CONFIG as PAPER_QWEN15_0_5B
from .qwen2_0_5b import CONFIG as QWEN2_0_5B
from .zamba2_7b import CONFIG as ZAMBA2_7B

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c
    for c in (DBRX_132B, ZAMBA2_7B, GRANITE_MOE_3B_A800M, QWEN2_0_5B, MAMBA2_1_3B)
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
    "ALL", "ASSIGNED", "DBRX_132B", "GRANITE_MOE_3B_A800M", "MAMBA2_1_3B",
    "PAPER_QWEN15_0_5B", "QWEN2_0_5B", "ZAMBA2_7B", "get_config", "list_archs",
]
