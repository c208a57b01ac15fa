"""Architecture registry of the port. It names only the configurations the
port serves so far: the paper's own model (its paged and dense routes),
and Mamba2-1.3B and Zamba2-7B (the dense route)."""

from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from .mamba2_1_3b import CONFIG as MAMBA2_1_3B
from .paper_qwen15_0_5b import CONFIG as PAPER_QWEN15_0_5B
from .zamba2_7b import CONFIG as ZAMBA2_7B

ALL: Dict[str, ModelConfig] = {
    c.name: c for c in (PAPER_QWEN15_0_5B, MAMBA2_1_3B, ZAMBA2_7B)
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-").lower()
    for k, v in ALL.items():
        if k.lower() == key:
            return v
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ALL)}")


__all__ = ["ALL", "MAMBA2_1_3B", "PAPER_QWEN15_0_5B", "ZAMBA2_7B", "get_config"]
