"""Architecture registry of the port. It names only the configurations the
port serves so far: the paper's own model (the paged dense route)."""

from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from .paper_qwen15_0_5b import CONFIG as PAPER_QWEN15_0_5B

ALL: Dict[str, ModelConfig] = {PAPER_QWEN15_0_5B.name: PAPER_QWEN15_0_5B}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-").lower()
    for k, v in ALL.items():
        if k.lower() == key:
            return v
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ALL)}")


__all__ = ["ALL", "PAPER_QWEN15_0_5B", "get_config"]
