"""Roofline terms of one step (``repro.roofline.analysis``), priced with
the card's constants (``launch.mesh``: H100 SXM).

Three terms per (arch x shape x mesh), in seconds, per device:

    compute    = FLOPs / 989 TFLOP/s bf16
    memory     = bytes / 3.35 TB/s HBM
    collective = collective_bytes / 25 GB/s (one NVLink 4 link, one way)

``hlo_flops`` is a counted step's FLOPs per device (the port counts them
with ``launch.dryrun``; the field keeps JAX's name), and ``hlo_bytes`` /
``collective_bytes`` its bytes moved and its collectives' bytes.
``collective_bytes_by_type`` sums the collectives one device ran under
JAX's five HLO names: the result bytes of each (JAX's convention: an
upper bound for reduce-scatter, exact for all-gather and permute receive
volume) and a ``<name>_count`` of each. MODEL_FLOPS uses 6·N·D (train) or 2·N·D (forward) with N = total
params (dense) / active params (MoE); the ratio MODEL_FLOPS / FLOPs
exposes remat recompute, attention's quadratic work and dispatch
overhead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from ..launch.mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16
from ..models.config import ModelConfig


_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def collective_bytes_by_type(ops: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """``ops``: (collective name, result bytes) per collective run, as
    ``launch.dryrun._LocalCost`` records them (JAX parses them from the
    partitioned HLO text)."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    counts: Dict[str, int] = {c + "_count": 0 for c in _COLLECTIVES}
    for op, nbytes in ops:
        out[op] += nbytes
        counts[op + "_count"] += 1
    out.update(counts)
    return out


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    peak_memory_bytes: Optional[float] = None

    # the counts are per device, so the terms divide by one device's peak,
    # and the chips divisor appears only in the useful-flops comparison

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / ICI_BW_PER_LINK

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS per device vs counted FLOPs per device — <1 means
        remat recompute, attention quadratic work, or dispatch overhead."""
        if self.hlo_flops <= 0:
            return 0.0
        return (self.model_flops / self.chips) / self.hlo_flops

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS for the workload (active params for MoE)."""
    n = cfg.active_param_count()
    tokens = batch * seq if kind in ("train", "prefill") else batch  # decode: 1 tok
    per_token = 6 * n if kind == "train" else 2 * n
    return float(per_token) * tokens
