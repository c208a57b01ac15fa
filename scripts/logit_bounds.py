#!/usr/bin/env python3
"""CPU runs that set ``chip_smoke.py``'s bf16 logit bounds of a model before
its first run on the card: the model at its own head geometry, with the
width of its residual stream, MLP and vocabulary cut to fit the CPU (bf16
weights from a seed), a teacher-forced turn through the kernel path (on CPU
tensors each kernel wrapper runs its plain version) and the plain path, and
max |logit diff| as a multiple of the plain logits' std.

    PYTHONPATH=src python scripts/logit_bounds.py nemotron --seed 0
    PYTHONPATH=src python scripts/logit_bounds.py musicgen --seed 1

nemotron: 96/8 heads x 192 (G * Dh 2304) over d_model 512, d_ff 2048,
vocab 4096, 4 layers (the card's depth), a 1280-token context + 32
teacher-forced tokens on the paged route (``chip_smoke.teacher_forced_
logits``, as the card's check). musicgen: 24 heads x 64 over d_model 512,
d_ff 2048, all 48 layers and 4 codebooks of 2048, a 1024-frame prompt of
the synthetic delay-pattern data + 32 decode steps (the kernel path's
greedy codes, forced into the plain path) on the dense and the paged route,
per codebook (``chip_smoke.musicgen_dense`` / ``musicgen_paged``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=["nemotron", "musicgen"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import MUSICGEN_MEDIUM, NEMOTRON_4_340B
    from repro_torch.models import init_params

    torch.manual_seed(args.seed)
    dev = torch.device("cpu")
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", attn_impl="cuda")
    t0 = time.perf_counter()
    if args.model == "nemotron":
        cfg = NEMOTRON_4_340B.replace(n_layers=cs.NEMOTRON_LAYERS, d_model=512, d_ff=2048,
                                      vocab_size=4096, **bf16)
        params = init_params(cfg, seed=args.seed, device=dev)
        seq = np.random.default_rng(args.seed).integers(300, cfg.vocab_size, size=1312).tolist()
        ids, forced = seq[:1280], seq[1280:]
        kern = cs.teacher_forced_logits(cfg, params, ids, forced, dev)
        plain = cs.teacher_forced_logits(cfg.replace(attn_impl="reference"), params, ids,
                                         forced, dev)
        std = plain.std().item()
        diff = (kern - plain).abs().max().item()
        print(f"nemotron (96/8 x 192, d_model 512, {cfg.n_layers} layers, bf16, seed "
              f"{args.seed}): 1280 + 32 tokens, max |logit diff| kernel path vs plain path "
              f"{diff:.4e} = {diff / std:.4f} x std {std:.4f} ({time.perf_counter() - t0:.1f} s)")
        return
    cfg = MUSICGEN_MEDIUM.replace(d_model=512, d_ff=2048, **bf16)
    params = init_params(cfg, seed=args.seed, device=dev)
    frames = cs.musicgen_frames(cfg, cs.MUSICGEN_PROMPT + cs.MUSICGEN_NEW, seed=args.seed)
    prompt = frames[:, :cs.MUSICGEN_PROMPT]
    for route, fn in (("dense", cs.musicgen_dense), ("paged", cs.musicgen_paged)):
        kern, codes = fn(cfg, params, prompt, cs.MUSICGEN_NEW, dev)
        plain, _ = fn(cfg.replace(attn_impl="reference"), params, prompt, cs.MUSICGEN_NEW, dev,
                      forced=codes)
        rels = []
        for k in range(cfg.n_codebooks):
            std = plain[:, k].std().item()
            rels.append((kern[:, k] - plain[:, k]).abs().max().item() / std)
        print(f"musicgen {route} (24 x 64, d_model 512, {cfg.n_layers} layers, bf16, seed "
              f"{args.seed}): {cs.MUSICGEN_PROMPT} + {cs.MUSICGEN_NEW} frames, max |logit diff| "
              f"kernel path vs plain path per codebook "
              f"{', '.join(f'{r:.4f}' for r in rels)} x std "
              f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
