"""End-to-end training script on the PyTorch port: train a ~30M-param dense
model on the synthetic chat corpus for a few hundred steps with
checkpointing (the port's edition of ``examples/train_small.py``; the
checkpoint file is the JAX package's format, so either package resumes
from it).

    PYTHONPATH=src python examples/train_small_torch.py --steps 300            # on the card
    PYTHONPATH=src python examples/train_small_torch.py --steps 30 --device cpu
    PYTHONPATH=src python examples/train_small_torch.py --arch qwen2-0.5b --device cpu

Any assigned architecture runs via --arch (its reduced variant). As in the
JAX script, --resume restores the params and the step count only: the
optimizer state starts again from zeros (and its step from 0), so the
learning-rate schedule restarts its warmup.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.data import BatchIterator
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.training import (
    OptConfig,
    init_opt_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)


def default_cfg() -> ModelConfig:
    return ModelConfig(
        name="train-30m", arch_type="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
        param_dtype="float32", compute_dtype="float32",
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--arch", default=None, help="assigned arch id (reduced)")
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt.msgpack"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced() if args.arch else default_cfg()
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n/1e6:.1f}M")

    params = init_params(cfg, seed=0, device=device)
    opt = init_opt_state(params)
    start = 0
    if args.resume and os.path.exists(args.ckpt):
        params, start = load_checkpoint(args.ckpt, params)
        print(f"resumed from {args.ckpt} at step {start}")

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg)
    it = BatchIterator(cfg, batch_size=args.batch, seq_len=args.seq)

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        if cfg.n_patches:
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model), dtype=torch.float32, device=device
            )
        params, opt, m = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                  f"({tput:.0f} tok/s)")
    save_checkpoint(args.ckpt, params, step=args.steps)
    print(f"checkpoint saved to {args.ckpt}")


if __name__ == "__main__":
    main()
