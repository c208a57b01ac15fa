"""Training launcher — the port's copy of ``repro.launch.train``, with the
same flags and printed lines and one more, ``--device``.

Trains the reduced variant of any assigned architecture (or the paper
model) on the synthetic corpus, on ``--device`` (default ``cuda``; without
a GPU that raises unless ``--device cpu`` is given):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-qwen1.5-0.5b --ckpt out.msgpack

``--dry-run`` runs the full config's train_4k step on the production mesh
of a fake process group instead (``python -m repro_torch.launch.dryrun``,
in a subprocess, as JAX's does: the dry-run owns its process's default
group), on ``--device``'s mesh type, and exits with its code.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="run the FULL config's step on the production mesh (fake group)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.dry_run:
        # the dry-run owns its process's default group
        import os
        import subprocess

        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", args.arch, "--shape", "train_4k"]
        if args.multi_pod:
            cmd.append("--multi-pod")
        cmd += ["--device", device.type]
        raise SystemExit(subprocess.run(cmd, env=os.environ).returncode)

    import torch

    from ..configs import get_config
    from ..data import BatchIterator
    from ..models import init_params
    from ..training import OptConfig, init_opt_state, make_train_step, save_checkpoint

    cfg = get_config(args.arch).reduced()
    print(f"arch={cfg.name} (reduced) params={cfg.param_count()/1e6:.1f}M")
    params = init_params(cfg, seed=0, device=device)
    opt = init_opt_state(params)
    step_fn = make_train_step(
        cfg, OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    )
    it = BatchIterator(cfg, batch_size=args.batch, seq_len=args.seq)
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        if cfg.n_patches:
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.n_patches, cfg.d_model), dtype=torch.float32, device=device)
        params, opt, m = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e}")
    print(f"{args.steps} steps in {time.perf_counter()-t0:.1f}s")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print(f"saved {args.ckpt}")


if __name__ == "__main__":
    main()
