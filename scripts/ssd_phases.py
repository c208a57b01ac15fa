#!/usr/bin/env python3
"""Per-phase device cycles of the SSD chunk kernel K6 (``csrc/ssd.cu``).

Builds ``csrc/ssd.cu`` alone, with its ``clock64`` stamps compiled in
(``-DREPRO_SSD_STAMPS``: lane 0 of every warp stamps each phase), into
``build/ssd_phases/``, runs it at Mamba2's and Zamba2's 1024-token shapes
(``chip_smoke._ssd_case`` inputs) and prints, as one JSON line per shape,
the kernel's device time with the stamps and the mean cycles per block of:
the first copies (C, B, the first head's x), the CB phase (waiting for the
cluster, the block's own tiles with their pushes, waiting for the other
blocks' tiles), and per head the f64 cumsum (warp 0), the split of x, the
barrier, the next head's copies (issued by the warps with the lighter
W x), W x and the state product, each as the mean over warps and the mean
of the slowest warp per block; then W x and the state per warp (head 0).
The port's own library is built without the stamps. Needs a CUDA GPU and
nvcc:

    python3 scripts/ssd_phases.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd.kernel import ssd_plan  # noqa: E402

SLOTS, WARPS = 80, 16  # kStampSlots and kWarps of csrc/ssd.cu
HEAD = 3               # head k's stamps: HEAD + 8 k + 0..6
NAMES = ("cumsum (warp 0)", "split x", "barrier", "next head's copies", "W x", "state")


def _mean_max(d):
    return [round(float(np.mean(d))), round(float(np.mean(np.max(d, axis=1))))]


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "ssd_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libssd_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DREPRO_SSD_STAMPS", "-shared", "-I",
                    str(build.CSRC), str(build.CSRC / "ssd.cu"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    build.declare(lib, "repro_ssd_chunk")
    lib.repro_ssd_read_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_power(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, shape in (("mamba2", (1, 1024, 64, 64, 128)), ("zamba2", (1, 1024, 112, 64, 64))):
        x, dt, A, Bv, Cv = cs._ssd_case(gen, *shape, dev)
        Bv, Cv = Bv[:, :, 0].contiguous(), Cv[:, :, 0].contiguous()
        b, l, h, p = x.shape
        n = Bv.shape[-1]
        hg, grid = ssd_plan(b, l // 128, h, build.device_sms(dev))
        assert HEAD + 8 * hg <= 70, hg   # the heads' stamps stay below slot 70
        y, d = torch.empty_like(x), torch.empty_like(dt)
        states = torch.empty(b, l // 128, h, n, p, device=dev)

        def run():
            err = lib.repro_ssd_chunk(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
                y.data_ptr(), states.data_ptr(), d.data_ptr(), b, l, h, p, n, 128, hg,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        ms = cs.device_time_ms([run], iters=10)
        run()
        torch.cuda.synchronize()
        host = np.zeros(1 << 20, dtype=np.int64)
        assert lib.repro_ssd_read_stamps(host.ctypes.data) == 0
        nb = grid[0] * grid[1] * grid[2]   # the grid's first axis as planned (no padding here)
        rel = host[: nb * WARPS * SLOTS].reshape(nb, WARPS, SLOTS)
        rel = rel - rel[:, :, :1]
        res = {"kernel_ms_with_stamps": ms, "heads_per_block": hg, "blocks": nb,
               "copies": _mean_max(rel[:, :, 1]),
               "cb: cluster wait, own tiles and pushes, wait for the others":
                   [_mean_max(rel[:, :, 70] - rel[:, :, 1]), _mean_max(rel[:, :, 71] - rel[:, :, 70]),
                    _mean_max(rel[:, :, 2] - rel[:, :, 71])]}
        heads, prev = [], rel[:, :, 2]
        for k in range(hg):
            cols = [rel[:, :, HEAD + 8 * k + i] for i in range(7)]
            entry = {"wait at the loop's barrier": _mean_max(cols[0] - prev)}
            entry.update({nm: _mean_max(cols[i + 1] - cols[i]) for i, nm in enumerate(NAMES)})
            heads.append(entry)
            prev = cols[6]
        res["per head (mean over warps, mean of the slowest warp)"] = heads
        res["total"] = _mean_max(prev)
        res["head 0 W x per warp"] = [round(float(np.mean(rel[:, w, HEAD + 5] - rel[:, w, HEAD + 4])))
                                      for w in range(WARPS)]
        res["head 0 state per warp"] = [round(float(np.mean(rel[:, w, HEAD + 6] - rel[:, w, HEAD + 5])))
                                        for w in range(WARPS)]
        print(json.dumps({name: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
