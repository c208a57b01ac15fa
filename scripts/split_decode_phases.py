#!/usr/bin/env python3
"""Per-phase device cycles of the split-walk decode kernels K2
(``csrc/shared_prefix.cu``) and K5 (``csrc/decode_attention.cu``).

Copies the kernel sources to ``build/split_phases/``, inserts ``clock64``
stamps (and ``%globaltimer`` at each block's start and end) into a copy of
each kernel, builds the copy with the port's nvcc flags, and prints, per
shape, the mean per block of: the prologue (q and the first sub-tile's
copies, up to the first barrier), the walk (to the last warp's end), the
warps' merge, and the cluster's merge (which includes waiting for the
slowest block of the cluster), beside the kernel's device time. The
shipped kernels are not touched. Needs a CUDA GPU and nvcc:

    python3 scripts/split_decode_phases.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
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

SLOTS = 32  # stamps per block: 0 start ns, 1 start, 2 prologue end, 3.. warps' walk ends,
            # 11 warps merged, 12 end, 13 end ns
DECL = """
__device__ long long g_stamps[1 << 16];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
READ = """
extern "C" int repro_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, repro_torch::g_stamps, sizeof(long long) * (1 << 16));
}
"""


def _patch(src: str, prologue_end: str, end: str) -> str:
    def rep(s, a, b):
        assert a in s, a
        return s.replace(a, b, 1)

    src = rep(src, "namespace repro_torch {\nnamespace {", "namespace repro_torch {\n" + DECL +
              "namespace {")
    src = rep(src, "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
              "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
              f"  const int pb = {SLOTS} * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
              "blockIdx.z));\n"
              "  if (tid == 0) { g_stamps[pb] = gtime(); g_stamps[pb + 1] = clock64(); }\n")
    src = rep(src, prologue_end, "  if (tid == 0) g_stamps[pb + 2] = clock64();\n" + prologue_end)
    src = rep(src, "  split::block_merge<kMaxPairs>(sm, R, acc);",
              "  if (lane == 0) g_stamps[pb + 3 + warp] = clock64();\n"
              "  split::block_merge<kMaxPairs>(sm, R, acc);\n  __syncthreads();\n"
              "  if (tid == 0) g_stamps[pb + 11] = clock64();")
    src = rep(src, end, end[:-1] +
              "  if (tid == 0) { g_stamps[pb + 12] = clock64(); g_stamps[pb + 13] = gtime(); }\n}")
    return src + READ


def _build(name: str, src: str, prologue_end: str, end: str) -> ctypes.CDLL:
    out = ROOT / "build" / "split_phases"
    out.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    (out / f"{name}.cu").write_text(_patch(src, prologue_end, end))
    lib = out / f"lib{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-shared",
                    str(out / f"{name}.cu"), "-o", str(lib)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _phases(lib, call, prep, n_blocks: int, n_warps: int) -> dict:
    ms = cs.device_time_ms([lambda a=a: call(a) for a in prep])
    for a in prep[1:]:       # the traced call finds its inputs cold, as in the timing
        call(a)
    call(prep[0])
    torch.cuda.synchronize()
    buf = np.zeros(1 << 16, dtype=np.int64)
    lib.repro_read_stamps.argtypes = [ctypes.c_void_p]
    assert lib.repro_read_stamps(buf.ctypes.data) == 0
    p = buf[: n_blocks * SLOTS].reshape(n_blocks, SLOTS)
    walked = p[:, 3:3 + n_warps].max(1)
    return {"ms": ms, "blocks": n_blocks,
            "start_skew_ns": int(p[:, 0].max() - p[:, 0].min()),
            "prologue_cyc": float(np.mean(p[:, 2] - p[:, 1])),
            "walk_cyc": float(np.mean(walked - p[:, 2])),
            "walk_cyc_max": int((walked - p[:, 2]).max()),
            "warp_merge_cyc": float(np.mean(p[:, 11] - walked)),
            "cluster_merge_cyc": float(np.mean(p[:, 12] - p[:, 11]))}


def k2_phases(dev, gen) -> None:
    from repro_torch.kernels.paged_attention.kernel import shared_prefix_plan

    lib = _build("shared_prefix", (build.CSRC / "shared_prefix.cu").read_text(),
                 "  // only the tokens some row attends", "        l_o[o] = l;\n      });\n}")
    build.declare(lib, "repro_shared_prefix")
    sfx = (24, 31, 38, 45, 52, 59, 66, 72)   # the batched server's lanes past a 64-page run
    for B in (1, 8):
        sets = [cs._shared_case(gen, 64, sfx[:B], 16, 16, 64, torch.bfloat16, dev)
                for _ in range(24)]
        prep = [(q.reshape(B, 16, 1, 64).contiguous(), pk, pv, sp, qp.reshape(B).contiguous(),
                 torch.empty(B, 16, 1, 64, device=dev), torch.empty(B, 16, 1, 1, device=dev),
                 torch.empty(B, 16, 1, 1, device=dev))
                for (q, pk, pv, _, qp, _), sp in sets]
        lanes, splits, grid = shared_prefix_plan(B, 16, 1, 64, 1024)

        def call(a):
            assert lib.repro_shared_prefix(
                *(t.data_ptr() for t in a), B, 16, 1, 64, a[1].shape[0], cs.PS, 64, lanes,
                splits, 0, 0.0, 0.125, 1, torch.cuda.current_stream().cuda_stream) == 0

        res = _phases(lib, call, prep, grid[0] * grid[1] * grid[2], 4)
        print(f"K2 B={B} over a 1024-token run, splits {splits}: {json.dumps(res)}", flush=True)


def k5_phases(dev, gen) -> None:
    from repro_torch.kernels.decode_attention.kernel import decode_plan

    lib = _build("decode_attention", (build.CSRC / "decode_attention.cu").read_text(),
                 "  for (int base = first; base < hi; base += kThreads) {",
                 "      [](int, float, float) {});\n}")
    build.declare(lib, "repro_decode_attention")
    for B, H, Dh in ((1, 16, 64), (8, 16, 64), (1, 32, 112)):
        sets = [cs._linear_case(gen, (1249,) * B, (1,) * B, 1, 2048, H, H, Dh, torch.bfloat16,
                                dev) for _ in range(24)]
        prep = [(q.reshape(B, H, 1, Dh).contiguous(), k, v, qp.reshape(B).contiguous(), kp,
                 va.to(torch.int32), torch.empty(B, H, 1, Dh, dtype=torch.bfloat16, device=dev))
                for q, k, v, qp, kp, va in sets]
        splits, grid = decode_plan(B, H, 2048)

        def call(a):
            assert lib.repro_decode_attention(
                *(t.data_ptr() for t in a), B, 2048, H, 1, Dh, splits, 0, 0.0, Dh ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream) == 0

        res = _phases(lib, call, prep, grid[0] * grid[1] * grid[2], 8)
        print(f"K5 B={B} MHA {H} x {Dh}, 1250 of 2048 slots, splits {splits}: "
              f"{json.dumps(res)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("split_decode_phases: no CUDA device", file=sys.stderr)
        return 1
    print(cs.gpu_name_and_power(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k2_phases(dev, gen)
    k5_phases(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
