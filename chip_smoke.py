#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repo root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints on its own lines; any failure raises and exits
non-zero):

1. device   — requires CUDA, prints the card's name and power limit, turns
               TF32 off for f32 matmuls and convolutions;
2. build    — compiles the CUDA kernels from ``src/repro_torch/csrc`` with
               nvcc (sm_90a) into ``build/kernels/``; prints build seconds
               and each kernel's register/shared-memory report (the split
               kernels K1, K2 and K5 by name: registers and spills), and
               reads the machine code: the bf16 K3/K4 kernels and every K6
               instantiation must issue HMMA (tensor-core; K6 TF32)
               instructions, the f32 K3/K4 ones none;
3. K1       — paged decode attention kernel (the split walk) vs its plain
               PyTorch version (bf16, ps 16, MHA and GQA with window x
               softcap, ragged lanes incl. an empty one; then every forced
               split count 1/2/4/8 at ps 8/16/64 on ragged lanes, window x
               softcap and the cascade's continuation, each run twice for
               identical bits), printing each split plan; then timed at
               the main path's B = 1 and the batched server's B = 8 single
               pass against SDPA on the gathered view;
4. K3       — chunked paged prefill kernel (bf16: the tensor-core kernel)
               vs its plain version (S = 256, p0 at 0 and mid-page, ragged
               true_len; then the tensor-core edges: S 1/15/17/150/333, p0
               inside a key tile, ps 8/16/64, MHA/GQA/MQA, d_head 16-128,
               window x softcap, windows that mask whole key tiles), then
               timed;
5. K4       — flash attention kernel vs its plain version in bf16 (tensor
               cores) and in f32 (FMA units, TF32 off): full prefills with
               ragged true_len and appends whose p0 is no multiple of the
               key tile, MHA/GQA/MQA, d_head 64, 112 (Zamba2) and 128, window
               x softcap; the bf16 edges as K3's; then timed at the dense
               route's shapes (a full prefill S = T = 1024; a 256-token
               append at p0 1024 against 2048 slots) and Zamba2's
               (S = T = 1024, 32 x 112);
6. K5       — flash decode kernel vs its plain version the same way at
               B = 1 and B = 8 against 2048 slots (ragged valid lengths),
               printing each shape's split plan (splits, grid, cluster);
               then timed at B = 1 and B = 8 over 1250 valid slots and at
               Zamba2's B = 1 (MHA 32 x 112), each shape run twice on the
               same inputs for identical outputs; B = 1 must split;
   gqa      — K1, K2 (with K1's continuation), K3, K4 and K5 vs their
               plain versions at the GQA groups of granite-moe (24/8 x 64,
               G = 3) and qwen2 (14/2 x 64, G = 7), bf16 and f32: ragged
               page bounds, planned and forced splits, queries inside and
               past a shared run, chunks whose S·G is no multiple of K3's
               64-row tile, p0 inside a key tile, window x softcap; then
               each timed at its model's serving shape beside SDPA (K/V
               expanded per query head) and its bound;
7. main     — TorchLLMService at the full width of the paper's
               Qwen1.5-0.5B (random weights from a seed) serves 3 sessions
               x 3 turns of tokenized context on the paged route; turns 2-3
               must be session hits that prefill only the suffix, both
               kernels must have launched; then one turn is teacher-forced
               through the kernel path and the plain path (same weights)
               and the per-step logits must agree;
8. profile  — host-clock and torch.profiler times of 8 decode steps and
               one 256-token prefill chunk (device busy and idle share,
               top kernels), after the counted run; the chunk's trace must
               show the tensor-core K3 (chunked_prefill_mma) 24 times and
               no f32 FMA kernel (*_simt);
9. dense    — the dense route on the same weights: a page_size=0 service
               serves the same 3 sessions x 3 turns (turns 2-3 suffix-only
               hits), a kv_reuse=False service serves the same turns
               prefilling each whole, a paged service too small for one
               session falls back to the dense route once
               (paged_fallbacks), and the full-width BatchedLLMService (8
               slots) serves a wave of 16 tenants and 8 second turns
               (session hits); K4 and K5 must launch on every path; one
               turn is teacher-forced through the kernel and plain paths;
               a dense decode step and a 256-token append are profiled (the
               append's trace: flash_attention_mma 24 times, no *_simt; the
               decode step's: decode_attention_split 24 times);
10. K2      — the shared-prefix kernel vs its plain version on (acc, m, l)
               at the batched server's shapes (B = 8 lanes, 64-page run,
               queries inside and past the run) and a GQA shape with
               window x softcap, printing each split plan; the cascade (K2,
               then K1 in continuation mode) vs the plain single pass; then
               at the batched shape (which must split; two runs identical)
               K2, K1's continuation and the single-pass K1 timed, and the
               cascade held against the single pass (or both printed with
               the reason when it is slower);
11. batched — BatchedLLMService at full paper width, 8 slots, paged: 16
               tenants sharing a 1024-token system prompt arrive as one
               wave, then 8 of them take a second turn; K1, K2 and K3 must
               all launch, the prompt must be shared (>= 15 shared hits,
               fewer physical pages than without sharing) and every second
               turn must be a suffix-only session hit; prints tokens/s, ms
               per B = 8 decode step, ttft and pages, and profiles 4
               decode steps (K2's shared_prefix_split once per layer);
12. batched_equivalence — one cascade decode step on clones of the server's
               pools and kv_pos: logits with the cascade vs the single-pass
               kernels vs the plain path;
13. migration — export a session's pages from one TorchLLMService,
               install them into a second (bit-exact round trip, next turn
               a "pages" warm start prefilling only its suffix), and prime
               a third from token ids (a "tokens" warm start);
14. K6      — the SSD chunk kernel vs its plain version (f32, all three
               outputs, two runs identical) at Mamba2's (H 64, N 128) and
               Zamba2's (H 112, N 64) full-width 1024-token shapes and a
               B = 2 ragged case, the wrapper (kernel + inter-chunk chain)
               vs the plain chunked SSD; then timed at both shapes;
15. mamba2-1.3b — the full-width Mamba2 (random bf16 weights from a seed)
               through TorchLLMService with bucket 128: 3 sessions x 2
               turns of 256-1024 context tokens, every turn a full prefill
               (no session reuse for SSMs); K6 must launch 48 times per
               prefill; a 1024-token turn teacher-forced through the kernel
               and plain paths; prefill + 8 decode steps vs forward_full; a
               profiled prefill and decode step;
16. zamba2-7b — the same for the full-width Zamba2 hybrid: K6 81 times and
               K4 13 times per prefill (the profiled prefill: the
               tensor-core K4), K5 13 times per decode step;
    ssm f32 — both SSM models in f32 (weights from the seed in f32, TF32
               off; Mamba2 at its 48 layers, Zamba2 cut to its first 25):
               a teacher-forced 1024 + 16-token turn through the kernel and
               plain paths within SSM_F32_REL x the plain logits' std;
17. discedge — the port's DisCEdge system (Context Manager, replicated
               token store, edge nodes, roaming client; ``repro_torch.
               {core,store,edge}``) serves the paper's 9-turn scenario
               (switches at turns 3/5/7, 16 new tokens, 1500 ms think
               time) on two nodes m2 and tx2, each its own TorchLLMService
               over one copy of the full-width paper model's bf16 weights:
               TOKENIZED, RAW and CLIENT_SIDE on the paged route (K3 + K1),
               TOKENIZED with ``kv_reuse=False`` (K4 + K5), and TOKENIZED
               with KV pages shipped m2 -> tx2; every turn answers, the
               route's kernels launch on every turn, the replicas converge,
               the reuse runs hit on every turn after the first with a warm
               start on turn 3 ("tokens" / "pages"); prints per-run
               response times, sync and request bytes and the paper's two
               comparisons (``{"discedge_path": ...}``);
18. qwen2-0.5b — the full-width Qwen2-0.5B (random bf16 weights, GQA
               14/2): 2 sessions x 2 turns on the paged route (K3 + K1) and
               on the dense route (K4 + K5) with exact launch counts, and a
               teacher-forced turn through the kernel and plain paths
               within QWEN2_LOGIT_TOL;
19. granite-moe-3b-a800m — the full-width MoE decoder (32 layers, 40
               experts top-8, GQA 24/8; ~6.7 GB of bf16 weights, nothing
               cut): 3 sessions x 2 turns on the paged route with exact
               launch counts, a teacher-forced turn in bf16 (routing flips
               of free routing counted; bounded with the kernel path routed
               as the plain path), a profiled decode step, a batched wave of
               8 tenants sharing a system prompt (K1, K2, K3), and the same
               teacher-forced check in f32 over the first 4 layers;
20. fleet   — four nodes of the full-width paper model, each an
               AdaptiveLLMService over a paged TorchLLMService and a paged
               BatchedLLMService, residency routing and admission control
               (``EdgeCluster.build(router=..., admission_limit=...)``),
               driven by ``run_fleet`` with a crash and a restart: no hung
               ticket, flips both ways, turns on both mounts, K1, K2 and K3
               launched (counted per mount), batched turns equal to a fresh
               single-stream service's tokens (``{"fleet_path": ...}``);
21. result  — JSON lines with every kernel's numbers (K1-K6), the card's
               name and power limit, and last ``{"ok": true, "device":
               {...}}``.

Imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
PS = 16                        # page size of the main path
K1_TOL = 2e-2   # bf16 output: f32 sums taken in another order, then rounded
                # to bf16 (one bf16 ulp is 7.8e-3 on [1, 2), 1.6e-2 on [2, 4))
K3_TOL = 2e-2
LOGIT_TOL = 0.15  # per-step logits, kernel vs plain path, 24 bf16 layers
K2_STATS_TOL = 1e-3  # K2's f32 stats vs the plain f32 version of the same
                     # bf16 inputs: m (a logit) and acc / l (an attention
                     # output) in absolute terms, l relative; only the
                     # order of f32 sums differs
# batched_equivalence bounds on one decode step's logits (24 bf16 layers):
CASCADE_TOL = 0.15   # cascade vs single pass: the same kernels, but the f32
                     # softmax over the run is summed as two merged partial
                     # states; a bf16 rounding flip at one layer's output
                     # then propagates through the rest, as kernel vs plain
PLAIN_TOL = 0.15     # cascade vs the plain path: LOGIT_TOL, the bound for
                     # kernel vs plain logits over 24 layers
K45_TOL = 2e-2       # K4/K5 in bf16: as K1_TOL
K45_F32_TOL = 1e-4   # K4/K5 in f32 (TF32 off): the same f32 products summed
                     # in another order over up to 2048 keys
K6_TOL = 1e-4        # K6 in f32 (TF32 off): |kernel - plain| <= 1e-4 (1 + |plain|),
                     # JAX's own SSD tolerance; sums over <= 128 rows or state
                     # columns taken in another order
SSM_LOGIT_REL = 0.6  # per-step logits of Mamba2 (48) / Zamba2 (81 + 13) bf16
                     # layers, kernel vs plain path and prefill + decode vs
                     # forward_full: max |diff| <= 0.6 x the std of the plain
                     # logits. Set before the first run on the card: CPU runs of
                     # both models at d_model 512 in bf16 gave 0.12-0.33 x std
                     # (bf16 residuals and a bf16-stored SSM state; PERF.md)
SSM_F32_REL = 1e-3   # f32 teacher-forced logits of the SSM models (f32 weights, TF32
                     # off), kernel vs plain path: max |diff| <= 1e-3 x the std of
                     # the plain logits. Set before the first run on the card: CPU
                     # runs in f32 (Mamba2 4 layers, Zamba2 7, 512 tokens, full
                     # width) gave 1.2e-5 and 1.8e-5 x std, the kernel path's f64
                     # SSD cumsum against the plain path's f32 one; one-pass TF32
                     # products in K6 (relative error ~1e-3 in y) would not fit
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 tensor-core peak (f32 operands)
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_ms(fns, iters: int = 48) -> float:
    """Mean device time of one call, cycling through ``fns`` (one per
    layer's inputs, so the working set exceeds the 50 MB L2 like a real
    step). A sleep kernel queued first lets the host enqueue every launch
    before the timed window opens, so host overhead is not timed."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))    # ~0.1 s of device time
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# K1: paged decode attention
# ---------------------------------------------------------------------------

def _paged_case(gen, lens, H, KV, Dh, dtype, dev, mp=None, ps=PS):
    import torch

    B = len(lens)
    pages_of = lambda n: max(1, -(-n // ps))
    mp = mp or max(pages_of(n) for n in lens)
    n_pages = 1 + sum(pages_of(n) for n in lens)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    table = torch.zeros(B, mp, dtype=torch.int32)
    kv_pos = torch.full((B, mp * ps), -1, dtype=torch.int32)
    used = 1
    for bi, n in enumerate(lens):
        for pj in range(pages_of(n)):
            table[bi, pj] = used
            used += 1
        kv_pos[bi, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32)
    return q, pk, pv, table.to(dev), q_pos.to(dev), kv_pos.to(dev)


def _k1_plan_str(B, KV, mp, ps, start=0) -> str:
    from repro_torch.kernels.paged_attention.kernel import paged_plan

    splits, grid = paged_plan(B, KV, mp, ps, start)
    return (f"B={B} KV={KV} MP={mp} ps={ps} start={start} -> splits {splits}, grid {grid} = "
            f"{grid[0] * grid[1] * grid[2]} blocks, cluster ({splits}, 1, 1)")


class _forced_splits:
    """Within the block, the split planners of K1 and K2
    (``kernels/paged_attention/kernel.py``) choose ``splits``."""

    def __init__(self, splits):
        self.splits = splits

    def __enter__(self):
        from repro_torch.kernels.paged_attention import kernel

        self.saved = kernel.plan_splits
        kernel.plan_splits = lambda blocks, n_tokens: self.splits

    def __exit__(self, *exc):
        from repro_torch.kernels.paged_attention import kernel

        kernel.plan_splits = self.saved


def _k1_check(name, out, again, want, tol=K1_TOL) -> float:
    """A kernel's output against its plain version: finite, two runs
    identical, max |diff| <= ``tol``."""
    import torch

    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), name
    assert torch.equal(out, again), f"K1 {name}: two runs differ"
    e = (out.float() - want.float()).abs().max().item()
    assert e <= tol, f"K1 {name}: {e} > {tol}"
    return e


def phase_k1(dev, n_layers: int) -> dict:
    import torch
    from repro_torch.kernels.paged_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    cases = [
        ("mha ragged", (0, 1, 17, 255, 600, 1024, 1500, 2048), 16, 16, 64, 0, 0.0),
        ("gqa window x softcap", (0, 5, 16, 333, 1024, 2048), 16, 4, 64, 64, 30.0),
    ]
    for name, lens, H, KV, Dh, window, cap in cases:
        args = _paged_case(gen, lens, H, KV, Dh, torch.bfloat16, dev)
        out = ops.paged_attention(*args, window=window, softcap=cap)
        want = ref.paged_attention_ref(*args, window=window, softcap=cap)
        torch.cuda.synchronize()
        e = (out.float() - want.float()).abs().max().item()
        assert torch.isfinite(out.float()).all(), name
        assert (out[0] == 0).all(), f"K1 {name}: empty lane not exact zeros"
        log(f"K1 {name}: {_k1_plan_str(len(lens), KV, args[3].shape[1], PS)}; max_abs_err "
            f"{e:.3e} (bound {K1_TOL})")
        assert e <= K1_TOL, f"K1 {name}: {e} > {K1_TOL}"
        err = max(err, e)

    # the split walk's edges: every split count at page sizes 8, 16 and 64,
    # on ragged lanes with an empty one (window x softcap too) and in the
    # cascade's continuation (queries inside the 256-token run: bound <=
    # start, the seed alone; at its end; past it), each run twice
    edge_errs = {}
    for ps in (8, 16, 64):
        lens = (0, 1, 2 * ps + 3, 300, 777, 1024)
        ragged = _paged_case(gen, lens, 16, 4, 64, torch.bfloat16, dev, ps=ps)
        mha = _paged_case(gen, lens, 16, 16, 64, torch.bfloat16, dev, ps=ps)
        cont, sp = _shared_case(gen, 256 // ps, (-100, -1, 1, 21, 300), 16, 16, 64,
                                torch.bfloat16, dev, ps=ps)
        for splits in (1, 2, 4, 8):
            with _forced_splits(splits):
                for label, args, window, cap in (("ragged", ragged, 0, 0.0),
                                                 ("window x softcap", ragged, 200, 30.0),
                                                 ("mha ragged", mha, 0, 0.0)):
                    run = lambda: ops.paged_attention(*args, window=window, softcap=cap)  # noqa: E731
                    e = _k1_check(f"{label} ps {ps} splits {splits}", run(), run(),
                                  ref.paged_attention_ref(*args, window=window, softcap=cap))
                    edge_errs[f"{label} ps {ps} splits {splits}"] = e
                run = lambda: ops.paged_attention(*cont, sp)  # noqa: E731
                e = _k1_check(f"continuation ps {ps} splits {splits}", run(), run(),
                              ref.paged_attention_ref(*cont))
                edge_errs[f"continuation ps {ps} splits {splits}"] = e
    err = max(err, max(edge_errs.values()))
    log(f"K1 split edges (forced splits 1/2/4/8 x ps 8/16/64 x ragged GQA 16/4 and MHA 16/16, "
        f"window x softcap, continuation; two runs identical): max_abs_err {max(edge_errs.values()):.3e} "
        f"(bound {K1_TOL})")

    out = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/kernel.py:310", "max_abs_err": err}
    # the main path's shapes, MHA 16 x 64, one input set per layer: B = 1
    # over a 1024-token lane (the engine), and B = 8 over 1048-1096 tokens
    # each (the batched server's lanes, taken by the single pass)
    for shape, lens in (("B=1", (1024,)), ("B=8", SERVER_LANES)):
        stats, e = _k1_timed(dev, gen, shape, lens, 16, 16, 64, n_layers)
        out["max_abs_err"] = max(out["max_abs_err"], e)
        out.update(stats if len(lens) == 1 else {f"b8_{k}": v for k, v in stats.items()})
    return out


# the batched server's lanes at its B = 8 decode step: 1048-1096 tokens
SERVER_LANES = tuple(1024 + s for s in (24, 31, 38, 45, 52, 59, 66, 72))


def _expand_kv(t, g):
    """(B, KV, T, Dh) -> (B, KV * g, T, Dh): K/V per query head, for SDPA's
    yardstick at GQA shapes (expanded outside the timed region)."""
    return t if g == 1 else t.repeat_interleave(g, dim=1).contiguous()


def _k1_timed(dev, gen, shape, lens, H, KV, Dh, n_layers) -> tuple:
    """K1 at one serving shape (bf16, ps 16, one input set per layer): the
    launch the path makes (planned splits) held to the plain version on the
    same inputs, twice for identical bits, then timed beside the plain
    version and SDPA on the gathered view. Returns (stats, max_abs_err)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda, paged_plan

    B, G = len(lens), H // KV
    sets = [_paged_case(gen, lens, H, KV, Dh, torch.bfloat16, dev) for _ in range(n_layers)]
    mp = sets[0][3].shape[1]
    splits, grid = paged_plan(B, KV, mp, PS)
    log(f"K1 {shape}: {_k1_plan_str(B, KV, mp, PS)}")
    if B == 1:
        assert splits > 1, "K1 must split the walk across a cluster at B = 1"
    prepared = []
    for q, pk, pv, table, q_pos, kv_pos in sets:
        qp = q_pos.reshape(B)
        bound = torch.clamp((qp + PS) // PS, 1, table.shape[1]).to(torch.int32)
        prepared.append((q.reshape(B, KV, G, Dh).contiguous(), pk, pv, table, bound,
                         qp.contiguous(), kv_pos))
    first, again = (paged_attention_cuda(*prepared[0]) for _ in range(2))
    e = _k1_check(f"{shape} main path ({splits} splits)", first.reshape(B, 1, H, Dh),
                  again.reshape(B, 1, H, Dh), ref.paged_attention_ref(*sets[0]))
    kernel_ms = device_time_ms([lambda a=a: paged_attention_cuda(*a) for a in prepared])
    plain_ms = device_time_ms([lambda s=s: ref.paged_attention_ref(*s) for s in sets])
    lib_args = []
    for q, pk, pv, table, q_pos, kv_pos in sets:
        k = pk[table.long()].reshape(B, -1, KV, Dh).transpose(1, 2)
        v = pv[table.long()].reshape(B, -1, KV, Dh).transpose(1, 2)
        mask = ((kv_pos >= 0) & (kv_pos <= q_pos))[:, None, None, :]
        lib_args.append((q.transpose(1, 2).contiguous(), _expand_kv(k.contiguous(), G),
                         _expand_kv(v.contiguous(), G), mask))
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
         for a in lib_args])
    visited = sum(lens)                                   # bound * ps per lane
    nbytes = (2 * visited * KV * Dh * 2 + 2 * B * H * Dh * 2
              + 4 * (visited + sum(-(-n // PS) for n in lens) + 2 * B))
    bound_ms, bound_by = _bound(nbytes, 4 * H * Dh * visited)
    log(f"K1 {shape} (tokens {min(lens)}-{max(lens)}, {H}/{KV} x {Dh}): kernel_ms "
        f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} (SDPA on the "
        f"gathered view) bound_ms {bound_ms:.6f} ({bound_by}); max_abs_err {e:.3e} (bound "
        f"{K1_TOL}); two runs identical; "
        f"{'below' if kernel_ms < library_ms else 'NOT below'} SDPA")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, splits=splits, grid=grid), e


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K3: chunked paged prefill attention
# ---------------------------------------------------------------------------

def _chunk_case(gen, p0s, lens, S, H, KV, Dh, mp, dtype, dev, ps=PS):
    import torch

    B = len(p0s)
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(1 + B * mp, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(1 + B * mp, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    table = (1 + torch.arange(B * mp, dtype=torch.int32, device=dev)).reshape(B, mp)
    return (q, pk, pv, table, torch.tensor(p0s, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _check_chunk(name, ops, ref, args, lens, window, cap, tol=K3_TOL) -> float:
    """K3 vs its plain version over the rows that are read (bf16, or f32
    with ``tol``)."""
    import torch

    out = ops.chunked_prefill_attention(*args, window=window, softcap=cap)
    want = ref.chunked_prefill_ref(*args, window=window, softcap=cap)
    torch.cuda.synchronize()
    e = max((out[b, :n].float() - want[b, :n].float()).abs().max().item()
            for b, n in enumerate(lens))
    assert all(torch.isfinite(out[b, :n].float()).all() for b, n in enumerate(lens)), name
    log(f"K3 {name}: max_abs_err {e:.3e} over read rows (bound {tol})")
    assert e <= tol, f"K3 {name}: {e} > {tol}"
    return e


def phase_k3(dev, n_layers: int) -> dict:
    import torch
    from repro_torch.kernels.chunked_prefill import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    S, err = 256, 0.0
    cases = [
        ("mha p0 0 / mid-page", (0, 520, 1031), (256, 173, 1), 16, 16, 64, 0, 0.0),
        ("gqa window x softcap", (8, 700), (200, 256), 16, 4, 64, 100, 30.0),
    ]
    for name, p0s, lens, H, KV, Dh, window, cap in cases:
        args = _chunk_case(gen, p0s, lens, S, H, KV, Dh, 128, torch.bfloat16, dev)
        err = max(err, _check_chunk(name, ops, ref, args, lens, window, cap))
    # the tensor-core kernel's edges, bf16: chunks that leave ragged 16- and
    # 64-row tiles, p0 inside a key tile and inside a page, page sizes 8/16/64,
    # MHA/GQA/MQA at every head dim, window x softcap, and a window of 20 that
    # masks whole key tiles for some rows of a block
    edges = [
        ("S 1, ps 8, mqa d128", 1, 8, 8, 1, 128, 0, 0.0),
        ("S 15, ps 16, gqa d32 window 37 x softcap", 15, 16, 8, 2, 32, 37, 30.0),
        ("S 17, ps 64, mha d16 softcap", 17, 64, 4, 4, 16, 0, 30.0),
        ("S 150, ps 16, mha d64 window 20", 150, 16, 16, 16, 64, 20, 0.0),
        ("S 333, ps 8, gqa G=4 d64 window 100 x softcap", 333, 8, 16, 4, 64, 100, 30.0),
        ("S 333, ps 64, mqa d128 window 20", 333, 64, 8, 1, 128, 20, 0.0),
    ]
    for name, S_e, ps, H, KV, Dh, window, cap in edges:
        p0s, lens = (0, 5, 77, 130), (S_e, max(S_e - 3, 1), 1, S_e)
        mp = -(-(max(p0s) + S_e) // ps) + 1
        args = _chunk_case(gen, p0s, lens, S_e, H, KV, Dh, mp, torch.bfloat16, dev, ps=ps)
        err = max(err, _check_chunk(f"edges {name}", ops, ref, args, lens, window, cap))

    return dict({"name": "chunked_prefill", "route": "cuda",
                 "source": "src/repro_torch/csrc/chunked_prefill.cu",
                 "replaces": "src/repro/kernels/chunked_prefill/kernel.py:154",
                 "max_abs_err": err}, **_k3_timed(dev, gen, 16, 16, 64, n_layers))


def _k3_timed(dev, gen, H, KV, Dh, n_layers) -> dict:
    """K3 at the main path's chunk shape: B = 1, a 256-token chunk at p0 =
    768 (1024-token prefix), one input set per layer, timed beside the
    plain version and SDPA with a causal mask (K/V gathered and, at GQA
    shapes, expanded per query head outside the timed region)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunked_prefill import ref
    from repro_torch.kernels.chunked_prefill.kernel import chunked_prefill_cuda

    S, p0, mp, G = 256, 768, 64, H // KV
    sets = [_chunk_case(gen, (p0,), (S,), S, H, KV, Dh, mp, torch.bfloat16, dev)
            for _ in range(n_layers)]
    prepared = []
    for q, pk, pv, table, p0t, tl in sets:
        bound = torch.clamp((p0t + tl + PS - 1) // PS, 1, mp).to(torch.int32)
        qr = q.reshape(1, S, KV, G, Dh).permute(0, 2, 1, 3, 4).reshape(1, KV, S * G, Dh)
        prepared.append((qr.contiguous(), pk, pv, table, bound, p0t))
    kernel_ms = device_time_ms([lambda a=a: chunked_prefill_cuda(*a, g=G) for a in prepared])
    plain_ms = device_time_ms([lambda s=s: ref.chunked_prefill_ref(*s) for s in sets])
    t = p0 + S
    lib_args = []
    rows = torch.arange(S, device=dev)[:, None] + p0
    mask = torch.arange(t, device=dev)[None, :] <= rows           # (S, T) causal
    for q, pk, pv, table, _, _ in sets:
        k = pk[table.long()].reshape(1, -1, KV, Dh)[:, :t].transpose(1, 2).contiguous()
        v = pv[table.long()].reshape(1, -1, KV, Dh)[:, :t].transpose(1, 2).contiguous()
        lib_args.append((q.transpose(1, 2).contiguous(), _expand_kv(k, G), _expand_kv(v, G)))
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=mask)
         for a in lib_args]
    )
    visible = S * (p0 + 1) + S * (S - 1) // 2                     # causal (row, key) pairs
    nbytes = 2 * t * KV * Dh * 2 + 2 * S * H * Dh * 2 + 4 * (mp + 2)
    flops = 4 * H * Dh * visible
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"K3 main shape (B=1, S {S}, p0 {p0}, {H}/{KV} x {Dh}): kernel_ms {kernel_ms:.5f} "
        f"plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} bound_ms {bound_ms:.6f} "
        f"({bound_by})")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# K2: shared-prefix cascade pass (and K1's continuation)
# ---------------------------------------------------------------------------

def _shared_case(gen, n_shared, suffixes, H, KV, Dh, dtype, dev, ps=PS):
    """Lanes whose tables all start with the same ``n_shared`` pages; lane
    b holds ``n_shared * ps + suffixes[b]`` tokens (a negative suffix puts
    its query inside the run) and owns pages for its positive suffix.
    Returns (q, pool_k, pool_v, table, q_pos, kv_pos), shared pages."""
    import torch

    B = len(suffixes)
    pages_of = lambda n: -(-max(n, 0) // ps)
    mp = n_shared + max(1, max(pages_of(n) for n in suffixes))
    n_pages = 1 + n_shared + sum(pages_of(n) for n in suffixes)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(n_pages, ps, KV, Dh, generator=gen, device=dev).to(dtype)
    table = torch.zeros(B, mp, dtype=torch.int32)
    table[:, :n_shared] = torch.arange(1, 1 + n_shared, dtype=torch.int32)
    kv_pos = torch.full((B, mp * ps), -1, dtype=torch.int32)
    used = 1 + n_shared
    for bi, sfx in enumerate(suffixes):
        for pj in range(pages_of(sfx)):
            table[bi, n_shared + pj] = used
            used += 1
        n = n_shared * ps + sfx
        kv_pos[bi, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([[n_shared * ps + s - 1] for s in suffixes], dtype=torch.int32)
    shared = torch.arange(1, 1 + n_shared, dtype=torch.int32, device=dev)
    return (q, pk, pv, table.to(dev), q_pos.to(dev), kv_pos.to(dev)), shared


def _stats_err(got, want) -> dict:
    """K2's (acc, m, l) against the plain version's: m and acc / l (the
    normalised output) absolute, l relative."""
    import torch

    (acc, m, l), (acc_r, m_r, l_r) = got, want
    norm = lambda a, ll: a / torch.where(ll == 0, torch.ones_like(ll), ll)
    return {
        "m": (m - m_r).abs().max().item(),
        "l_rel": ((l - l_r).abs() / l_r.clamp(min=1.0)).max().item(),
        "acc_over_l": (norm(acc, l) - norm(acc_r, l_r)).abs().max().item(),
    }


def phase_k2(dev, n_layers: int) -> dict:
    import torch
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.paged_attention.kernel import shared_prefix_plan

    gen = torch.Generator(device=dev).manual_seed(3)
    n_run = 64
    cases = [
        # queries at 499 and 1022 lie inside the 1024-token run, 1023 at its
        # end, the rest past it (the server's lanes)
        ("server B=8 mha", (-524, -1, 0, 1, 15, 16, 35, 72), 16, 16, 64, 0, 0.0),
        # window 100: most of the run masked, the last lane's run entirely
        ("gqa G=4 window x softcap", (-3, 0, 40, 200), 16, 4, 64, 100, 30.0),
    ]
    err = 0.0
    for name, sfx, H, KV, Dh, window, cap in cases:
        args, sp = _shared_case(gen, n_run, sfx, H, KV, Dh, torch.bfloat16, dev)
        q, pk, pv, table, q_pos, kv_pos = args
        qr = q.reshape(len(sfx), KV, H // KV, Dh)
        got = ops.shared_prefix(qr, pk, pv, sp, q_pos.reshape(-1), window=window, softcap=cap)
        want = ref.shared_prefix_ref(qr, pk, pv, sp, q_pos.reshape(-1), window=window,
                                     softcap=cap)
        fused = ops.paged_attention(*args, sp, window=window, softcap=cap)
        single = ref.paged_attention_ref(*args, window=window, softcap=cap)
        torch.cuda.synchronize()
        e = _stats_err(got, want)
        e_out = (fused.float() - single.float()).abs().max().item()
        assert all(torch.isfinite(t).all() for t in got), name
        log(f"K2 {name}: {_k2_plan_str(shared_prefix_plan, len(sfx), KV, H // KV, Dh, n_run)}")
        log(f"K2 {name}: stats err {json.dumps(e)} (bound {K2_STATS_TOL}); cascade "
            f"(K2 + K1 continuation) vs plain single pass: max_abs_err {e_out:.3e} "
            f"(bound {K1_TOL})")
        assert max(e.values()) <= K2_STATS_TOL, f"K2 {name}: {e}"
        assert e_out <= K1_TOL, f"cascade {name}: {e_out} > {K1_TOL}"
        if window:
            assert (got[1][-1] == -1e30).all() and (got[2][-1] == 0).all(), \
                "K2: a fully masked run must leave m = -1e30, l = 0"
        err = max(err, e["m"], e["acc_over_l"])

    return dict({"name": "shared_prefix", "route": "cuda",
                 "source": "src/repro_torch/csrc/shared_prefix.cu",
                 "replaces": "src/repro/kernels/paged_attention/kernel.py:228",
                 "max_abs_err": err}, **_k2_timed(dev, gen, 16, 16, 64, n_layers))


def _k2_timed(dev, gen, H, KV, Dh, n_layers) -> dict:
    """K2 at the batched server's shape: B = 8 lanes past a 64-page run,
    one input set per layer (it must split; two runs identical), timed
    beside its plain version and SDPA over the gathered run; K1's
    continuation and K1's single pass at the same lanes, and the cascade
    held against the single pass (or both printed with the reason when it
    is slower)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda,
        shared_prefix_cuda,
        shared_prefix_plan,
    )

    n_run, sfx = 64, tuple(n - 1024 for n in SERVER_LANES)
    B, T, G = len(sfx), n_run * PS, H // KV
    sets = [_shared_case(gen, n_run, sfx, H, KV, Dh, torch.bfloat16, dev)
            for _ in range(n_layers)]
    prepared = []
    for (q, pk, pv, table, q_pos, kv_pos), sp in sets:
        qp = q_pos.reshape(B).contiguous()
        bound = torch.clamp((qp + PS) // PS, 1, table.shape[1]).to(torch.int32)
        qr = q.reshape(B, KV, H // KV, Dh).contiguous()
        prepared.append((qr, pk, pv, sp, qp, table, bound, kv_pos))
    lanes, splits, grid = shared_prefix_plan(B, KV, H // KV, Dh, T)
    log(f"K2 server shape {H}/{KV} x {Dh}: "
        f"{_k2_plan_str(shared_prefix_plan, B, KV, H // KV, Dh, n_run)}")
    assert splits > 1 and grid[1] * grid[2] == KV * -(-B // lanes), \
        "K2 must split the run across a cluster"
    first, again = (shared_prefix_cuda(*prepared[0][:5]) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again)), "K2: two runs differ"
    log("K2 server shape: two runs on the same inputs give identical (acc, m, l)")
    k2_ms = device_time_ms([lambda a=a: shared_prefix_cuda(*a[:5]) for a in prepared])
    plain_ms = device_time_ms([lambda a=a: ref.shared_prefix_ref(*a[:5]) for a in prepared])
    inits = [shared_prefix_cuda(*a[:5]) for a in prepared]
    cont_ms = device_time_ms(
        [lambda a=a, i=i: paged_attention_cuda(a[0], a[1], a[2], a[5], a[6], a[4], a[7],
                                               start=n_run, init=i)
         for a, i in zip(prepared, inits)])
    single_ms = device_time_ms(
        [lambda a=a: paged_attention_cuda(a[0], a[1], a[2], a[5], a[6], a[4], a[7])
         for a in prepared])
    lib_args = []
    kp = torch.arange(T, device=dev)[None, :]
    for qr, pk, pv, sp, qp, *_ in prepared:
        k = pk[sp.long()].reshape(T, KV, Dh).transpose(0, 1)[None].contiguous()
        v = pv[sp.long()].reshape(T, KV, Dh).transpose(0, 1)[None].contiguous()
        rows = qr.permute(1, 0, 2, 3).reshape(1, KV, B * (H // KV), Dh).contiguous()
        mask = kp <= qp.repeat_interleave(H // KV)[:, None]     # (B*G, T) causal
        lib_args.append((rows, k, v, mask))   # one head per KV head: G * B rows each
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
         for a in lib_args])
    visible = sum(min(n_run * PS + s, T) for s in sfx)
    run_bytes = 2 * T * KV * Dh * 2
    nbytes = run_bytes + B * H * Dh * 2 + B * H * (Dh + 2) * 4 + 4 * (n_run + B)
    flops = 4 * H * Dh * visible
    bound_ms, bound_by = _bound(nbytes, flops)
    lane_tokens = [n_run * PS + s + 1 for s in sfx]          # visited by the single pass
    single_bytes = sum(2 * t * KV * Dh * 2 for t in lane_tokens)
    suffix_bytes = sum(2 * (t - T) * KV * Dh * 2 for t in lane_tokens)
    log(f"K2 server shape (B={B}, run {n_run} pages = {T} tokens, {H}/{KV} x {Dh}): "
        f"kernel_ms {k2_ms:.5f} plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} "
        f"bound_ms {bound_ms:.6f} ({bound_by}, {nbytes} B)")
    log(f"K1 at the same lanes: continuation over the suffixes (start {n_run}) "
        f"{cont_ms:.5f} ms ({suffix_bytes} B of K/V); single pass over whole tables "
        f"{single_ms:.5f} ms ({single_bytes} B of K/V); cascade K2 + K1 "
        f"{k2_ms + cont_ms:.5f} ms ({run_bytes + suffix_bytes} B of K/V)")
    floor = launch_floor_ms(dev)
    if k2_ms + cont_ms < single_ms:
        log(f"K2 cascade faster than the single pass at the server's lanes: "
            f"{k2_ms + cont_ms:.5f} < {single_ms:.5f} ms")
    else:
        log(f"K2 cascade NOT faster than the single pass at the server's lanes: K2 "
            f"{k2_ms:.5f} + K1 continuation {cont_ms:.5f} = {k2_ms + cont_ms:.5f} ms vs "
            f"{single_ms:.5f} ms. Reason: it takes two launches where the single pass "
            f"takes one, each at least the launch floor of {floor:.5f} ms (one 1-element "
            f"add), while its K/V bytes save {(single_bytes - run_bytes - suffix_bytes) / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"at the HBM rate")
    return {
        "ms": k2_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "k1_continuation_ms": cont_ms, "k1_single_pass_ms": single_ms,
        "k1_single_pass_kv_bytes": single_bytes,
        "cascade_kv_bytes": run_bytes + suffix_bytes,
        "lanes": lanes, "splits": splits, "grid": grid, "launch_floor_ms": floor,
    }


def _k2_plan_str(plan, B, KV, G, Dh, n_pages) -> str:
    lanes, splits, grid = plan(B, KV, G, Dh, n_pages * PS)
    return (f"B={B} KV={KV} G={G} Dh={Dh} run {n_pages * PS} tokens -> {lanes} lanes per "
            f"block, splits {splits}, grid {grid} = {grid[0] * grid[1] * grid[2]} blocks, "
            f"cluster ({splits}, 1, 1)")


def launch_floor_ms(dev) -> float:
    """Device time of the least kernel: an in-place add on one element."""
    import torch

    x = torch.zeros(1, device=dev)
    return device_time_ms([lambda: x.add_(1.0)])


# ---------------------------------------------------------------------------
# K4 / K5: flash attention and flash decode on linear caches (dense route)
# ---------------------------------------------------------------------------

def _linear_case(gen, p0s, lens, S, T, H, KV, Dh, dtype, dev):
    """Queries at p0 + [0, S) against a T-slot cache whose slot t holds
    position t, valid below p0 + len (the dense route's layout)."""
    import torch

    B = len(p0s)
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, T, KV, Dh, generator=gen, device=dev).to(dtype)
    p0 = torch.tensor(p0s, dtype=torch.int32, device=dev)[:, None]
    q_pos = (p0 + torch.arange(S, dtype=torch.int32, device=dev)[None, :]).contiguous()
    slot = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
    valid = (slot < p0 + torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]).contiguous()
    kv_pos = torch.where(valid, slot, torch.full_like(slot, -1)).contiguous()
    return q, k, v, q_pos, kv_pos, valid


def _read_err(out, want, q_pos, kv_pos, valid, window) -> float:
    """Max abs error over the rows with at least one unmasked key (a fully
    masked row is the mean of V in the plain version, zeros in the kernel;
    no caller reads one)."""
    m = (kv_pos[:, None, :] <= q_pos[:, :, None]) & valid[:, None, :]
    if window > 0:
        m &= q_pos[:, :, None] - kv_pos[:, None, :] < window
    rows = m.any(-1)
    return (out[rows].float() - want[rows].float()).abs().max().item()


def _check_linear(name, op, ref, cases, gen, dev, dtypes=None) -> float:
    import torch

    err = 0.0
    tols = {torch.bfloat16: K45_TOL, torch.float32: K45_F32_TOL}
    for label, p0s, lens, S, T, H, KV, Dh, window, cap in cases:
        for dtype in dtypes or tols:
            tol = tols[dtype]
            args = _linear_case(gen, p0s, lens, S, T, H, KV, Dh, dtype, dev)
            out = op(*args, window=window, softcap=cap)
            want = ref(*args, window=window, softcap=cap)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), (name, label)
            e = _read_err(out, want, args[3], args[4], args[5], window)
            log(f"{name} {label} {str(dtype)[6:]}: max_abs_err {e:.3e} over read rows "
                f"(bound {tol})")
            assert e <= tol, f"{name} {label} {dtype}: {e} > {tol}"
            if dtype == torch.bfloat16:
                err = max(err, e)
    return err


def phase_k4(dev, n_layers: int) -> dict:
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    # (label, p0s, lens, S, T, H, KV, Dh, window, softcap): full prefills
    # with ragged true_len (S = T), and appends whose p0 is no multiple of
    # the 64-key tile
    cases = [
        ("prefill mha ragged", (0, 0, 0), (1024, 700, 1), 1024, 1024, 16, 16, 64, 0, 0.0),
        ("prefill gqa d128 window x softcap", (0, 0), (333, 200), 333, 333, 16, 4, 128, 100, 30.0),
        ("append mha p0 1024", (1024,), (256,), 256, 2048, 16, 16, 64, 0, 0.0),
        ("append mqa p0 1000", (1000, 37), (256, 100), 256, 2048, 16, 1, 64, 0, 0.0),
        ("append gqa d128 window x softcap", (517,), (200,), 256, 2048, 8, 2, 128, 300, 50.0),
        ("prefill zamba2 mha d112 ragged", (0, 0), (1024, 777), 1024, 1024, 32, 32, 112, 0, 0.0),
    ]
    err = _check_linear("K4", ops.flash_attention, ref.flash_attention_ref, cases, gen, dev)
    # the tensor-core kernel's edges, bf16: query lengths that leave ragged
    # 16- and 64-row tiles, p0 inside a key tile, MHA/GQA/MQA at every head
    # dim, window x softcap, and windows that mask whole key tiles for some
    # rows of a block
    edges = [
        ("edges S 1 p0 5/63/130 mqa d128", (5, 63, 130), (1, 1, 1), 1, 200, 8, 1, 128, 0, 0.0),
        ("edges S 15 gqa G=4 d32 window 37 x softcap", (0, 70), (15, 15), 15, 100, 16, 4, 32,
         37, 30.0),
        ("edges S 17 mha d16 softcap", (0, 0), (17, 9), 17, 17, 4, 4, 16, 0, 30.0),
        ("edges S 150 T 300 mqa G=8 d112 window 37", (0, 130), (150, 150), 150, 300, 8, 1, 112,
         37, 0.0),
        ("edges S 333 T 333 mha d64 window 20", (0, 0), (333, 300), 333, 333, 16, 16, 64, 20,
         0.0),
        ("edges S 100 at p0 40 gqa G=4 d128 window 50 x softcap", (40,), (100,), 100, 300, 16, 4,
         128, 50, 30.0),
    ]
    err = max(err, _check_linear("K4", ops.flash_attention, ref.flash_attention_ref, edges,
                                 gen, dev, dtypes=(torch.bfloat16,)))

    out = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:105", "max_abs_err": err}
    # the main path's two shapes: a full prefill S = T = 1024 (bucket 64 of
    # a ~1k-token first turn), and a session hit's 256-token append chunk at
    # p0 1024 against the 2048-slot cache (MHA 16 x 64); and Zamba2's shared
    # attention block over a 1024-token prefill (MHA 32 x 112)
    for shape, p0, S, T, H, Dh in (("prefill", 0, 1024, 1024, 16, 64),
                                   ("append", 1024, 256, 2048, 16, 64),
                                   ("zamba2", 0, 1024, 1024, 32, 112)):
        stats = _k4_timed(dev, gen, shape, p0, S, T, H, H, Dh, n_layers)
        out.update(stats if shape == "prefill" else
                   {f"{shape}_{k}": v for k, v in stats.items()})
    return out


def _k4_timed(dev, gen, shape, p0, S, T, H, KV, Dh, n_layers) -> dict:
    """K4 at one serving shape (B = 1, queries at p0 + [0, S) against T
    slots, bf16, one input set per layer), timed beside its plain version
    and SDPA with a causal mask (K/V expanded per query head at GQA
    shapes, outside the timed region)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    G = H // KV
    sets = [_linear_case(gen, (p0,), (S,), S, T, H, KV, Dh, torch.bfloat16, dev)
            for _ in range(n_layers)]
    i32 = [(q, k, v, qp, kp, va.to(torch.int32)) for q, k, v, qp, kp, va in sets]
    kernel_ms = device_time_ms([lambda a=a: flash_attention_cuda(*a) for a in i32])
    plain_ms = device_time_ms([lambda a=a: ref.flash_attention_ref(*a) for a in sets])
    n_kv = p0 + S
    rows = torch.arange(S, device=dev)[:, None] + p0
    mask = torch.arange(n_kv, device=dev)[None, :] <= rows           # causal (S, n_kv)
    lib = [(q.transpose(1, 2).contiguous(),
            _expand_kv(k[:, :n_kv].transpose(1, 2).contiguous(), G),
            _expand_kv(v[:, :n_kv].transpose(1, 2).contiguous(), G)) for q, k, v, *_ in sets]
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(*a, attn_mask=mask) for a in lib])
    visible = S * p0 + S * (S + 1) // 2                             # causal (row, key) pairs
    nbytes = 2 * n_kv * KV * Dh * 2 + 2 * S * H * Dh * 2 + 4 * (S + 2 * T)
    bound_ms, bound_by = _bound(nbytes, 4 * H * Dh * visible)
    log(f"K4 {shape} shape (B=1, S {S}, p0 {p0}, T {T}, {H}/{KV} x {Dh}): kernel_ms "
        f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} bound_ms "
        f"{bound_ms:.6f} ({bound_by})")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_k5(dev, n_layers: int) -> dict:
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.decode_attention.kernel import decode_plan

    gen = torch.Generator(device=dev).manual_seed(5)
    T = 2048
    lens8 = (1, 128, 700, 1250, 1251, 1300, 1900, 2048)
    cases = [
        ("B=1 mha", (1249,), (1,), 1, T, 16, 16, 64, 0, 0.0),
        ("B=8 mha ragged", tuple(n - 1 for n in lens8), (1,) * 8, 1, T, 16, 16, 64, 0, 0.0),
        ("B=8 gqa d128 window x softcap", tuple(n - 1 for n in lens8), (1,) * 8, 1, T,
         16, 4, 128, 300, 30.0),
        ("B=8 mqa", tuple(n - 1 for n in lens8), (1,) * 8, 1, T, 16, 1, 64, 0, 0.0),
        ("B=1 zamba2 mha d112", (1100,), (1,), 1, T, 32, 32, 112, 0, 0.0),
    ]
    for label, p0s, _, _, _, H, KV, Dh, _, _ in cases:
        log(f"K5 {label}: {_k5_plan_str(decode_plan, len(p0s), H, KV, Dh, T)}")
    err = _check_linear("K5", ops.decode_attention, ref.decode_attention_ref, cases, gen, dev)

    out = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/kernel.py:96", "max_abs_err": err}
    # the main path's shapes: one decode query per lane against the
    # 2048-slot cache holding ~1.25k tokens, B = 1 (engine) and 8 (server),
    # and Zamba2's shared attention block (MHA 32 x 112) at B = 1
    for name, B, H, KV, Dh in (("B=1", 1, 16, 16, 64), ("B=8", 8, 16, 16, 64),
                               ("zamba2 B=1", 1, 32, 32, 112)):
        stats = _k5_timed(dev, gen, name, B, H, KV, Dh, n_layers)
        out.update(stats if name == "B=1" else
                   {f"{'b8' if B == 8 else 'zamba2'}_{k}": v for k, v in stats.items()})
    return out


def _k5_timed(dev, gen, name, B, H, KV, Dh, n_layers, T=2048, n_valid=1250) -> dict:
    """K5 at one serving shape: one decode query per lane against ``T``
    slots holding ``n_valid`` tokens (bf16, one input set per layer), run
    twice for identical bits, timed beside its plain version and SDPA with
    a bool mask (K/V expanded per query head at GQA shapes, outside the
    timed region)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda, decode_plan

    G = H // KV
    splits, grid = decode_plan(B, KV, T)
    log(f"K5 {name}: {_k5_plan_str(decode_plan, B, H, KV, Dh, T)}")
    if B == 1:
        assert splits > 1, "K5 must split the walk across a cluster at B = 1"
    sets = [_linear_case(gen, (n_valid - 1,) * B, (1,) * B, 1, T, H, KV, Dh,
                         torch.bfloat16, dev) for _ in range(n_layers)]
    prep = [(q.reshape(B, KV, G, Dh).contiguous(), k, v, qp.reshape(B).contiguous(),
             kp, va.to(torch.int32)) for q, k, v, qp, kp, va in sets]
    first, again = (decode_attention_cuda(*prep[0]) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, again), f"K5 {name}: two runs differ"
    kernel_ms = device_time_ms([lambda a=a: decode_attention_cuda(*a) for a in prep])
    plain_ms = device_time_ms([lambda a=a: ref.decode_attention_ref(*a) for a in sets])
    lib = [(q.transpose(1, 2).contiguous(), _expand_kv(k.transpose(1, 2).contiguous(), G),
            _expand_kv(v.transpose(1, 2).contiguous(), G), va[:, None, None, :])
           for q, k, v, _, _, va in sets]
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
         for a in lib])
    nbytes = B * (2 * n_valid * KV * Dh * 2 + 2 * H * Dh * 2 + 4 * (1 + 2 * T))
    bound_ms, bound_by = _bound(nbytes, B * 4 * H * Dh * n_valid)
    log(f"K5 {name} (T {T}, {n_valid} valid slots, {H}/{KV} x {Dh}): kernel_ms "
        f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} bound_ms "
        f"{bound_ms:.6f} ({bound_by}, {nbytes} B); two runs identical")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, splits=splits, grid=grid)


def _k5_plan_str(plan, B, H, KV, Dh, T) -> str:
    splits, grid = plan(B, KV, T)
    return (f"B={B} H={H} KV={KV} Dh={Dh} T={T} -> splits {splits}, grid {grid} = "
            f"{grid[0] * grid[1] * grid[2]} blocks, cluster ({splits}, 1, 1)")


# ---------------------------------------------------------------------------
# K1-K5 at the GQA groups of the MoE and Qwen2 models: granite-moe-3b-a800m
# (24/8 x 64, G = 3) and qwen2-0.5b (14/2 x 64, G = 7)
# ---------------------------------------------------------------------------

GQA_MODELS = (("granite", 24, 8, 64), ("qwen2", 14, 2, 64))
GQA_F32_TOL = 1e-4   # K1-K5 in f32 (TF32 off) at these shapes: K45_F32_TOL,
                     # the same f32 products summed in another order


def phase_gqa(dev, n_layers: int) -> dict:
    """K1, K2 (with K1's continuation), K3, K4 and K5 against their plain
    versions at granite's (24/8 x 64, G = 3) and qwen2's (14/2 x 64, G = 7)
    head layouts, in bf16 and in f32: K1 on ragged lanes (an empty one,
    page bounds mid-page) at ps 8/16/64 with planned and forced 1/8
    splits, window x softcap; K2's stats and the cascade (K2 + K1's
    continuation, forced 1/8 splits too) with queries inside, at the end of
    and past a 256-token run; K3 with chunks whose S·G is no multiple of
    its 64-row tile (S 1, 17, 150, 256), p0 inside a key tile and a page,
    ps 8/16/64, window x softcap; K4 prefills and appends with p0 inside a
    key tile; K5 at B = 1 and ragged B = 8. Then each kernel timed at its
    model's serving shape beside its plain version, SDPA and its bound.
    Returns {"errors": bf16 max abs error per kernel, "timed": {model:
    {kernel: stats}}}."""
    import torch
    from repro_torch.kernels.chunked_prefill import ops as chunk_ops
    from repro_torch.kernels.chunked_prefill import ref as chunk_ref
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    gen = torch.Generator(device=dev).manual_seed(21)
    errs = dict.fromkeys(("paged_attention", "shared_prefix", "chunked_prefill",
                          "flash_attention", "decode_attention"), 0.0)
    timed = {}
    for model, H, KV, Dh in GQA_MODELS:
        G = H // KV
        tag = f"{model} {H}/{KV} x {Dh} (G = {G})"
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            dn = str(dtype)[6:]
            k1 = k2 = k2c = 0.0
            for ps in (8, 16, 64):
                lens = (0, 1, 2 * ps + 3, 300, 777, 1024)
                args = _paged_case(gen, lens, H, KV, Dh, dtype, dev, ps=ps)
                cont, sp = _shared_case(gen, 256 // ps, (-100, -1, 0, 1, 21, 300), H, KV, Dh,
                                        dtype, dev, ps=ps)
                q, pk, pv, _, q_pos, _ = cont
                qr = q.reshape(q.shape[0], KV, G, Dh)
                got = paged_ops.shared_prefix(qr, pk, pv, sp, q_pos.reshape(-1))
                want = paged_ref.shared_prefix_ref(qr, pk, pv, sp, q_pos.reshape(-1))
                torch.cuda.synchronize()
                e2 = _stats_err(got, want)
                assert max(e2.values()) <= (K2_STATS_TOL if bf16 else GQA_F32_TOL), (tag, ps, e2)
                k2 = max(k2, e2["m"], e2["acc_over_l"])
                for splits in (None, 1, 8):
                    with _forced_splits(splits) if splits else contextlib.nullcontext():
                        for window, cap in ((0, 0.0), (200, 30.0)):
                            run = lambda: paged_ops.paged_attention(  # noqa: E731
                                *args, window=window, softcap=cap)
                            out = run()
                            k1 = max(k1, _k1_check(
                                f"{tag} {dn} ps {ps} splits {splits or 'planned'} window "
                                f"{window}", out, run(),
                                paged_ref.paged_attention_ref(*args, window=window, softcap=cap),
                                K1_TOL if bf16 else GQA_F32_TOL))
                            assert (out[0] == 0).all(), f"K1 {tag}: empty lane not exact zeros"
                        run = lambda: paged_ops.paged_attention(*cont, sp)  # noqa: E731
                        k2c = max(k2c, _k1_check(
                            f"cascade {tag} {dn} ps {ps} splits {splits or 'planned'}", run(),
                            run(), paged_ref.paged_attention_ref(*cont),
                            K1_TOL if bf16 else GQA_F32_TOL))
            log(f"K1 {tag} {dn}: ragged lanes at ps 8/16/64, planned and forced 1/8 splits, "
                f"window x softcap, two runs identical: max_abs_err {k1:.3e}; K2 stats max "
                f"err {k2:.3e}; cascade (K2 + K1 continuation) vs plain single pass "
                f"{k2c:.3e}")
            k3 = 0.0
            for S, ps, window, cap in ((150, 16, 0, 0.0), (17, 8, 37, 30.0), (1, 64, 0, 0.0),
                                       (256, 16, 100, 30.0)):
                p0s, lens = (0, 5, 77, 130), (S, max(S - 3, 1), 1, S)
                mp = -(-(max(p0s) + S) // ps) + 1
                args = _chunk_case(gen, p0s, lens, S, H, KV, Dh, mp, dtype, dev, ps=ps)
                k3 = max(k3, _check_chunk(
                    f"{tag} {dn} S {S} (S*G {S * G}) ps {ps} p0 0/5/77/130 window {window}",
                    chunk_ops, chunk_ref, args, lens, window, cap,
                    K3_TOL if bf16 else GQA_F32_TOL))
            lens8 = (1, 128, 700, 1250, 1251, 1300, 1900, 2048)
            k4 = _check_linear("K4", flash_ops.flash_attention, flash_ref.flash_attention_ref, [
                (f"{tag} prefill ragged", (0, 0, 0), (1024, 700, 1), 1024, 1024, H, KV, Dh, 0,
                 0.0),
                (f"{tag} append p0 1000/37", (1000, 37), (256, 100), 256, 2048, H, KV, Dh, 0,
                 0.0),
                (f"{tag} S 17 p0 5/70 window 37 x softcap", (5, 70), (17, 9), 17, 100, H, KV, Dh,
                 37, 30.0),
                (f"{tag} S 150 T 300 p0 0/130 window 20", (0, 130), (150, 150), 150, 300, H, KV,
                 Dh, 20, 0.0),
            ], gen, dev, dtypes=(dtype,))
            k5 = _check_linear("K5", dec_ops.decode_attention, dec_ref.decode_attention_ref, [
                (f"{tag} B=1", (1249,), (1,), 1, 2048, H, KV, Dh, 0, 0.0),
                (f"{tag} B=8 ragged", tuple(n - 1 for n in lens8), (1,) * 8, 1, 2048, H, KV, Dh,
                 0, 0.0),
                (f"{tag} B=8 window x softcap", tuple(n - 1 for n in lens8), (1,) * 8, 1, 2048,
                 H, KV, Dh, 300, 30.0),
            ], gen, dev, dtypes=(dtype,))
            if bf16:
                for key, e in (("paged_attention", max(k1, k2c)), ("shared_prefix", k2),
                               ("chunked_prefill", k3), ("flash_attention", k4),
                               ("decode_attention", k5)):
                    errs[key] = max(errs[key], e)
        timed[model] = {
            "paged_attention": _k1_timed(dev, gen, f"{model} B=1", (1024,), H, KV, Dh,
                                         n_layers)[0],
            "shared_prefix": _k2_timed(dev, gen, H, KV, Dh, n_layers),
            "chunked_prefill": _k3_timed(dev, gen, H, KV, Dh, n_layers),
            "flash_attention": _k4_timed(dev, gen, f"{model} prefill", 0, 1024, 1024, H, KV,
                                         Dh, n_layers),
            "decode_attention": _k5_timed(dev, gen, f"{model} B=1", 1, H, KV, Dh, n_layers),
        }
    log(f"gqa: bf16 max_abs_err per kernel {json.dumps(errs)}")
    return {"errors": errs, "timed": timed}


# ---------------------------------------------------------------------------
# Batched path: many tenants sharing a system prompt
# ---------------------------------------------------------------------------

N_SLOTS, N_TENANTS, SYSTEM_TOKENS, MAX_NEW_BATCHED = 8, 16, 1024, 16


def _counters():
    from repro_torch.kernels.chunked_prefill import ops as chunk_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    return {
        "paged_attention": paged_ops.paged_attention,
        "shared_prefix": paged_ops.shared_prefix,
        "chunked_prefill": chunk_ops.chunked_prefill_attention,
    }


def _drive(server, on_pure_step=None):
    """``run_to_completion`` with each step timed: returns [(ready lanes,
    step ms, pure)] where a pure step ran no admission and no prefill chunk
    (only the batched decode). ``on_pure_step(server, k)`` may take over a
    pure step (e.g. to profile it) and returns True when it stepped."""
    import torch

    steps, k = [], 0
    while server.busy:
        free = sum(s is None for s in server.slots)
        pure = not server._prefill_fifo and not (server.queue and free)
        ready = sum(1 for s in server.slots if s is not None and s.prefilled)
        if pure and on_pure_step is not None and on_pure_step(server, k):
            k += 1
            continue
        t0 = time.perf_counter()
        server.step()       # ends in the step's host sync of the sampled tokens
        steps.append((ready, (time.perf_counter() - t0) * 1e3, pure))
        k += pure
    torch.cuda.synchronize()
    return steps


def phase_batched(dev):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.serving import BatchedLLMService

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    t0 = time.perf_counter()
    svc = BatchedLLMService.create(
        "paper-qwen1.5-0.5b", cfg, seed=0, n_slots=N_SLOTS, max_len=2048, paged=True,
        page_size=PS, kv_pages=1024, share_prefixes=True, prefill_chunk_tokens=256,
        device=dev,
    )
    server = svc.server
    torch.cuda.synchronize()
    log(f"batched: service built in {time.perf_counter() - t0:.2f} s ({N_SLOTS} slots, "
        f"{server.allocator.n_pages - 1} pages of {PS} tokens, "
        f"{server.allocator.page_bytes} B per page)")
    rng = np.random.default_rng(12)
    system = rng.integers(300, cfg.vocab_size, size=SYSTEM_TOKENS).tolist()
    questions = [rng.integers(300, cfg.vocab_size, size=int(rng.integers(24, 73))).tolist()
                 for _ in range(N_TENANTS)]
    # warm-up (cuBLAS handles at the batched shapes), not part of the counted run
    server.submit(rng.integers(300, 5000, size=40).tolist(), max_new=4)
    server.submit(rng.integers(300, 5000, size=40).tolist(), max_new=4)
    server.run_to_completion()
    server.finished.clear()

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    pool = server.session_pool
    hits0, toks0 = pool.shared_hits, pool.shared_tokens

    # wave 1: 16 tenants at once
    rids = [server.submit(system + qs, max_new=MAX_NEW_BATCHED, cache_key=f"tenant{i}")
            for i, qs in enumerate(questions)]
    t_wave = time.perf_counter()
    steps1 = _drive(server)
    wave_s = time.perf_counter() - t_wave
    fin = {f.request_id: f for f in server.finished}
    server.finished.clear()
    first = [fin[r] for r in rids]
    gen_tokens = sum(len(f.token_ids) for f in first)
    shared_hits = pool.shared_hits - hits0
    used = server.allocator.used_pages
    st = pool.stats()
    log(f"batched: wave of {N_TENANTS} tenants ({SYSTEM_TOKENS}-token shared prompt + "
        f"24-72 private tokens, max_new {MAX_NEW_BATCHED}): {gen_tokens} tokens in "
        f"{wave_s:.3f} s = {gen_tokens / wave_s:.2f} tokens/s over {len(steps1)} steps; "
        f"shared hits {shared_hits}, shared tokens {pool.shared_tokens - toks0}")
    log(f"batched: pages in use {used} physical vs {st['pages_in_use']} without sharing "
        f"(the entries' own page counts)")
    assert all(len(f.token_ids) == MAX_NEW_BATCHED or f.token_ids[-1] in server.stop_tokens
               for f in first)
    assert shared_hits >= N_TENANTS - 1, shared_hits
    assert used < st["pages_in_use"], (used, st)

    # wave 2: 8 sessions take a second turn; after 4 timed pure decode
    # steps, 4 are profiled, and the next one is also run on clones for
    # the batched_equivalence phase
    profiled, equivalence = {}, {}

    def hook(srv, k):
        if k == 4:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(4):
                    srv.step()
                torch.cuda.synchronize()
                profiled["traced_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 4
            profiled["prof"] = prof
            return True
        if k == 5:
            # its launches compare the kernels with each other and with the
            # plain path: they are not the served run's, so they do not count
            before = {name: fn.launches for name, fn in counters.items()}
            equivalence.update(phase_batched_equivalence(srv))
            for name, fn in counters.items():
                fn.launches = before[name]
        return False

    keys = list(range(0, N_TENANTS, 2))
    hist = {i: system + questions[i] + first[i].token_ids for i in keys}
    follow = {i: rng.integers(300, cfg.vocab_size, size=int(rng.integers(16, 41))).tolist()
              for i in keys}
    rids2 = {i: server.submit(hist[i] + follow[i], max_new=MAX_NEW_BATCHED,
                              cache_key=f"tenant{i}") for i in keys}
    steps2 = _drive(server, hook)
    fin = {f.request_id: f for f in server.finished}
    server.finished.clear()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"batched: kernel launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    for i in keys:
        f = fin[rids2[i]]
        assert f.cache_hit and f.reused_tokens == len(hist[i]), (i, f.reused_tokens, len(hist[i]))
        assert len(hist[i] + follow[i]) - f.reused_tokens == len(follow[i])
    log(f"batched: second turns of {len(keys)} sessions: all session hits prefilling only "
        f"their {min(map(len, follow.values()))}-{max(map(len, follow.values()))}-token suffix")

    pure8 = [ms for ready, ms, pure in steps1 + steps2 if pure and ready == N_SLOTS]
    ttfts = [f.ttft_ms for f in first]
    summary = {
        "wave_tokens_per_s": gen_tokens / wave_s,
        "decode_ms_per_step_b8_p50": float(np.percentile(pure8, 50)),
        "decode_steps_b8": len(pure8),
        "decode_tokens_per_s_b8": N_SLOTS * 1e3 / float(np.percentile(pure8, 50)),
        "ttft_ms_p50": float(np.percentile(ttfts, 50)),
        "ttft_ms_p90": float(np.percentile(ttfts, 90)),
        "pages_in_use": used, "pages_without_sharing": st["pages_in_use"],
        "shared_hits": shared_hits,
    }
    log(f"batched: summary {json.dumps(summary)}")
    assert equivalence, "no cascade step was left to compare"
    if profiled:
        busy, rows = _device_ms(profiled["prof"])
        busy /= 4
        wall = float(np.percentile(pure8, 50))
        entry = {"wall_ms": wall, "traced_wall_ms": profiled["traced_wall_ms"],
                 "device_busy_ms": busy if busy > 0 else "not measured",
                 "device_idle_share": max(0.0, 1 - busy / wall) if busy > 0 else "not measured",
                 "top_kernels_ms": [(k[:70], t / 4, c // 4) for k, t, c in rows[:8]],
                 "repro_kernels": [(k.replace("(anonymous namespace)::", "").split("(")[0][-60:],
                                    t / 4, c // 4) for k, t, c in rows if "repro_torch" in k]}
        log(f"profile decode_step_b8: {json.dumps(entry)}")
        assert_served_by(entry, "shared_prefix_split", cfg.n_layers)
        assert_served_by(entry, "paged_attention_split", cfg.n_layers)
    return svc, launches, summary, equivalence


def phase_batched_equivalence(server) -> dict:
    """One decode step of the server as it stands (all lanes decoding, the
    cascade active), run three times on clones of its pools and kv_pos —
    (a) the kernels with the shared run, (b) the kernels without it,
    (c) the plain path — and the ready lanes' logits compared. The server
    itself is untouched."""
    import torch
    from repro_torch.models import decode_step_paged

    plan = server._grow_and_plan()
    assert plan is not None and plan.shared_run, "the cascade is not active at this step"
    table, tokens, pos, shared = server.decode_inputs(plan)
    wp = plan.w * server.allocator.page_size
    cfg = server.cfg
    logits = {}
    for name, c, sp in (("cascade", cfg, shared), ("single", cfg, None),
                        ("plain", cfg.replace(attn_impl="reference"), None)):
        pools = [{k: t.clone() for k, t in p.items()} for p in server.allocator.pools]
        kv = server._kv_pos[:, :wp].clone()
        logits[name] = decode_step_paged(server.params, c, pools, table, kv, tokens, pos,
                                         sp)[plan.ready, 0].float()
        del pools
    torch.cuda.synchronize()
    ready = len(plan.ready)
    assert all(torch.isfinite(v).all() for v in logits.values())
    assert logits["cascade"].shape == (ready, cfg.vocab_size)
    d_single = (logits["cascade"] - logits["single"]).abs().max().item()
    d_plain = (logits["cascade"] - logits["plain"]).abs().max().item()
    agree = (logits["cascade"].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
    log(f"batched_equivalence: one decode step, {ready} lanes, table width {plan.w} pages, "
        f"shared run {len(plan.shared_run)} pages: max |logit diff| cascade vs single pass "
        f"{d_single:.4e} (bound {CASCADE_TOL}), cascade vs plain {d_plain:.4e} (bound "
        f"{PLAIN_TOL}); argmax agreement with plain {agree:.3f}")
    assert d_single <= CASCADE_TOL, f"cascade vs single pass: {d_single} > {CASCADE_TOL}"
    assert d_plain <= PLAIN_TOL, f"cascade vs plain: {d_plain} > {PLAIN_TOL}"
    return {"cascade_vs_single": d_single, "cascade_vs_plain": d_plain,
            "shared_run_pages": len(plan.shared_run), "lanes": ready}


def phase_migration(params, dev) -> dict:
    """KV-page migration between three TorchLLMServices with the same
    weights: a serves a session and exports its pages; b installs them
    (bit-exact, next turn a "pages" warm start); c primes from token ids
    (next turn a "tokens" warm start). Both warm turns prefill only the
    new prompt."""
    import numpy as np
    import torch
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.serving import TorchLLMService

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    mk = lambda: TorchLLMService.create("paper-qwen1.5-0.5b", cfg, max_len=2048,
                                        page_size=PS, kv_pages=256, device=dev,
                                        params=params)
    a, b, c = mk(), mk(), mk()
    rng = np.random.default_rng(5)
    ctx = rng.integers(300, cfg.vocab_size, size=600).tolist()
    p1 = rng.integers(300, cfg.vocab_size, size=45).tolist()
    r1 = a.completion(ctx, p1, 16, cache_key="roamer")
    hist = ctx + p1 + r1.token_ids
    t0 = time.perf_counter()
    ship = a.export_kv_pages("roamer")
    export_ms = (time.perf_counter() - t0) * 1e3
    assert ship is not None and ship.token_ids == hist
    t0 = time.perf_counter()
    assert b.install_kv_pages("roamer", ship.token_ids, ship.payloads, 0)
    install_ms = (time.perf_counter() - t0) * 1e3
    ea = a.engine.session_pool.peek("roamer")
    eb = b.engine.session_pool.peek("roamer")
    full = len(hist) // PS
    pa, pb = a.engine.session_pool.allocator.pools, b.engine.session_pool.allocator.pools
    for ga, gb in zip(pa, pb):
        for name in ("k", "v"):
            for x, y in zip(ea.pages[:full], eb.pages[:full]):
                assert torch.equal(ga[name][:, x].view(torch.int16),
                                   gb[name][:, y].view(torch.int16)), (name, x, y)
    t0 = time.perf_counter()
    assert c.prime("roamer", hist)
    prime_ms = (time.perf_counter() - t0) * 1e3
    p2 = rng.integers(300, cfg.vocab_size, size=30).tolist()
    out = {}
    for name, svc, source in (("ship", b, "pages"), ("prime", c, "tokens")):
        r = svc.completion(hist, p2, 16, cache_key="roamer")
        assert r.warm_start and r.warm_source == source, (name, r.warm_source)
        assert r.reused_tokens == len(hist) and r.prefill_tokens == len(p2), (
            name, r.reused_tokens, r.prefill_tokens)
        out[name] = r
    # the origin's own next turn, for comparison: its tail page was written
    # by decode steps, the installer's by a prefill chunk, so bf16 near-ties
    # may flip; reported, not required
    origin = a.completion(hist, p2, 16, cache_key="roamer")
    report = {"pages_shipped": len(ship.payloads), "bytes": sum(map(len, ship.payloads)),
              "export_ms": export_ms, "install_ms": install_ms, "prime_ms": prime_ms,
              "ttft_ms_after_ship": out["ship"].ttft_ms,
              "ttft_ms_after_prime": out["prime"].ttft_ms,
              "ship_tokens_equal_origin": out["ship"].token_ids == origin.token_ids,
              "ship_tokens_equal_prime": out["ship"].token_ids == out["prime"].token_ids}
    log(f"migration: {full} full pages of a {len(hist)}-token session round-trip "
        f"bit-exact; warm starts 'pages' and 'tokens' prefill only the {len(p2)}-token "
        f"prompt: {json.dumps(report)}")
    return report


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def phase_main(dev):
    import numpy as np
    import torch
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.kernels.chunked_prefill import ops as chunk_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.serving import TorchLLMService
    from repro_torch.tokenizer import assistant_header, encode_turn

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    t0 = time.perf_counter()
    svc = TorchLLMService.create(
        "paper-qwen1.5-0.5b", cfg, seed=0, max_len=2048, page_size=PS,
        kv_pages=1024, device=dev,
    )
    torch.cuda.synchronize()
    log(f"main: service built in {time.perf_counter() - t0:.2f} s "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"bf16 weights {sum(p.numel() for p in _leaves(svc.engine.params)) * 2 / 2**30:.3f} GiB)")
    tok = svc.tokenizer
    rng = np.random.default_rng(0)

    def prompt(turn: int, n_doc: int):
        ids = encode_turn(tok, "user", f"turn {turn}: explain the attached sensor log")
        doc = rng.integers(300, cfg.vocab_size, size=n_doc).tolist()
        return ids[:-2] + doc + ids[-2:] + assistant_header(tok)

    # warm-up request (cuBLAS handles, allocator), not part of the counted run
    svc.completion(rng.integers(300, 5000, size=64).tolist(), prompt(0, 16), 4, cache_key="warmup")
    torch.cuda.synchronize()

    paged_ops.paged_attention.launches = 0
    chunk_ops.chunked_prefill_attention.launches = 0
    sessions = {f"s{i}": rng.integers(300, cfg.vocab_size, size=200 + 200 * i).tolist()
                for i in range(3)}
    turns, last_turn = [], {}
    for turn in range(3):
        for key, ctx in sessions.items():
            p = prompt(turn + 1, 300)
            r = svc.completion(ctx, p, 32, cache_key=key)
            n_in = len(ctx) + len(p)
            assert len(r.token_ids) == 32 or r.token_ids[-1] in svc.engine.stop_tokens, r.token_ids
            if turn > 0:
                assert r.cache_hit, (key, turn)
                assert r.reused_tokens == len(ctx), (key, turn, r.reused_tokens, len(ctx))
                assert r.prefill_tokens == len(p), (key, turn, r.prefill_tokens, len(p))
            turns.append({"session": key, "turn": turn + 1, "input_tokens": n_in,
                          "reused": r.reused_tokens, "prefilled": r.prefill_tokens,
                          "ttft_ms": r.ttft_ms, "decode_p50_ms": r.decode_p50_ms,
                          "decode_p99_ms": r.decode_p99_ms, "inference_ms": r.inference_ms})
            log(f"main: {key} turn {turn + 1}: input {n_in} reused {r.reused_tokens} "
                f"prefilled {r.prefill_tokens} ttft_ms {r.ttft_ms:.3f} "
                f"decode_p50_ms/token {r.decode_p50_ms:.3f}")
            sessions[key] = ctx + p + r.token_ids
            last_turn[key] = (sessions[key], r.token_ids)
    torch.cuda.synchronize()
    launches = {
        "paged_attention": paged_ops.paged_attention.launches,
        "chunked_prefill": chunk_ops.chunked_prefill_attention.launches,
    }
    log(f"main: kernel launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    hits = [t for t in turns if t["turn"] > 1]
    summary = {
        "ttft_ms_p50_hit_turns": float(np.percentile([t["ttft_ms"] for t in hits], 50)),
        "ttft_ms_p50_first_turns": float(np.percentile(
            [t["ttft_ms"] for t in turns if t["turn"] == 1], 50)),
        "decode_ms_per_token_p50": float(np.percentile([t["decode_p50_ms"] for t in turns], 50)),
    }
    log(f"main: summary {json.dumps(summary)}")
    return svc, last_turn, launches, summary


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _prefilled(cfg, params, ids, n_more, dev):
    """Fresh pages holding ``ids`` (prefilled in 256-token chunks) with room
    for ``n_more`` decode steps: returns (allocator, pages, table, kv_pos,
    logits of the last prompt token)."""
    import torch
    from repro_torch.serving import PagedKVAllocator, PagedPrefiller

    n, total = len(ids), len(ids) + n_more
    alloc = PagedKVAllocator(cfg, page_size=PS, n_pages=2 + -(-total // PS), device=dev)
    pages = alloc.alloc(alloc.pages_for(total))
    first = PagedPrefiller(cfg, params, alloc, dev).prefill_ids(pages, ids, 0)
    w = 1
    while w < len(pages):
        w *= 2
    table = torch.from_numpy(alloc.table_for(pages, w * PS)).to(dev)[None, :]
    iota = torch.arange(w * PS, dtype=torch.int32, device=dev)
    kv_pos = torch.where(iota < n, iota, torch.full_like(iota, -1))[None, :]
    return alloc, pages, table, kv_pos, first


def _decode_forced(cfg, params, alloc, table, kv_pos, n, forced, dev):
    """Decode ``forced`` tokens one by one from position ``n``; returns
    each step's logits (V,)."""
    import torch
    from repro_torch.models import decode_step_paged

    out = []
    for i, t in enumerate(forced):
        logits = decode_step_paged(
            params, cfg, alloc.pools, table, kv_pos,
            torch.tensor([[t]], dtype=torch.int32, device=dev),
            torch.tensor([n + i], dtype=torch.int32, device=dev),
        )
        out.append(logits[0, 0])
    return out


def teacher_forced_logits(cfg, params, ids, forced, dev):
    """Prefill ``ids``, then decode ``forced`` tokens one by one (teacher
    forcing); returns the logits of every step, (len(forced) + 1, V), f32."""
    import torch

    alloc, _, table, kv_pos, first = _prefilled(cfg, params, ids, len(forced), dev)
    steps = _decode_forced(cfg, params, alloc, table, kv_pos, len(ids), forced, dev)
    return torch.stack([first] + steps).float()


def _device_ms(prof) -> tuple:
    """(total device ms, [(kernel name, device ms, calls)] by time) of a
    torch.profiler run, over the device-side (kernel and memcpy) events
    only: a CPU op's self device time repeats its kernels' time."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def phase_profile(svc, last_turn, dev) -> dict:
    """Where the time goes on the kernel path: 8 decode steps and one
    256-token prefill chunk of session s0's last turn, each timed on the
    host clock without the profiler, then traced with torch.profiler for
    the device busy time and the top kernels. The chunk's trace must show
    the bf16 tensor-core K3 once per layer and no f32 FMA kernel."""
    from repro_torch.serving import PagedPrefiller

    cfg, params = svc.engine.cfg, svc.engine.params
    hist, forced = last_turn["s0"]
    ids = hist[: len(hist) - len(forced)]
    n = len(ids)
    alloc, pages, table, kv_pos, _ = _prefilled(cfg, params, ids, len(forced), dev)
    steps = forced[:8]
    pref = PagedPrefiller(cfg, params, alloc, dev)
    p0 = n - 256
    work = {
        "decode_step": (lambda: _decode_forced(cfg, params, alloc, table, kv_pos, n, steps, dev),
                        len(steps)),
        "prefill_chunk_256": (lambda: pref.run_chunk(pages, ids[p0:], p0), 1),
    }
    report = {name: profile_work(name, fn, per) for name, (fn, per) in work.items()}
    assert_served_by(report["prefill_chunk_256"], "chunked_prefill_mma", cfg.n_layers)
    assert_served_by(report["decode_step"], "paged_attention_split", cfg.n_layers)
    return report


def profile_work(name, fn, per) -> dict:
    """Host wall of ``fn`` (after one warm-up run), then one run traced by
    torch.profiler: device busy time and idle share per unit of work
    (``fn`` does ``per`` units), and the top device kernels. A trace with
    no device time is reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / per
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3 / per
    busy, rows = _device_ms(prof)
    busy /= per
    entry = {"wall_ms": wall, "traced_wall_ms": traced_wall,
             "device_busy_ms": busy if busy > 0 else "not measured",
             # against the untraced wall: tracing slows the host, not the kernels
             "device_idle_share": max(0.0, 1 - busy / wall) if busy > 0 else "not measured",
             "top_kernels_ms": [(k[:70], t / per, c // per) for k, t, c in rows[:8]],
             # the port's own kernels by name: which of them served this work
             "repro_kernels": [(k.replace("(anonymous namespace)::", "").split("(")[0][-60:],
                                t / per, c // per) for k, t, c in rows if "repro_torch" in k]}
    log(f"profile {name}: {json.dumps(entry)}")
    return entry


def assert_served_by(entry, kernel: str, launches: int) -> None:
    """The profiled work ran the kernel ``kernel`` (a tensor-core prefill
    kernel, or a split-walk decode kernel) exactly ``launches`` times per
    unit of work and no f32 FMA (``*_simt``) kernel."""
    names = entry["repro_kernels"]
    calls = sum(c for k, _, c in names if f"{kernel}<" in k)
    assert calls == launches, (kernel, launches, names)
    assert not any("_simt<" in k for k, _, _ in names), names
    log(f"profile: {kernel} served the work ({calls} launches), no *_simt kernel ran")


# ---------------------------------------------------------------------------
# Dense route: page_size=0 pools, keyless and kv_reuse=False turns, the
# page-exhaustion fallback and the full-width batched server
# ---------------------------------------------------------------------------

def _dense_counters():
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    return {"flash_attention": flash_ops.flash_attention,
            "decode_attention": decode_ops.decode_attention}


def _counted(fn):
    """Run ``fn`` with K4's and K5's launch counters set to 0 just before;
    returns (its result, the counts just after)."""
    import torch

    counters = _dense_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    assert all(v > 0 for v in launches.values()), launches
    return out, launches


def dense_teacher_forced(cfg, params, ids, forced, dev, split=None):
    """Full prefill of ``ids`` into a 2048-slot cache (bucket 64), then
    ``forced`` tokens decoded one by one; every step's logits, f32. With
    ``split``, a session hit's turn: only ``ids[:split]`` is prefilled whole
    and the rest is appended in the engine's 256-token chunks."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.serving import chunked_append

    if split is None:
        logits, caches, pos = _dense_prefilled(cfg, params, ids, dev)
    else:
        _, caches, _ = _dense_prefilled(cfg, params, ids[:split], dev)
        logits, caches, pos = chunked_append(params, cfg, caches, ids[split:], split, 256, 64)
    out = [logits[0]]
    for t in forced:
        lg, caches = decode_step(params, cfg, caches,
                                 torch.tensor([[t]], dtype=torch.int32, device=dev), pos)
        pos = pos + 1
        out.append(lg[0, 0])
    return torch.stack(out).float()


def phase_dense(params, dev) -> tuple:
    import numpy as np
    import torch
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.models import decode_step, prefill_append
    from repro_torch.serving import BatchedLLMService, TorchLLMService
    from repro_torch.tokenizer import assistant_header, encode_turn

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    mk = lambda **kw: TorchLLMService.create(  # noqa: E731
        "paper-qwen1.5-0.5b", cfg, max_len=2048, device=dev, params=params, **kw)
    keyed, keyless = mk(), mk(kv_reuse=False)
    assert keyed.engine.session_pool.allocator is None     # page_size=0: a dense pool
    assert keyless.engine.session_pool is None
    tok = keyed.tokenizer
    rng = np.random.default_rng(0)

    def prompt(turn: int, n_doc: int):
        ids = encode_turn(tok, "user", f"turn {turn}: explain the attached sensor log")
        doc = rng.integers(300, cfg.vocab_size, size=n_doc).tolist()
        return ids[:-2] + doc + ids[-2:] + assistant_header(tok)

    # warm-up (cuBLAS handles at the dense shapes), not part of the counted runs
    for svc in (keyed, keyless):
        svc.completion(rng.integers(300, 5000, size=64).tolist(), prompt(0, 16), 4,
                       cache_key="warmup")
    torch.cuda.synchronize()

    # keyed: the main phase's 3 sessions x 3 turns on a dense pool
    sessions = {f"s{i}": rng.integers(300, cfg.vocab_size, size=200 + 200 * i).tolist()
                for i in range(3)}
    inputs, turns = [], []

    def serve_keyed():
        for turn in range(3):
            for key, ctx in sessions.items():
                p = prompt(turn + 1, 300)
                r = keyed.completion(ctx, p, 32, cache_key=key)
                if turn > 0:
                    assert r.cache_hit and r.reused_tokens == len(ctx), (key, turn, r.reused_tokens)
                    assert r.prefill_tokens == len(p), (key, turn, r.prefill_tokens)
                inputs.append((ctx, p))
                turns.append({"turn": turn + 1, "n_in": len(ctx) + len(p), "ttft_ms": r.ttft_ms,
                              "decode_p50_ms": r.decode_p50_ms})
                log(f"dense: {key} turn {turn + 1}: input {len(ctx) + len(p)} reused "
                    f"{r.reused_tokens} prefilled {r.prefill_tokens} ttft_ms {r.ttft_ms:.3f} "
                    f"decode_p50_ms/token {r.decode_p50_ms:.3f}")
                sessions[key] = ctx + p + r.token_ids

    _, l_keyed = _counted(serve_keyed)
    log(f"dense: keyed path kernel launches {l_keyed}")

    # kv_reuse=False: the same turns, every context prefilled whole
    keyless_ttft = []

    def serve_keyless():
        for ctx, p in inputs:
            r = keyless.completion(ctx, p, 32, cache_key="ignored")
            assert not r.cache_hit and r.prefill_tokens == len(ctx) + len(p), r.prefill_tokens
            keyless_ttft.append(r.ttft_ms)

    _, l_keyless = _counted(serve_keyless)
    log(f"dense: kv_reuse=False path: 9 turns prefilled whole (inputs "
        f"{min(len(c) + len(p) for c, p in inputs)}-{max(len(c) + len(p) for c, p in inputs)}), "
        f"ttft_ms p50 {float(np.percentile(keyless_ttft, 50)):.3f}; kernel launches {l_keyless}")
    del keyless

    # a paged engine whose 31 pages (496 tokens) cannot hold one session:
    # the keyed turn leaves the paged route once and is served dense
    small = mk(page_size=PS, kv_pages=32)
    ctx, p = inputs[4]
    r_fb, l_fallback = _counted(lambda: small.completion(ctx, p, 32, cache_key="big"))
    eng = small.engine
    assert eng.paged_fallbacks == 1 and len(r_fb.token_ids) > 0, eng.paged_fallbacks
    log(f"dense: page-exhaustion fallback: {len(ctx) + len(p)}-token turn on "
        f"{eng.session_pool.allocator.n_pages - 1} pages -> paged_fallbacks "
        f"{eng.paged_fallbacks}, pool {json.dumps(eng.session_pool.stats())}; kernel launches "
        f"{l_fallback}")
    del small, eng

    # teacher-forced: s1's last turn through the kernel path and the plain
    # path, once prefilled whole (K4 at S = T) and once as the served hit
    # (its context prefilled, its prompt appended in chunks: K4 at S <= 256
    # against the 2048-slot cache), then 32 decode steps (K5)
    hist = sessions["s1"]
    ctx, p = inputs[7]                          # s1's turn 3: its context, then its prompt
    ids, forced, split = ctx + p, hist[len(ctx) + len(p):], len(ctx)
    assert hist[: len(ids)] == ids and forced
    diff, agree = 0.0, 1.0
    for label, sp in (("whole prefill", None), ("hit append", split)):
        kern = dense_teacher_forced(cfg, params, ids, forced, dev, sp)
        plain = dense_teacher_forced(cfg.replace(attn_impl="reference"), params, ids, forced,
                                     dev, sp)
        torch.cuda.synchronize()
        assert kern.shape == plain.shape == (len(forced) + 1, cfg.vocab_size)
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        d = (kern - plain).abs().max().item()
        a = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"dense equivalence ({label}): teacher-forced turn of {len(ids)} + {len(forced)} "
            f"tokens"
            f"{'' if sp is None else f' (appended from {sp})'}: max |logit diff| kernel vs "
            f"plain {d:.4e} (bound {LOGIT_TOL}), argmax agreement {a:.3f}")
        assert d <= LOGIT_TOL, f"dense logits ({label}) differ by {d} > {LOGIT_TOL}"
        diff, agree = max(diff, d), min(agree, a)

    # profile: one dense decode step at ~1.25k tokens, one 256-token append
    n = 1248
    base_ids = hist[:n]
    _, caches, pos = _dense_prefilled(cfg, params, base_ids, dev)
    steps = forced[:8]

    # a rerun rewrites the same slots with the same values, so each run
    # works on the same caches (no copy in the traced window)
    def decode8():
        q = pos
        for t in steps:
            decode_step(params, cfg, caches, torch.tensor([[t]], dtype=torch.int32, device=dev), q)
            q = q + 1

    p0 = n - 256
    app_toks = torch.tensor([base_ids[p0:]], dtype=torch.int32, device=dev)
    trimmed = _dense_prefilled(cfg, params, base_ids[:p0], dev)[1]

    def append256():
        prefill_append(params, cfg, trimmed, app_toks, p0)

    report = {name: profile_work(name, fn, per)
              for name, fn, per in (("dense_decode_step", decode8, len(steps)),
                                    ("dense_append_256", append256, 1))}
    assert_served_by(report["dense_append_256"], "flash_attention_mma", cfg.n_layers)
    assert_served_by(report["dense_decode_step"], "decode_attention_split", cfg.n_layers)
    del caches, trimmed
    torch.cuda.empty_cache()

    # the full-width batched server: a wave of 16 tenants, then 8 second turns
    bsvc = BatchedLLMService.create(
        "paper-qwen1.5-0.5b", cfg, n_slots=N_SLOTS, max_len=2048, paged=False,
        session_cache_capacity=N_TENANTS, device=dev, params=params,
    )
    server = bsvc.server
    assert not server.paged
    brng = np.random.default_rng(12)
    system = brng.integers(300, cfg.vocab_size, size=SYSTEM_TOKENS).tolist()
    questions = [brng.integers(300, cfg.vocab_size, size=int(brng.integers(24, 73))).tolist()
                 for _ in range(N_TENANTS)]
    server.submit(brng.integers(300, 5000, size=40).tolist(), max_new=4)
    server.submit(brng.integers(300, 5000, size=40).tolist(), max_new=4)
    server.run_to_completion()
    server.finished.clear()

    def serve_batched():
        rids = [server.submit(system + qs, max_new=MAX_NEW_BATCHED, cache_key=f"tenant{i}")
                for i, qs in enumerate(questions)]
        t_wave = time.perf_counter()
        steps1 = _drive(server)
        wave_s = time.perf_counter() - t_wave
        fin = {f.request_id: f for f in server.finished}
        server.finished.clear()
        first = [fin[r] for r in rids]
        keys = list(range(0, N_TENANTS, 2))
        hist_b = {i: system + questions[i] + first[i].token_ids for i in keys}
        follow = {i: brng.integers(300, cfg.vocab_size, size=int(brng.integers(16, 41))).tolist()
                  for i in keys}
        rids2 = {i: server.submit(hist_b[i] + follow[i], max_new=MAX_NEW_BATCHED,
                                  cache_key=f"tenant{i}") for i in keys}
        steps2 = _drive(server)
        fin = {f.request_id: f for f in server.finished}
        server.finished.clear()
        for i in keys:
            f = fin[rids2[i]]
            assert f.cache_hit and f.reused_tokens == len(hist_b[i]), (i, f.reused_tokens)
        return first, wave_s, steps1 + steps2

    (first, wave_s, bsteps), l_batched = _counted(serve_batched)
    gen_tokens = sum(len(f.token_ids) for f in first)
    pure8 = [ms for ready, ms, pure in bsteps if pure and ready == N_SLOTS]
    ttfts = [f.ttft_ms for f in first]
    log(f"dense: full-width server wave of {N_TENANTS} tenants: {gen_tokens} tokens in "
        f"{wave_s:.3f} s; 8 second turns all session hits; kernel launches {l_batched}")
    hits = [t for t in turns if t["turn"] > 1]
    summary = {
        "ttft_ms_p50_hit_turns": float(np.percentile([t["ttft_ms"] for t in hits], 50)),
        "ttft_ms_p50_first_turns": float(np.percentile(
            [t["ttft_ms"] for t in turns if t["turn"] == 1], 50)),
        "ttft_ms_p50_keyless": float(np.percentile(keyless_ttft, 50)),
        "decode_ms_per_token_p50": float(np.percentile([t["decode_p50_ms"] for t in turns], 50)),
        "batched_decode_ms_per_step_b8_p50": float(np.percentile(pure8, 50)),
        "batched_decode_steps_b8": len(pure8),
        "batched_decode_tokens_per_s_b8": N_SLOTS * 1e3 / float(np.percentile(pure8, 50)),
        "batched_wave_tokens_per_s": gen_tokens / wave_s,
        "batched_ttft_ms_p50": float(np.percentile(ttfts, 50)),
        "batched_ttft_ms_p90": float(np.percentile(ttfts, 90)),
        "max_logit_diff": diff, "argmax_agreement": agree, "paged_fallbacks": 1,
        "launches": {"keyed": l_keyed, "keyless": l_keyless, "fallback": l_fallback,
                     "batched": l_batched},
        "profile": {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms", "device_idle_share")}
                    for k, v in report.items()},
    }
    log(f"dense: summary {json.dumps(summary)}")
    del bsvc, server
    torch.cuda.empty_cache()
    total = {k: sum(l[k] for l in (l_keyed, l_keyless, l_fallback, l_batched))
             for k in l_keyed}
    return summary, total


# ---------------------------------------------------------------------------
# K6 and the SSM / hybrid models (dense route only: no session reuse)
# ---------------------------------------------------------------------------

def _ssd_case(gen, B, L, H, P, N, dev, ragged=None):
    """Inputs shaped like a Mamba2 mixer's at the SSD: x and B/C after the
    conv's SiLU, dt after softplus, A = -exp(A_log) of the init's
    linspace(1, 16). ``ragged`` gives each lane's real length: rows past it
    carry a padded prompt's inputs (zero tokens' small activations)."""
    import torch
    import torch.nn.functional as F

    x = 0.5 * torch.randn(B, L, H, P, generator=gen, device=dev)
    dt = F.softplus(torch.randn(B, L, H, generator=gen, device=dev) - 1.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bv = 0.5 * torch.randn(B, L, 1, N, generator=gen, device=dev)
    Cv = 0.5 * torch.randn(B, L, 1, N, generator=gen, device=dev)
    if ragged is not None:
        for b, n in enumerate(ragged):
            for t in (x, Bv, Cv):
                t[b, n:] *= 0.01
    return x, dt, A, Bv, Cv


def _ssd_bound(B, L, H, P, N, Q):
    """Bytes every input read once and every output written once (f32);
    the TPU kernel's products per (lane, chunk, head): CB (Q x Q x N), W x
    (Q x Q x P), Bwᵀ x (Q x N x P). Returns (bytes, flops)."""
    nc = L // Q
    nbytes = 4 * (2 * B * L * H * P + 2 * B * L * H + H + 2 * B * L * N + B * nc * H * N * P)
    flops = B * nc * H * 2 * Q * (Q * N + Q * P + N * P)
    return nbytes, flops


def phase_k6(dev) -> dict:
    """K6 against its plain version (all three outputs, f32, TF32 off) at
    both models' full-width shapes and a B = 2 ragged case, the wrapper
    (kernel + chain) against the plain chunked SSD, then K6 timed at both
    shapes with inputs cycled past L2."""
    import torch
    from repro_torch.kernels.build import device_sms
    from repro_torch.kernels.ssd import ops, ref
    from repro_torch.kernels.ssd.kernel import ssd_chunk_cuda, ssd_plan
    from repro_torch.models.ssm import ssd_reference

    gen = torch.Generator(device=dev).manual_seed(6)
    Q = 128
    # (label, B, L, H, P, N, real lengths)
    cases = [("mamba2", 1, 1024, 64, 64, 128, None), ("zamba2", 1, 1024, 112, 64, 64, None),
             ("B=2 ragged", 2, 512, 64, 64, 128, (512, 300))]
    err = 0.0
    for label, B, L, H, P, N, ragged in cases:
        x, dt, A, Bv, Cv = _ssd_case(gen, B, L, H, P, N, dev, ragged)
        args = (x, dt, A, Bv[:, :, 0].contiguous(), Cv[:, :, 0].contiguous())
        got = ssd_chunk_cuda(*args, Q)
        again = ssd_chunk_cuda(*args, Q)
        want = ref.ssd_chunk_ref(*args, Q)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again)), f"K6 {label}: two runs differ"
        for name, g, w in zip(("y_intra", "states", "dA_cs"), got, want):
            assert torch.isfinite(g).all(), (label, name)
            e = (g - w).abs().max().item()
            excess = ((g - w).abs() - K6_TOL * (1 + w.abs())).max().item()
            log(f"K6 {label} {name}: max_abs_err {e:.3e}, max |ref| {w.abs().max().item():.3e} "
                f"(bound {K6_TOL} x (1 + |ref|)); two runs identical")
            assert excess <= 0, f"K6 {label} {name}: exceeds {K6_TOL} x (1 + |ref|) by {excess}"
            err = max(err, e)
        y, f = ops.ssd(x, dt, A, Bv, Cv, Q)
        wy, wf = ssd_reference(x, dt, A, Bv, Cv, Q)
        torch.cuda.synchronize()
        for name, g, w in (("ssd y", y, wy), ("ssd final state", f, wf)):
            e = ((g - w).abs() - K6_TOL * (1 + w.abs())).max().item()
            log(f"K6 {label} {name} (kernel + chain vs plain): max_abs_err "
                f"{(g - w).abs().max().item():.3e}")
            assert e <= 0, f"K6 {label} {name}: exceeds the bound by {e}"

    out = {"name": "ssd_chunk", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
           "replaces": "src/repro/kernels/ssd/kernel.py:94", "max_abs_err": err,
           "library_ms": None}
    for label, B, L, H, P, N, _ in cases[:2]:
        hg, grid = ssd_plan(B, L // Q, H, device_sms(dev))
        log(f"K6 {label}: {hg} heads per block, grid {grid} = {grid[0] * grid[1] * grid[2]} "
            f"blocks")
        sets = []
        for _ in range(6):       # each call moves ~50 MB: six sets are far past L2
            x, dt, A, Bv, Cv = _ssd_case(gen, B, L, H, P, N, dev)
            sets.append((x, dt, A, Bv[:, :, 0].contiguous(), Cv[:, :, 0].contiguous()))
        kernel_ms = device_time_ms([lambda a=a: ssd_chunk_cuda(*a, Q) for a in sets], iters=24)
        plain_ms = device_time_ms([lambda a=a: ref.ssd_chunk_ref(*a, Q) for a in sets], iters=24)
        nbytes, flops = _ssd_bound(B, L, H, P, N, Q)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / TF32_FLOPS_PER_S * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        f32_fma_ms = flops / F32_FLOPS_PER_S * 1e3
        log(f"K6 {label} shape (B {B}, L {L}, H {H}, P {P}, N {N}, Q {Q}): kernel_ms "
            f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms none bound_ms {bound_ms:.6f} "
            f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the TF32 peak; "
            f"{f32_fma_ms:.5f} ms at the f32 FMA peak)")
        stats = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     mbytes=nbytes / 1e6, gflop=flops / 1e9, f32_fma_bound_ms=f32_fma_ms)
        if label == "mamba2":
            out.update(stats)
        else:
            out.update({f"zamba2_{k}": v for k, v in stats.items()})
    return out


def _ssm_counters():
    from repro_torch.kernels.ssd import ops as ssd_ops

    return dict(_dense_counters(), ssd=ssd_ops.ssd)


def _ssm_teacher_forced(cfg, params, ids, forced, dev):
    """Unpadded prefill of ``ids`` (a chunk multiple), then ``forced``
    decoded one by one; every step's logits, f32."""
    import torch
    from repro_torch.models import decode_step, prefill

    logits, caches, pos = prefill(params, cfg, torch.tensor([ids], device=dev), len(ids) + 64)
    out = [logits[0]]
    for t in forced:
        lg, caches = decode_step(params, cfg, caches, torch.tensor([[t]], device=dev), pos)
        pos = pos + 1
        out.append(lg[0, 0])
    return torch.stack(out).float()


def phase_ssm_model(dev, cfg, per_prefill: dict, per_decode: dict) -> dict:
    """One SSM-family model at full width (bf16, random weights from seed
    0) through ``TorchLLMService`` on an engine with ``bucket=128`` (a
    multiple of the SSD chunk): 3 sessions x 2 turns of 256-1024 context
    tokens and 32 new tokens, every turn a full prefill. The kernel launches
    of that run must be ``per_prefill`` x prefills plus ``per_decode`` x
    decode steps. Then a 1024-token turn teacher-forced through the kernel
    and the plain path, prefill + 8 decode steps held to ``forward_full``
    (both bounded by SSM_LOGIT_REL x the plain logits' std), and a profiled
    1024-token prefill and 8 decode steps."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward_full, prefill
    from repro_torch.serving import InferenceEngine, TorchLLMService
    from repro_torch.tokenizer import assistant_header, encode_turn, get_tokenizer

    name = cfg.name
    cfg = cfg.replace(attn_impl="cuda")
    t0 = time.perf_counter()
    engine = InferenceEngine.create(cfg, seed=0, max_len=2048, bucket=128, device=dev)
    svc = TorchLLMService(model=name, engine=engine,
                          tokenizer=get_tokenizer(cfg.vocab_size, seed=0, name=name))
    torch.cuda.synchronize()
    params = engine.params
    assert engine.session_pool is None
    log(f"{name}: service built in {time.perf_counter() - t0:.2f} s ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, bf16 weights "
        f"{sum(p.numel() for p in _leaves(params)) * 2 / 1e9:.3f} GB)")
    tok = svc.tokenizer
    rng = np.random.default_rng(0)

    def prompt(turn: int, n_doc: int):
        ids = encode_turn(tok, "user", f"turn {turn}: summarise the attached log")
        doc = rng.integers(300, cfg.vocab_size, size=n_doc).tolist()
        return ids[:-2] + doc + ids[-2:] + assistant_header(tok)

    svc.completion(rng.integers(300, 5000, size=100).tolist(), prompt(0, 16), 4)   # warm-up
    torch.cuda.synchronize()

    sessions = {f"s{i}": rng.integers(300, cfg.vocab_size, size=256 * (i + 1)).tolist()
                for i in range(3)}
    turns, decode_steps = [], 0
    counters = _ssm_counters()
    for c in counters.values():
        c.launches = 0
    for turn in range(2):
        for key, ctx in sessions.items():
            p = prompt(turn + 1, 40)
            r = svc.completion(ctx, p, 32, cache_key=key)
            n_in = len(ctx) + len(p)
            assert not r.cache_hit and r.prefill_tokens == n_in, (key, turn, r.prefill_tokens)
            assert 0 < len(r.token_ids) <= 32, r.token_ids
            # the engine decodes whole windows of 8 before its stop scan
            decode_steps += min(32, 8 * -(-len(r.token_ids) // 8))
            turns.append({"session": key, "turn": turn + 1, "input_tokens": n_in,
                          "ttft_ms": r.ttft_ms, "decode_p50_ms": r.decode_p50_ms,
                          "inference_ms": r.inference_ms})
            log(f"{name}: {key} turn {turn + 1}: input {n_in} (bucket "
                f"{-(-n_in // 128) * 128}) ttft_ms {r.ttft_ms:.3f} decode_p50_ms/token "
                f"{r.decode_p50_ms:.3f} generated {len(r.token_ids)}")
            sessions[key] = ctx + p + r.token_ids
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    n_prefills = len(turns)
    want = {k: per_prefill.get(k, 0) * n_prefills + per_decode.get(k, 0) * decode_steps
            for k in counters}
    log(f"{name}: kernel launches {launches} over {n_prefills} prefills and {decode_steps} "
        f"decode steps (expected {want})")
    assert launches == want, (launches, want)

    # teacher-forced: a 1024-token turn (a chunk multiple: no padding) and
    # 16 forced tokens through the kernel path and the plain path
    seq = sessions["s2"]                   # its history, filled up to 1040 tokens
    seq = seq + rng.integers(300, cfg.vocab_size, size=max(0, 1040 - len(seq))).tolist()
    ids, forced = seq[:1024], seq[1024:1040]
    kern = _ssm_teacher_forced(cfg, params, ids, forced, dev)
    plain = _ssm_teacher_forced(cfg.replace(attn_impl="reference"), params, ids, forced, dev)
    torch.cuda.synchronize()
    assert kern.shape == plain.shape == (17, cfg.vocab_size), kern.shape
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    diff = (kern - plain).abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    tol = SSM_LOGIT_REL * plain.std().item()
    log(f"{name} equivalence: teacher-forced 1024 + 16 tokens: max |logit diff| kernel vs "
        f"plain {diff:.4e} (bound {tol:.4f} = {SSM_LOGIT_REL} x logit std), argmax agreement "
        f"{agree:.3f}")
    assert diff <= tol, f"{name}: logits differ by {diff} > {tol}"

    # prefill of 896 tokens + 8 decode steps vs forward_full over 1024: the
    # logits at positions 895..903 (causal: later tokens do not reach them)
    step_logits = _ssm_teacher_forced(cfg, params, ids[:896], ids[896:904], dev)[:9]
    full, _ = forward_full(params, cfg, torch.tensor([ids], device=dev))
    fdiff = (step_logits - full[0, 895:904].float()).abs().max().item()
    fagree = (step_logits.argmax(-1) == full[0, 895:904].argmax(-1)).float().mean().item()
    log(f"{name}: prefill 896 + 8 decode steps vs forward_full: max |logit diff| {fdiff:.4e} "
        f"(bound {tol:.4f}), argmax agreement {fagree:.3f}")
    assert fdiff <= tol, f"{name}: decode vs forward_full differ by {fdiff} > {tol}"
    del full

    # where the time goes: a 1024-token prefill, and 8 decode steps from it
    toks = torch.tensor([ids], device=dev)
    _, caches, pos = prefill(params, cfg, toks, 2048)

    def decode8():
        q = pos
        for t in forced[:8]:
            decode_step(params, cfg, caches, torch.tensor([[t]], device=dev), q)
            q = q + 1

    report = {f"{name}_prefill_1024": profile_work(f"{name}_prefill_1024",
                                                   lambda: prefill(params, cfg, toks, 2048), 1),
              f"{name}_decode_step": profile_work(f"{name}_decode_step", decode8, 8)}
    if "flash_attention" in per_prefill:     # Zamba2's shared attention block
        assert_served_by(report[f"{name}_prefill_1024"], "flash_attention_mma",
                         per_prefill["flash_attention"])
    summary = {
        "ttft_ms_p50": float(np.percentile([t["ttft_ms"] for t in turns], 50)),
        "ttft_ms_max": max(t["ttft_ms"] for t in turns),
        "decode_ms_per_token_p50": float(np.percentile([t["decode_p50_ms"] for t in turns], 50)),
        "inputs": [t["input_tokens"] for t in turns],
        "max_logit_diff": diff, "logit_bound": tol, "argmax_agreement": agree,
        "decode_vs_forward_full_max_logit_diff": fdiff, "launches": launches,
        "prefills": n_prefills, "decode_steps": decode_steps,
        "profile": {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms", "device_idle_share")}
                    for k, v in report.items()},
    }
    log(f"{name}: summary {json.dumps(summary)}")
    del svc, engine, params, caches
    torch.cuda.empty_cache()
    return summary


def phase_ssm_f32(dev, cfg, n_layers: int) -> dict:
    """One SSM-family model at full width in f32 (weights from seed 0 in
    f32, TF32 off), depth cut to ``n_layers``: a 1024-token prompt and 16
    forced tokens teacher-forced through the kernel path (K6; Zamba2's
    shared attention block through the f32 K4/K5) and the plain path; max
    |logit diff| <= SSM_F32_REL x the std of the plain logits. bf16 noise
    (the serving checks' 0.6 x std) cannot hide a K6 fault here."""
    import numpy as np
    import torch
    from repro_torch.models import init_params

    name, full = f"{cfg.name} f32", cfg.n_layers
    cfg = cfg.replace(n_layers=n_layers, param_dtype="float32", compute_dtype="float32",
                      attn_impl="cuda")
    params = init_params(cfg, seed=0, device=dev)
    seq = np.random.default_rng(1).integers(300, cfg.vocab_size, size=1040).tolist()
    ids, forced = seq[:1024], seq[1024:]
    counters = _ssm_counters()
    for c in counters.values():
        c.launches = 0
    kern = _ssm_teacher_forced(cfg, params, ids, forced, dev)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    plain = _ssm_teacher_forced(cfg.replace(attn_impl="reference"), params, ids, forced, dev)
    torch.cuda.synchronize()
    assert kern.shape == plain.shape == (17, cfg.vocab_size), kern.shape
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    assert launches["ssd"] == n_layers, launches
    diff = (kern - plain).abs().max().item()
    std = plain.std().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{name}: {n_layers} of {full} layers, teacher-forced 1024 + 16 tokens: max |logit diff| kernel vs plain {diff:.4e} = "
        f"{diff / std:.3e} x logit std {std:.4f} (bound {SSM_F32_REL} x std), argmax "
        f"agreement {agree:.3f}; launches {launches}")
    assert diff <= SSM_F32_REL * std, f"{name}: logits differ by {diff} > {SSM_F32_REL} x {std}"
    del params
    torch.cuda.empty_cache()
    return {"layers": n_layers, "max_logit_diff": diff, "logit_std": std,
            "bound": SSM_F32_REL * std, "argmax_agreement": agree, "launches": launches}


def _dense_prefilled(cfg, params, ids, dev):
    """Full prefill of ``ids`` into a fresh 2048-slot cache (bucket 64, as
    the engine's)."""
    from repro_torch.serving import bucketed_prefill

    return bucketed_prefill(params, cfg, ids, 2048, 64, dev)


def phase_equivalence(svc, last_turn, dev) -> float:
    import torch

    cfg = svc.engine.cfg
    hist, forced = last_turn["s1"]
    ids = hist[: len(hist) - len(forced)]
    kern = teacher_forced_logits(cfg, svc.engine.params, ids, forced, dev)
    plain = teacher_forced_logits(cfg.replace(attn_impl="reference"), svc.engine.params,
                                  ids, forced, dev)
    torch.cuda.synchronize()
    assert kern.shape == plain.shape == (len(forced) + 1, cfg.vocab_size), kern.shape
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    diff = (kern - plain).abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # the served run computed this history's K/V in other GEMM shapes (its
    # earlier answers by decode steps, here by prefill chunks), and the
    # random-weight model has near-tie logits that such bf16 differences
    # flip: require three quarters, the rest is reported
    served = (kern[:-1].argmax(-1).cpu() == torch.tensor(forced)).float().mean().item()
    log(f"equivalence: teacher-forced turn of {len(ids)} + {len(forced)} tokens: max |logit "
        f"diff| kernel vs plain {diff:.4e} (bound {LOGIT_TOL}), argmax agreement {agree:.3f}, "
        f"served tokens reproduced {served:.3f}")
    assert diff <= LOGIT_TOL, f"logits differ by {diff} > {LOGIT_TOL}"
    assert served >= 0.75, f"kernel path reproduces only {served:.3f} of the served tokens"
    return diff


# ---------------------------------------------------------------------------
# The DisCEdge system: context manager, replicated store, edge nodes and a
# roaming client serving the paper's 9-turn scenario on the card
# ---------------------------------------------------------------------------

# The paper's scenario (Appendix A.1; examples/serve_mobile_client.py): nine
# robotics prompts, the client switching nodes at turns 3, 5 and 7.
DISCEDGE_PROMPTS = [
    "What are the fundamental components of an autonomous mobile robot?",
    "You mentioned sensors. What are the most common types for obstacle avoidance?",
    "Can you explain the concept of a PID controller in the context of motor control?",
    "Write a simple Python function for a proportional (P) controller.",
    "In your previous code, what do the kp and error variables represent?",
    "How would you modify that function to include the integral (I) component?",
    "Now, let's talk about localization. What is SLAM?",
    "What are some of the main challenges when implementing that on a small, low-power robot?",
    "Can you compare the EKF SLAM and Particle Filter SLAM approaches?",
]
DISCEDGE_NODES = ["m2", "m2", "tx2", "tx2", "m2", "m2", "tx2", "tx2", "m2"]
DISCEDGE_MAX_NEW, DISCEDGE_THINK_MS = 16, 1500.0
# With session KV reuse every turn after the first reuses the whole stored
# context, and only turn 3, the session's first arrival on tx2, is a warm
# start: on turns 5, 7 and 9 the node's own entry from its earlier turns was
# extended by the replicated writes, which keeps its provenance. JAX's
# cluster marks the turns so (tests/test_torch_discedge_model.py holds it to
# this constant on the CPU).
DISCEDGE_WARM_TURN = 3
# (run, context mode, service route, kv_ship_force)
DISCEDGE_RUNS = (
    ("a", "tokenized", "paged", None),
    ("b", "raw", "paged", None),
    ("c", "client_side", "paged", None),
    ("d", "tokenized", "kv_reuse=False", None),
    ("e", "tokenized", "paged", "ship"),
)


def phase_discedge(dev) -> dict:
    """The port's DisCEdge system end to end on the full-width paper model:
    two edge nodes m2 and tx2 (the example's links: inter-node 2 ms /
    100 Mbit/s, client 5 ms / 20 Mbit/s), each with its own TorchLLMService
    (its own session pool and page allocator) over one shared copy of the
    bf16 weights, serve the paper's 9-turn roaming scenario through the
    port's EdgeCluster and LLMClient, 16 new tokens a turn and 1500 ms of
    think time between turns. Five runs: TOKENIZED, RAW and CLIENT_SIDE on
    the paged route (K3 + K1), TOKENIZED with ``kv_reuse=False`` on the
    dense route (K4 + K5), and TOKENIZED with KV pages shipped m2 -> tx2.
    Every turn must answer, every kernel of the run's route launch at least
    once per layer on every turn (the other route's none), the replicas
    converge; in the reuse runs every turn after the first is a session
    hit over its whole context and turn 3 a warm start ("tokens", or
    "pages" when shipped). Returns per-run metrics and the paper's two
    comparisons, computed as the example computes them."""
    from statistics import median as _median

    import torch
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.core import ContextMode
    from repro_torch.edge import EdgeCluster, LLMClient
    from repro_torch.models import init_params
    from repro_torch.serving import TorchLLMService
    from repro_torch.store import Link

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    model = cfg.name
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    # warm-up (cuBLAS handles, allocator) on a throwaway service, not counted
    TorchLLMService.create(model, cfg, max_len=2048, page_size=PS, kv_pages=64, device=dev,
                           params=params).completion(list(range(300, 364)), [300], 4,
                                                     cache_key="warmup")
    torch.cuda.synchronize()
    log(f"discedge: weights and warm-up {time.perf_counter() - t0:.2f} s")
    counters = dict(_counters(), **_dense_counters())
    route_kernels = {"paged": ("chunked_prefill", "paged_attention"),
                     "kv_reuse=False": ("flash_attention", "decode_attention")}
    ship_ms_per_token = 0.0
    runs, texts = {}, {}
    for run, mode, route, force in DISCEDGE_RUNS:
        def factory(nid, route=route, force=force):
            if route == "paged":
                svc = TorchLLMService.create(model, cfg, max_len=2048, page_size=PS,
                                             kv_pages=512, device=dev, params=params)
            else:
                svc = TorchLLMService.create(model, cfg, max_len=2048, kv_reuse=False,
                                             device=dev, params=params)
            if force is not None:
                svc.ship_prefill_ms_per_token = ship_ms_per_token
            return svc

        kw = dict(kv_ship=True, kv_ship_force=force) if force is not None else {}
        cluster = EdgeCluster.build(
            ["m2", "tx2"], factory,
            inter_node_link=Link(latency_ms=2.0, bandwidth_mbps=100.0),
            client_link=Link(latency_ms=5.0, bandwidth_mbps=20.0), **kw)
        client = LLMClient(cluster, model=model, mode=ContextMode(mode),
                           max_new_tokens=DISCEDGE_MAX_NEW)
        t_run = time.perf_counter()
        for c in counters.values():
            c.launches = 0
        responses, per_turn = [], []
        for i, (prompt, node) in enumerate(zip(DISCEDGE_PROMPTS, DISCEDGE_NODES)):
            before = {k: c.launches for k, c in counters.items()}
            r = client.chat(prompt, node)
            assert r.error is None, (run, i + 1, r.error)
            per_turn.append({k: c.launches - before[k] for k, c in counters.items()})
            responses.append(r)
            client.think(DISCEDGE_THINK_MS)
        cluster.converge()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_run
        launches = {k: c.launches for k, c in counters.items()}
        services = [n.service for n in cluster.nodes.values()]
        fallbacks = sum(s.engine.paged_fallbacks for s in services)
        assert fallbacks == 0, (run, fallbacks)
        assert cluster.converged() and cluster.store.replicas_converged(model), run
        want = route_kernels[route]
        for i, n in enumerate(per_turn):
            for k in want:
                assert n[k] >= cfg.n_layers, (run, i + 1, k, n)
        for k, v in launches.items():
            if k not in want:
                assert v == 0, (run, k, launches)
        hits = [r.timing.kv_cache_hit for r in responses]
        warm = [r.timing.kv_warm_source if r.timing.kv_warm_start else "none"
                for r in responses]
        if run in ("a", "e"):
            source = "pages" if force == "ship" else "tokens"
            for i, r in enumerate(responses[1:], start=2):
                assert r.timing.kv_cache_hit, (run, i)
                assert r.timing.kv_reused_tokens == r.n_context_tokens > 0, (
                    run, i, r.timing.kv_reused_tokens, r.n_context_tokens)
            assert warm == ["none"] * (DISCEDGE_WARM_TURN - 1) + [source] + ["none"] * (
                len(responses) - DISCEDGE_WARM_TURN), (run, warm)
        if route != "paged":
            assert not any(hits), (run, hits)
        ship = cluster.kv_ship_stats()
        if force == "ship":
            assert ship["installed"] > 0 and ship["fallbacks"] == 0, (run, ship)
            assert ship["node_fallbacks"] == 0, (run, ship)
        rts = [r.timing.response_time_ms for r in responses]
        texts[run] = [r.text for r in responses]
        runs[run] = {
            "mode": mode, "route": route, "kv_ship_force": force,
            "rt_median_ms": _median(rts), "rt_ms": rts,
            "inference_ms_median": _median([r.timing.inference_ms for r in responses]),
            "ttft_ms_median": _median([r.timing.ttft_ms for r in responses]),
            "tokenize_ms_median": _median([r.timing.tokenize_ms for r in responses]),
            "decode_ms_per_token_p50": _median([r.timing.decode_p50_ms for r in responses]),
            "sync_bytes": cluster.sync_bytes(),
            "request_bytes_median": _median(client.request_bytes_log),
            "client_bytes_up": cluster.client_bytes_up(),
            "context_tokens": [r.n_context_tokens for r in responses],
            "generated_tokens": [r.n_generated_tokens for r in responses],
            "prefill_tokens": [r.timing.prefill_tokens for r in responses],
            "hits": sum(hits), "warm_starts": cluster.warm_starts(), "warm": warm,
            "launches": launches, "kv_ship": ship, "wall_s": wall_s,
        }
        log(f"discedge: run {run} ({mode}, {route}{', ship' if force else ''}) in "
            f"{wall_s:.2f} s: rt median {runs[run]['rt_median_ms']:.2f} ms, inference "
            f"median {runs[run]['inference_ms_median']:.2f} ms, ttft median "
            f"{runs[run]['ttft_ms_median']:.2f} ms, sync {runs[run]['sync_bytes']} B, "
            f"request median {runs[run]['request_bytes_median']} B, hits {sum(hits)}, "
            f"warm {warm}, launches {launches}"
            + (f", kv_ship installed {ship['installed']} pages {ship['installed_pages']}"
               if ship else ""))
        log(f"discedge: run {run} per-turn rt_ms {[round(x, 3) for x in rts]}")
        if run == "a":
            # this card's measured prefill cost, for run e's ship cost model
            ship_ms_per_token = _median([r.timing.ttft_ms / max(1, r.timing.prefill_tokens)
                                         for r in responses])
        del cluster, client, services
        torch.cuda.empty_cache()
    # same weights, same prompts: does each run generate run a's text turn by
    # turn? Reported, not required: bf16 near-ties can flip a token, and a
    # flip changes every later turn's context
    for run in runs:
        runs[run]["text_equal_a"] = [t == ta for t, ta in zip(texts[run], texts["a"])]
    log("discedge: per-turn text equal to run a: " + ", ".join(
        f"{run} {sum(r['text_equal_a'])}/{len(r['text_equal_a'])}" for run, r in runs.items()))
    launcher = _discedge_launcher(counters, dev)
    # reductions in percent, as examples/serve_mobile_client.py computes them
    tok, raw, cs = runs["a"], runs["b"], runs["c"]
    compare = {
        "tokenized_vs_raw_rt_pct": (1 - tok["rt_median_ms"] / raw["rt_median_ms"]) * 100,
        "tokenized_vs_raw_sync_pct": (1 - tok["sync_bytes"] / raw["sync_bytes"]) * 100,
        "edge_vs_client_side_rt_pct": (1 - tok["rt_median_ms"] / cs["rt_median_ms"]) * 100,
        "edge_vs_client_side_req_pct": (1 - tok["request_bytes_median"]
                                        / cs["request_bytes_median"]) * 100,
    }
    log(f"discedge: tokenized vs raw: RT {-compare['tokenized_vs_raw_rt_pct']:+.2f}%  sync "
        f"{-compare['tokenized_vs_raw_sync_pct']:+.1f}%   (the paper's testbed: -14.46% / -15%)")
    log(f"discedge: edge vs client-side: RT {-compare['edge_vs_client_side_rt_pct']:+.2f}%  req "
        f"{-compare['edge_vs_client_side_req_pct']:+.1f}%   (the paper's testbed: -5.93% / -90%)")
    del params
    torch.cuda.empty_cache()
    return {"runs": runs, "compare": compare, "ship_prefill_ms_per_token": ship_ms_per_token,
            "launcher": launcher}


def _discedge_launcher(counters, dev) -> dict:
    """``python -m repro_torch.launch.serve --arch paper-qwen1.5-0.5b --roam``
    as a user calls it (no ``--device``: the card; a CPU rehearsal passes
    ``--device cpu``): two nodes serve 4 turns
    of the reduced paper model on the default dense session route, whose
    kernels K4 and K5 must each launch at least once per layer per turn and
    the paged ones not at all."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    arch, turns = "paper-qwen1.5-0.5b", 4
    n_layers = get_config(arch).reduced().n_layers
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--turns", str(turns), "--roam"]
                   + ([] if dev.type == "cuda" else ["--device", dev.type]))
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for line in out.getvalue().splitlines():
        log(f"discedge launcher: {line}")
    for k in ("flash_attention", "decode_attention"):
        assert launches[k] >= turns * n_layers, (k, launches)
    for k in ("chunked_prefill", "paged_attention", "shared_prefix"):
        assert launches[k] == 0, (k, launches)
    rows = [ln for ln in out.getvalue().splitlines()[1:] if ln.strip()]
    assert len(rows) == turns + 1 and rows[-1].startswith("sync="), rows
    log(f"discedge launcher: {wall_s:.2f} s, launches {launches}")
    return {"turns": turns, "launches": launches, "wall_s": wall_s, "last_line": rows[-1]}


# ---------------------------------------------------------------------------
# Qwen2-0.5B and granite-moe-3b-a800m at full width: the paged and dense
# routes at GQA groups 7 and 3, MoE serving, the batched server with K2
# ---------------------------------------------------------------------------

QWEN2_LOGIT_TOL = LOGIT_TOL  # qwen2-0.5b, kernel vs plain logits of a teacher-forced
                             # turn: the paper model's bound (the same depth, 24 bf16
                             # layers, d_head 64, tied embeddings of the same scale);
                             # set before the first run on the card
GRANITE_PINNED_REL = 0.3     # granite-moe in bf16, kernel vs plain logits of a
                             # teacher-forced turn with the kernel path routed as the
                             # plain path routed (so only the attention kernels
                             # differ): max |diff| <= 0.3 x the plain logits' std (32
                             # bf16 layers; the paper model's 24 stay near 0.1 x std).
                             # Set before the first run on the card
GRANITE_F32_REL = 1e-3       # granite-moe in f32 (TF32 off), its first 4 layers, free
                             # routing: max |diff| <= 1e-3 x std, as SSM_F32_REL; a
                             # routing flip needs two experts within ~1e-6 of each other


def _decode_steps(n_tokens: int, max_new: int, sync_every: int = 8) -> int:
    """Decode steps the engine runs for a turn that returned ``n_tokens``:
    whole windows of ``sync_every`` before each stop scan, at most
    ``max_new`` (the last window's steps past a stop are discarded)."""
    return min(max_new, sync_every * -(-n_tokens // sync_every))


def _serve_sessions(svc, name, contexts, n_turns, n_doc, max_new, rng, route):
    """``n_turns`` turns of each session in ``contexts`` through ``svc``
    (a TorchLLMService of ``route`` "paged" or "dense"), every turn after
    the first a session hit prefilling only its prompt; returns (per-turn
    records, the launches those turns must have made per layer, last turn
    per session: (history, answer))."""
    from repro_torch.tokenizer import assistant_header, encode_turn

    tok, eng = svc.tokenizer, svc.engine
    chunk = eng.append_chunk
    per_layer = {"prefill": 0, "decode": 0}
    turns, last = [], {}
    for turn in range(n_turns):
        for key, ctx in contexts.items():
            ids = encode_turn(tok, "user", f"turn {turn + 1}: explain the attached sensor log")
            doc = rng.integers(300, eng.cfg.vocab_size, size=n_doc).tolist()
            p = ids[:-2] + doc + ids[-2:] + assistant_header(tok)
            r = svc.completion(ctx, p, max_new, cache_key=key)
            n_in = len(ctx) + len(p)
            assert 0 < len(r.token_ids) <= max_new, r.token_ids
            if turn > 0:
                assert r.cache_hit and r.reused_tokens == len(ctx), (key, turn, r.reused_tokens)
                assert r.prefill_tokens == len(p), (key, turn, r.prefill_tokens)
            if route == "paged" or r.reused_tokens:
                per_layer["prefill"] += -(-(n_in - r.reused_tokens) // chunk)
            else:
                per_layer["prefill"] += 1            # one bucketed full prefill
            per_layer["decode"] += _decode_steps(len(r.token_ids), max_new)
            turns.append({"session": key, "turn": turn + 1, "input_tokens": n_in,
                          "reused": r.reused_tokens, "ttft_ms": r.ttft_ms,
                          "decode_p50_ms": r.decode_p50_ms, "generated": len(r.token_ids)})
            log(f"{name} {route}: {key} turn {turn + 1}: input {n_in} reused {r.reused_tokens} "
                f"ttft_ms {r.ttft_ms:.3f} decode_p50_ms/token {r.decode_p50_ms:.3f} "
                f"generated {len(r.token_ids)}")
            contexts[key] = ctx + p + r.token_ids
            last[key] = (contexts[key], r.token_ids)
    return turns, per_layer, last


def _route_launches(svc, name, route, contexts, n_turns, n_doc, rng, max_new=32) -> dict:
    """Serve the sessions with every kernel counter at 0 just before, and
    hold the counts just after to the route's exact launches: K3 per layer
    per prefill chunk and K1 per layer per decode step (paged), K4 per
    layer per full prefill or append chunk and K5 per layer per decode
    step (dense), no other kernel."""
    import numpy as np
    import torch

    counters = dict(_counters(), **_dense_counters())
    for c in counters.values():
        c.launches = 0
    turns, per_layer, last = _serve_sessions(svc, name, contexts, n_turns, n_doc, max_new,
                                             rng, route)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    L = svc.engine.cfg.n_layers
    pre, dec = (("chunked_prefill", "paged_attention") if route == "paged"
                else ("flash_attention", "decode_attention"))
    want = {k: 0 for k in counters}
    want[pre], want[dec] = L * per_layer["prefill"], L * per_layer["decode"]
    log(f"{name} {route}: kernel launches {launches} (expected {want})")
    assert launches == want, (name, route, launches, want)
    return {"launches": launches, "last": last,
            "ttft_ms_p50": float(np.percentile([t["ttft_ms"] for t in turns], 50)),
            "decode_ms_per_token_p50": float(np.percentile([t["decode_p50_ms"] for t in turns],
                                                           50)),
            "inputs": [t["input_tokens"] for t in turns]}


def phase_qwen2(dev) -> dict:
    """Full-width qwen2-0.5b (random bf16 weights from seed 0; GQA 14/2:
    G = 7): 2 sessions x 2 turns on the paged route (K3 + K1) and on the
    dense route (K4 + K5), each with exact launch counts; then session s1's
    last turn teacher-forced through the kernel and plain paths (paged),
    max |logit diff| <= QWEN2_LOGIT_TOL. The model is freed after."""
    import numpy as np
    import torch
    from repro_torch.configs import QWEN2_0_5B
    from repro_torch.models import init_params
    from repro_torch.serving import TorchLLMService

    cfg = QWEN2_0_5B.replace(attn_impl="cuda")
    name = cfg.name
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    mk = lambda **kw: TorchLLMService.create(name, cfg, max_len=2048, device=dev,  # noqa: E731
                                             params=params, **kw)
    services = {"paged": mk(page_size=PS, kv_pages=512), "dense": mk()}
    rng = np.random.default_rng(7)
    for svc in services.values():          # warm-up, not counted
        svc.completion(rng.integers(300, 5000, size=64).tolist(), [300, 301], 4,
                       cache_key="warmup")
    torch.cuda.synchronize()
    log(f"{name}: weights and services {time.perf_counter() - t0:.2f} s ({cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.d_head}, bf16 weights "
        f"{sum(p.numel() for p in _leaves(params)) * 2 / 1e9:.3f} GB)")
    out = {}
    for route, svc in services.items():
        contexts = {f"s{i}": rng.integers(300, cfg.vocab_size, size=300 + 400 * i).tolist()
                    for i in range(2)}
        out[route] = _route_launches(svc, name, route, contexts, 2, 200, rng)
    hist, forced = out["paged"].pop("last")["s1"]
    out["dense"].pop("last")
    ids = hist[: len(hist) - len(forced)]
    kern = teacher_forced_logits(cfg, params, ids, forced, dev)
    plain = teacher_forced_logits(cfg.replace(attn_impl="reference"), params, ids, forced, dev)
    torch.cuda.synchronize()
    assert kern.shape == plain.shape == (len(forced) + 1, cfg.vocab_size)
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    diff = (kern - plain).abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{name} equivalence: teacher-forced turn of {len(ids)} + {len(forced)} tokens: max "
        f"|logit diff| kernel vs plain {diff:.4e} (bound {QWEN2_LOGIT_TOL}; logit std "
        f"{plain.std().item():.4f}), argmax agreement {agree:.3f}")
    assert diff <= QWEN2_LOGIT_TOL, f"{name}: logits differ by {diff} > {QWEN2_LOGIT_TOL}"
    out.update(max_logit_diff=diff, logit_std=plain.std().item(), argmax_agreement=agree)
    log(f"{name}: summary {json.dumps(out)}")
    del services, params, kern, plain
    torch.cuda.empty_cache()
    return out


class _RouteLog:
    """Within the block, every ``moe._route`` call records its expert
    choices (``mode="record"``), or takes the choices recorded before, call
    for call, with its own probabilities renormalised over them
    (``mode="replay"``): a path routed as another path routed."""

    def __init__(self, mode, calls=None):
        self.mode, self.calls = mode, [] if calls is None else calls
        self.i = 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.real = real = moe._route

        def route(p, xf, cfg):
            top_idx, top_w, aux = real(p, xf, cfg)
            if self.mode == "record":
                self.calls.append(top_idx.clone())
            else:
                top_idx = self.calls[self.i]
                probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
                vals = probs.gather(1, top_idx)
                top_w = vals / vals.sum(dim=-1, keepdim=True)
            self.i += 1
            return top_idx, top_w, aux

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self.real


def _routing_flips(a, b) -> tuple:
    """(rows whose set of chosen experts differs, rows compared) between two
    recorded runs of the same calls."""
    import torch

    assert len(a) == len(b), (len(a), len(b))
    flips = sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values).any(-1).sum())
                for x, y in zip(a, b))
    return flips, sum(x.shape[0] for x in a)


def phase_granite(dev) -> dict:
    """Full-width granite-moe-3b-a800m (32 layers, 40 experts top-8, GQA
    24/8: G = 3; random bf16 weights from seed 0, nothing cut): 3 sessions
    x 2 turns on the paged route with exact K3/K1 launch counts; a
    ``BatchedLLMService(paged=True)`` wave of 8 tenants sharing a
    512-token system prompt (K1, K2 and K3 launched, the prompt shared);
    session s1's last turn teacher-forced through the kernel and plain
    paths in bf16, free (routing flips counted, reported) and routed as
    the plain path routed (bounded by GRANITE_PINNED_REL x std); the same
    in f32 with TF32 off over the first 4 layers, free routing, bounded by
    GRANITE_F32_REL x std; a profiled decode step. The model is freed
    after."""
    import numpy as np
    import torch
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedLLMService, TorchLLMService

    cfg = GRANITE_MOE_3B_A800M.replace(attn_impl="cuda")
    name = cfg.name
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    svc = TorchLLMService.create(name, cfg, max_len=2048, page_size=PS, kv_pages=512,
                                 device=dev, params=params)
    rng = np.random.default_rng(8)
    svc.completion(rng.integers(300, 5000, size=64).tolist(), [300, 301], 4,
                   cache_key="warmup")
    torch.cuda.synchronize()
    log(f"{name}: weights and service {time.perf_counter() - t0:.2f} s ({cfg.n_layers} "
        f"layers, {cfg.n_experts} experts top-{cfg.top_k}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"x {cfg.d_head}, bf16 weights {sum(p.numel() for p in _leaves(params)) * 2 / 1e9:.3f} "
        f"GB)")
    contexts = {f"s{i}": rng.integers(300, cfg.vocab_size, size=256 * (i + 1)).tolist()
                for i in range(3)}
    out = {"paged": _route_launches(svc, name, "paged", contexts, 2, 100, rng)}
    hist, forced = out["paged"].pop("last")["s1"]
    ids = hist[: len(hist) - len(forced)]

    # teacher-forced, bf16: free routing (flips counted), then the kernel
    # path routed as the plain path routed
    plain_cfg = cfg.replace(attn_impl="reference")
    with _RouteLog("record") as rp:
        plain = teacher_forced_logits(plain_cfg, params, ids, forced, dev)
    with _RouteLog("record") as rk:
        free = teacher_forced_logits(cfg, params, ids, forced, dev)
    with _RouteLog("replay", rp.calls):
        pinned = teacher_forced_logits(cfg, params, ids, forced, dev)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (plain, free, pinned))
    flips, rows = _routing_flips(rp.calls, rk.calls)
    std = plain.std().item()
    d_free = (free - plain).abs().max().item()
    d_pin = (pinned - plain).abs().max().item()
    a_free = (free.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{name} equivalence (bf16): teacher-forced turn of {len(ids)} + {len(forced)} tokens; "
        f"logit std {std:.4f}; free routing: {flips} routing flips in {rows} (row, layer) "
        f"choices, max |logit diff| {d_free:.4e} ({d_free / std:.3f} x std), argmax agreement "
        f"{a_free:.3f} (reported); routed as the plain path: max |logit diff| {d_pin:.4e} = "
        f"{d_pin / std:.3f} x std (bound {GRANITE_PINNED_REL} x std)")
    assert d_pin <= GRANITE_PINNED_REL * std, (name, d_pin, std)
    out["bf16"] = {"logit_std": std, "free_max_logit_diff": d_free, "routing_flips": flips,
                   "routing_rows": rows, "free_argmax_agreement": a_free,
                   "pinned_max_logit_diff": d_pin, "pinned_bound": GRANITE_PINNED_REL * std}

    # a profiled decode step (8 steps from s1's last context)
    alloc, _, table, kv_pos, _ = _prefilled(cfg, params, ids, len(forced), dev)
    steps = forced[:8]
    out["profile"] = profile_work(
        f"{name}_decode_step",
        lambda: _decode_forced(cfg, params, alloc, table, kv_pos, len(ids), steps, dev),
        len(steps))
    assert_served_by(out["profile"], "paged_attention_split", cfg.n_layers)
    del alloc, table, kv_pos

    # the batched server: 8 tenants sharing a 512-token system prompt
    bsvc = BatchedLLMService.create(name, cfg, n_slots=8, max_len=2048, paged=True,
                                    page_size=PS, kv_pages=1024, prefill_chunk_tokens=256,
                                    device=dev, params=params)
    server = bsvc.server
    server.submit(rng.integers(300, 5000, size=40).tolist(), max_new=4)   # warm-up
    server.run_to_completion()
    server.finished.clear()
    system = rng.integers(300, cfg.vocab_size, size=512).tolist()
    questions = [rng.integers(300, cfg.vocab_size, size=int(rng.integers(24, 73))).tolist()
                 for _ in range(8)]
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    hits0 = server.session_pool.shared_hits
    rids = [server.submit(system + q, max_new=16, cache_key=f"tenant{i}")
            for i, q in enumerate(questions)]
    t_wave = time.perf_counter()
    steps_b = _drive(server)
    wave_s = time.perf_counter() - t_wave
    fin = {f.request_id: f for f in server.finished}
    server.finished.clear()
    launches = {k: c.launches for k, c in counters.items()}
    gen_tokens = sum(len(fin[r].token_ids) for r in rids)
    shared = server.session_pool.shared_hits - hits0
    log(f"{name} batched: wave of 8 tenants (512-token shared prompt + 24-72 tokens, 16 new): "
        f"{gen_tokens} tokens in {wave_s:.3f} s over {len(steps_b)} steps, shared hits "
        f"{shared}; kernel launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    assert shared >= 7, shared
    pure8 = [ms for ready, ms, pure in steps_b if pure and ready == 8]
    out["batched"] = {"launches": launches, "shared_hits": shared,
                      "wave_tokens_per_s": gen_tokens / wave_s,
                      "decode_ms_per_step_b8_p50": float(np.percentile(pure8, 50))
                      if pure8 else "not measured"}
    del bsvc, server, svc, params, plain, free, pinned
    torch.cuda.empty_cache()

    # f32, TF32 off, the first 4 layers: free routing
    f32 = cfg.replace(n_layers=4, param_dtype="float32", compute_dtype="float32")
    p32 = init_params(f32, seed=0, device=dev)
    seq = np.random.default_rng(1).integers(300, cfg.vocab_size, size=272).tolist()
    ids32, forced32 = seq[:256], seq[256:]
    with _RouteLog("record") as rk:
        kern = teacher_forced_logits(f32, p32, ids32, forced32, dev)
    with _RouteLog("record") as rp:
        plain = teacher_forced_logits(f32.replace(attn_impl="reference"), p32, ids32, forced32,
                                      dev)
    torch.cuda.synchronize()
    flips, rows = _routing_flips(rp.calls, rk.calls)
    std = plain.std().item()
    diff = (kern - plain).abs().max().item()
    log(f"{name} f32 (4 of {cfg.n_layers} layers, TF32 off): teacher-forced 256 + 16 tokens: "
        f"{flips} routing flips in {rows}; max |logit diff| kernel vs plain {diff:.4e} = "
        f"{diff / std:.3e} x logit std {std:.4f} (bound {GRANITE_F32_REL} x std)")
    assert diff <= GRANITE_F32_REL * std, (name, diff, std)
    out["f32"] = {"layers": 4, "max_logit_diff": diff, "logit_std": std,
                  "bound": GRANITE_F32_REL * std, "routing_flips": flips, "routing_rows": rows}
    log(f"{name}: summary {json.dumps(out)}")
    del p32, kern, plain
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The fleet layer: residency routing, admission control and adaptive
# mounting over four nodes of the full-width paper model
# ---------------------------------------------------------------------------

FLEET_NODES = ("edge-0", "edge-1", "edge-2", "edge-3")
# 12 clients opening with one shared prompt family, arriving at ~8 sessions/s
# (so a node gets hi = 3 turns in flight and flips to its batched mount), up
# to 3 turns each with ~0.3 s of think time (so the tail's concurrency sinks
# and nodes flip back)
FLEET_SPEC = dict(n_clients=12, seed=3, arrival_rate_per_s=8.0, max_turns=3,
                  think_ms_mean=300.0, n_families=1)
FLEET_ADMISSION = 6                     # a node sheds its 7th turn in flight
FLEET_CHURN = ("edge-1", 4000.0, 9000.0)   # crash at 4 s of the scenario, restart at 9 s
FLEET_MIN_EQUAL = 3                     # batched-mount turns that must equal a fresh
                                        # single-stream service's tokens
FLEET_MAX_REPLAYS = 12                  # batched-mount turns replayed at most to find them


def phase_fleet(dev) -> dict:
    """The port's fleet layer on the card: the paper model at full width
    (one params dict) on a 4-node ``EdgeCluster.build(router="residency",
    admission_limit=FLEET_ADMISSION)``, each node an ``AdaptiveLLMService``
    over its own paged ``TorchLLMService`` and ``BatchedLLMService(paged=
    True)``, driven by ``run_fleet`` on ``generate_workload(FLEET_SPEC)``
    with one crash and restart (``FLEET_CHURN``). Every kernel launch is
    attributed to the mount (or the warm-start prime) that made it.
    Requires: no hung ticket, a flip up and a flip down, turns served on
    both mounts, K1, K2 and K3 launched, and at least FLEET_MIN_EQUAL
    batched-mount turns whose tokens equal a fresh single-stream kernel
    service's on the same context — a turn that differs must differ at a
    bf16 near-tie (the logit gap at its first differing step under
    LOGIT_TOL)."""
    import torch
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.edge import EdgeCluster
    from repro_torch.fleet import (
        AdaptiveLLMService,
        ChurnEvent,
        WorkloadSpec,
        generate_workload,
        run_fleet,
    )
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedLLMService, TorchLLMService
    from repro_torch.store import Link

    cfg = PAPER_QWEN15_0_5B.replace(attn_impl="cuda")
    model = cfg.name
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    TorchLLMService.create(model, cfg, max_len=2048, page_size=PS, kv_pages=64, device=dev,
                           params=params).completion(list(range(300, 364)), [300], 4,
                                                     cache_key="warmup")
    torch.cuda.synchronize()
    counters = dict(_counters(), **_dense_counters())
    zero = lambda: dict.fromkeys(counters, 0)  # noqa: E731
    mounts = {n: {"single": zero(), "batched": zero(), "prime": zero()} for n in FLEET_NODES}
    served = {n: {"single": 0, "batched": 0} for n in FLEET_NODES}
    flips = {n: [] for n in FLEET_NODES}
    batched_turns = []

    def attributed(nid, bucket, fn):
        def run(*a, **k):
            before = {name: c.launches for name, c in counters.items()}
            out = fn(*a, **k)
            for name, c in counters.items():
                mounts[nid][bucket][name] += c.launches - before[name]
            return out
        return run

    def factory(nid):
        single = TorchLLMService.create(model, cfg, max_len=2048, page_size=PS, kv_pages=512,
                                        session_cache_capacity=16, device=dev, params=params)
        batched = BatchedLLMService.create(model, cfg, n_slots=8, max_len=2048, paged=True,
                                           page_size=PS, kv_pages=768,
                                           session_cache_capacity=16,
                                           prefill_chunk_tokens=256, device=dev, params=params)
        svc = AdaptiveLLMService(single=single, batched=batched)
        real_single, real_batched, real_flip = single.submit, batched.submit, svc._maybe_flip

        def single_submit(*a, **k):
            served[nid]["single"] += 1
            return real_single(*a, **k)

        def batched_submit(ctx, prompt, max_new, cache_key=None, *, net, on_done):
            served[nid]["batched"] += 1
            rec = {"context": list(ctx), "prompt": list(prompt), "max_new": max_new}
            batched_turns.append(rec)

            def done(result):
                rec["tokens"] = list(result.token_ids)
                on_done(result)

            return real_batched(ctx, prompt, max_new, cache_key, net=net, on_done=done)

        def maybe_flip():
            before = svc.mode
            real_flip()
            if svc.mode != before:
                flips[nid].append(svc.mode)

        single.submit = attributed(nid, "single", single_submit)
        batched.submit = batched_submit
        batched._pump = attributed(nid, "batched", batched._pump)
        single.prime = attributed(nid, "prime", single.prime)
        batched.prime = attributed(nid, "prime", batched.prime)
        svc._maybe_flip = maybe_flip
        return svc

    cluster = EdgeCluster.build(
        list(FLEET_NODES), factory,
        inter_node_link=Link(latency_ms=2.0, bandwidth_mbps=100.0),
        client_link=Link(latency_ms=5.0, bandwidth_mbps=20.0),
        router="residency", admission_limit=FLEET_ADMISSION)
    log(f"fleet: weights and {len(FLEET_NODES)} nodes x 2 mounts built in "
        f"{time.perf_counter() - t0:.2f} s")
    plans = generate_workload(WorkloadSpec(**FLEET_SPEC))
    for c in counters.values():
        c.launches = 0
    t_run = time.perf_counter()
    res = run_fleet(cluster, plans, policy_name="residency", churn=[ChurnEvent(*FLEET_CHURN)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_run
    summary = res.summary()
    total = {name: c.launches for name, c in counters.items()}
    ups = sum(f.count("batched") for f in flips.values())
    downs = sum(f.count("single") for f in flips.values())
    log(f"fleet: {summary['n_sessions']} sessions, {summary['n_turns']} turns in {wall_s:.2f} s "
        f"of wall: {json.dumps(summary)}")
    log(f"fleet: flips per node {json.dumps(flips)}; turns per mount {json.dumps(served)}; "
        f"sheds {summary['sheds']} requeues {summary['requeues']} failovers "
        f"{summary['failovers']}; launches per mount {json.dumps(mounts)}")
    assert res.hung_tickets == 0, summary
    assert ups >= 1 and downs >= 1, flips
    assert sum(s["single"] for s in served.values()) > 0, served
    assert sum(s["batched"] for s in served.values()) > 0, served
    assert all(total[k] > 0 for k in ("chunked_prefill", "paged_attention", "shared_prefix")), \
        total
    assert total["flash_attention"] == total["decode_attention"] == 0, total
    assert total == {k: sum(m[b][k] for m in mounts.values() for b in m) for k in total}, \
        (total, mounts)
    assert cluster.node(FLEET_CHURN[0]).crashes == 1

    # batched-mount turns, in order, against a fresh single-stream kernel
    # service until FLEET_MIN_EQUAL are token-identical; a turn that differs
    # must differ at a near-tie: at its first differing step the two tokens'
    # logits (the kernel path teacher-forced with the batched tokens) lie
    # within LOGIT_TOL of each other
    fresh = TorchLLMService.create(model, cfg, max_len=2048, page_size=PS, kv_pages=512,
                                   device=dev, params=params)
    done = [r for r in batched_turns if "tokens" in r]
    checked = []
    for i, rec in enumerate(done[:FLEET_MAX_REPLAYS]):
        r = fresh.completion(rec["context"], rec["prompt"], rec["max_new"],
                             cache_key=f"check{i}")
        entry = {"equal": r.token_ids == rec["tokens"], "tokens": len(rec["tokens"])}
        if not entry["equal"]:
            j = next((k for k, (a, b) in enumerate(zip(r.token_ids, rec["tokens"])) if a != b),
                     None)
            assert j is not None, ("lengths differ with no differing token", r.token_ids,
                                   rec["tokens"])
            ids = rec["context"] + rec["prompt"]
            lg = teacher_forced_logits(cfg, params, ids, rec["tokens"][:j], dev)[j]
            gap = (lg[r.token_ids[j]] - lg[rec["tokens"][j]]).abs().item()
            entry.update(first_diff=j, logit_gap=gap)
            assert gap < LOGIT_TOL, ("fleet batched vs single", entry)
        checked.append(entry)
        if sum(e["equal"] for e in checked) >= FLEET_MIN_EQUAL:
            break
    n_equal = sum(e["equal"] for e in checked)
    differ = [e for e in checked if not e["equal"]]
    log(f"fleet: {len(done)} batched-mount turns; {len(checked)} replayed on a fresh "
        f"single-stream service: {n_equal} token-identical, the rest {json.dumps(differ)}")
    assert n_equal >= FLEET_MIN_EQUAL, checked
    out = {"summary": summary, "wall_s": wall_s, "flips": flips, "flips_up": ups,
           "flips_down": downs, "turns_per_mount": served, "launches_per_mount": mounts,
           "launches": total, "batched_turns": len(done), "batched_vs_single": checked,
           "spec": FLEET_SPEC, "admission_limit": FLEET_ADMISSION, "churn": FLEET_CHURN}
    del cluster, fresh, params
    torch.cuda.empty_cache()
    return out


SPLIT_KERNELS = ("paged_attention_split", "shared_prefix_split", "decode_attention_split")


def split_kernel_resources(build, ptxas: str) -> list:
    """(kernel, registers, spills) of every instantiation of the split-walk
    kernels K1 (``paged_attention_split``), K2 (``shared_prefix_split``) and
    K5 (``decode_attention_split``) from nvcc's ``-Xptxas -v`` report, names
    demangled by cu++filt where it sits beside nvcc."""
    import re

    found, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search("|".join(SPLIT_KERNELS), m.group(1)) else None
            spills = None
        elif name and "spill" in line:
            spills = line.strip().split(", ", 1)[1]
        elif name and "Used" in line and "registers" in line:
            found.append([name, int(re.search(r"Used (\d+) registers", line).group(1)), spills])
            name = None
    filt = Path(build._nvcc()).resolve().parent / "cu++filt"
    if filt.exists() and found:
        names = subprocess.run([str(filt)], input="\n".join(f[0] for f in found),
                               capture_output=True, text=True).stdout.splitlines()
        for f, n in zip(found, names):
            f[0] = n.replace("repro_torch::(anonymous namespace)::", "")
    assert {k for k in SPLIT_KERNELS if any(k in f[0] for f in found)} == set(SPLIT_KERNELS), found
    return found


def sass_tensor_core_check(build) -> None:
    """Read the built library's machine code (cuobjdump, beside nvcc): every
    instantiation of the bf16 prefill kernels (``*_mma``) and of the SSD
    chunk (``ssd_chunk_mma``, TF32 operands) must issue tensor-core
    instructions (HMMA) and the f32 prefill ones (``*_simt``) none. Without
    cuobjdump this is reported as not checked."""
    tool = Path(build._nvcc()).resolve().parent / "cuobjdump"
    if not tool.exists():
        log("sass: cuobjdump not found beside nvcc, tensor-core instructions not checked")
        return
    sass = subprocess.run([str(tool), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    hmma = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0]
        for kernel in ("chunked_prefill_mma", "flash_attention_mma", "ssd_chunk_mma",
                       "chunked_prefill_simt", "flash_attention_simt"):
            if kernel in name:
                hmma.setdefault(kernel, []).append(block.count(" HMMA."))
        if "ssd_chunk_mma" in name:
            assert " HMMA.1688.F32.TF32" in block, name
    log(f"sass: HMMA instructions per instantiation {json.dumps(hmma)}")
    for kernel in ("chunked_prefill_mma", "flash_attention_mma", "ssd_chunk_mma"):
        assert hmma.get(kernel) and min(hmma[kernel]) > 0, (kernel, hmma)
    assert len(hmma["ssd_chunk_mma"]) == 8, hmma      # N 16-128 x P 32, 64
    for kernel in ("chunked_prefill_simt", "flash_attention_simt"):
        assert hmma.get(kernel) and max(hmma[kernel]) == 0, (kernel, hmma)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_name_and_power()
    log(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {build.library_path().relative_to(ROOT)}")
    ptxas = (build.library_path().parent / "ptxas.log").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"build: {line.strip()}")
    for name, regs, spills in split_kernel_resources(build, ptxas):
        log(f"build: {name}: {regs} registers, {spills}")
    sass_tensor_core_check(build)

    n_layers = 24
    k1 = phase_k1(dev, n_layers)
    k3 = phase_k3(dev, n_layers)
    k4 = phase_k4(dev, n_layers)
    k5 = phase_k5(dev, n_layers)
    gqa = phase_gqa(dev, n_layers)
    svc, last_turn, launches, summary = phase_main(dev)
    diff = phase_equivalence(svc, last_turn, dev)
    phase_profile(svc, last_turn, dev)
    dsummary, dlaunches = phase_dense(svc.engine.params, dev)
    k4["launches"] = dlaunches["flash_attention"]
    k5["launches"] = dlaunches["decode_attention"]
    del svc, last_turn
    torch.cuda.empty_cache()
    k2 = phase_k2(dev, n_layers)
    bsvc, blaunches, bsummary, beq = phase_batched(dev)
    # the launches reported are the batched path's: it runs all three kernels
    k1["launches"] = blaunches["paged_attention"]
    k2["launches"] = blaunches["shared_prefix"]
    k3["launches"] = blaunches["chunked_prefill"]
    log(f"batched vs single stream (this run): decode {bsummary['decode_ms_per_step_b8_p50']:.3f}"
        f" ms per B = {N_SLOTS} step ({bsummary['decode_tokens_per_s_b8']:.2f} tokens/s) vs "
        f"{summary['decode_ms_per_token_p50']:.3f} ms per B = 1 token "
        f"({1e3 / summary['decode_ms_per_token_p50']:.2f} tokens/s)")
    migration = phase_migration(bsvc.server.params, dev)
    del bsvc
    torch.cuda.empty_cache()

    from repro_torch.configs import MAMBA2_1_3B, ZAMBA2_7B

    k6 = phase_k6(dev)
    ssm = phase_ssm_model(dev, MAMBA2_1_3B, {"ssd": MAMBA2_1_3B.n_layers}, {})
    n_shared = ZAMBA2_7B.n_layers // ZAMBA2_7B.shared_attn_period
    zamba = phase_ssm_model(dev, ZAMBA2_7B,
                            {"ssd": ZAMBA2_7B.n_layers, "flash_attention": n_shared},
                            {"decode_attention": n_shared})
    k6["launches"] = ssm["launches"]["ssd"] + zamba["launches"]["ssd"]
    # f32 kernel vs plain: Mamba2 at full depth, Zamba2 cut to its first 25
    # layers (4 shared-attention invocations; 9.3 GB of f32 weights)
    ssm_f32 = {"mamba2": phase_ssm_f32(dev, MAMBA2_1_3B, MAMBA2_1_3B.n_layers),
               "zamba2": phase_ssm_f32(dev, ZAMBA2_7B, 25)}
    discedge = phase_discedge(dev)
    qwen2 = phase_qwen2(dev)
    granite = phase_granite(dev)
    fleet = phase_fleet(dev)
    # the GQA edges' bf16 errors count in each kernel's max_abs_err
    for kk in (k1, k2, k3, k4, k5):
        kk["max_abs_err"] = max(kk["max_abs_err"], gqa["errors"][kk["name"]])

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"main_path": dict(summary, max_logit_diff=diff,
                                        launches_single_stream=launches), "k1_extra": {
        k: v for k, v in k1.items() if k not in keys}}))
    print(json.dumps({"batched_path": dict(bsummary, **beq, k2_extra={
        k: v for k, v in k2.items() if k not in keys}), "migration": migration}))
    print(json.dumps({"dense_path": dsummary, "k4_extra": {
        k: v for k, v in k4.items() if k not in keys}, "k5_extra": {
        k: v for k, v in k5.items() if k not in keys}}))
    print(json.dumps({"ssm_path": ssm, "zamba_path": zamba, "ssm_f32": ssm_f32, "k6_extra": {
        k: v for k, v in k6.items() if k not in keys}}))
    print(json.dumps({"discedge_path": discedge}))
    print(json.dumps({"gqa_edges": gqa}))
    print(json.dumps({"qwen2_path": qwen2}))
    print(json.dumps({"granite_path": granite}))
    print(json.dumps({"fleet_path": fleet}))
    print(json.dumps({"kernels": [{k: kk[k] for k in keys} for kk in (k1, k2, k3, k4, k5, k6)]}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
