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
               and each kernel's register/shared-memory report;
3. K1       — paged decode attention kernel vs its plain PyTorch version
               (bf16, ps 16, MHA and GQA with window x softcap, ragged lanes
               incl. an empty one), then timed at the main path's shape;
4. K3       — chunked paged prefill kernel vs its plain version (S = 256,
               p0 at 0 and mid-page, ragged true_len), then timed;
5. main     — TorchLLMService at the full width of the paper's
               Qwen1.5-0.5B (random weights from a seed) serves 3 sessions
               x 3 turns of tokenized context; turns 2-3 must be session
               hits that prefill only the suffix, both kernels must have
               launched; then one turn is teacher-forced through the kernel
               path and the plain path (same weights) and the per-step
               logits must agree;
6. profile  — host-clock and torch.profiler times of 8 decode steps and
               one 256-token prefill chunk (device busy and idle share,
               top kernels); diagnostic, after the counted run;
7. result   — a JSON line with every kernel's numbers, the card's name and
               power limit, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the ``repro`` package.
"""

from __future__ import annotations

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

def _paged_case(gen, lens, H, KV, Dh, dtype, dev, mp=None):
    import torch

    B = len(lens)
    pages_of = lambda n: max(1, -(-n // PS))
    mp = mp or max(pages_of(n) for n in lens)
    n_pages = 1 + sum(pages_of(n) for n in lens)
    q = torch.randn(B, 1, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(n_pages, PS, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(n_pages, PS, KV, Dh, generator=gen, device=dev).to(dtype)
    table = torch.zeros(B, mp, dtype=torch.int32)
    kv_pos = torch.full((B, mp * PS), -1, dtype=torch.int32)
    used = 1
    for bi, n in enumerate(lens):
        for pj in range(pages_of(n)):
            table[bi, pj] = used
            used += 1
        kv_pos[bi, :n] = torch.arange(n, dtype=torch.int32)
    q_pos = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32)
    return q, pk, pv, table.to(dev), q_pos.to(dev), kv_pos.to(dev)


def phase_k1(dev, n_layers: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda

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
        log(f"K1 {name}: max_abs_err {e:.3e} (bound {K1_TOL})")
        assert e <= K1_TOL, f"K1 {name}: {e} > {K1_TOL}"
        err = max(err, e)

    # main-path shape: B = 1, MHA 16 x 64, a 1024-token lane, one input set
    # per layer
    kv_len, H, KV, Dh = 1024, 16, 16, 64
    sets = [_paged_case(gen, (kv_len,), H, KV, Dh, torch.bfloat16, dev) for _ in range(n_layers)]
    prepared = []
    for q, pk, pv, table, q_pos, kv_pos in sets:
        qp = q_pos.reshape(1)
        bound = torch.clamp((qp + PS) // PS, 1, table.shape[1]).to(torch.int32)
        prepared.append((q.reshape(1, KV, H // KV, Dh).contiguous(), pk, pv, table, bound,
                         qp.contiguous(), kv_pos))
    kernel_ms = device_time_ms([lambda a=a: paged_attention_cuda(*a) for a in prepared])
    plain_ms = device_time_ms([lambda s=s: ref.paged_attention_ref(*s) for s in sets])
    lib_args = []
    for q, pk, pv, table, q_pos, kv_pos in sets:
        k = pk[table.long()].reshape(1, -1, KV, Dh).transpose(1, 2).contiguous()
        v = pv[table.long()].reshape(1, -1, KV, Dh).transpose(1, 2).contiguous()
        mask = ((kv_pos >= 0) & (kv_pos <= q_pos))[:, None, None, :]
        lib_args.append((q.transpose(1, 2).contiguous(), k, v, mask))
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])
         for a in lib_args]
    )
    tokens = kv_len                                          # visited (bound * ps)
    nbytes = 2 * tokens * KV * Dh * 2 + 2 * H * Dh * 2 + 4 * (tokens + tokens // PS + 2)
    flops = 4 * H * Dh * tokens
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"K1 main shape (B=1, kv_len {kv_len}): kernel_ms {kernel_ms:.5f} plain_ms "
        f"{plain_ms:.5f} library_ms {library_ms:.5f} bound_ms {bound_ms:.6f} ({bound_by})")
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:310",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K3: chunked paged prefill attention
# ---------------------------------------------------------------------------

def _chunk_case(gen, p0s, lens, S, H, KV, Dh, mp, dtype, dev):
    import torch

    B = len(p0s)
    q = torch.randn(B, S, H, Dh, generator=gen, device=dev).to(dtype)
    pk = torch.randn(1 + B * mp, PS, KV, Dh, generator=gen, device=dev).to(dtype)
    pv = torch.randn(1 + B * mp, PS, KV, Dh, generator=gen, device=dev).to(dtype)
    table = (1 + torch.arange(B * mp, dtype=torch.int32, device=dev)).reshape(B, mp)
    return (q, pk, pv, table, torch.tensor(p0s, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def phase_k3(dev, n_layers: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.chunked_prefill import ops, ref
    from repro_torch.kernels.chunked_prefill.kernel import chunked_prefill_cuda

    gen = torch.Generator(device=dev).manual_seed(2)
    S, err = 256, 0.0
    cases = [
        ("mha p0 0 / mid-page", (0, 520, 1031), (256, 173, 1), 16, 16, 64, 0, 0.0),
        ("gqa window x softcap", (8, 700), (200, 256), 16, 4, 64, 100, 30.0),
    ]
    for name, p0s, lens, H, KV, Dh, window, cap in cases:
        args = _chunk_case(gen, p0s, lens, S, H, KV, Dh, 128, torch.bfloat16, dev)
        out = ops.chunked_prefill_attention(*args, window=window, softcap=cap)
        want = ref.chunked_prefill_ref(*args, window=window, softcap=cap)
        torch.cuda.synchronize()
        e = max(
            (out[b, :n].float() - want[b, :n].float()).abs().max().item()
            for b, n in enumerate(lens)
        )
        assert all(torch.isfinite(out[b, :n].float()).all() for b, n in enumerate(lens)), name
        log(f"K3 {name}: max_abs_err {e:.3e} over read rows (bound {K3_TOL})")
        assert e <= K3_TOL, f"K3 {name}: {e} > {K3_TOL}"
        err = max(err, e)

    # main-path shape: B = 1, a 256-token chunk at p0 = 768 (1024-token
    # prefix), MHA 16 x 64, one input set per layer
    p0, H, KV, Dh, mp = 768, 16, 16, 64, 64
    sets = [_chunk_case(gen, (p0,), (S,), S, H, KV, Dh, mp, torch.bfloat16, dev)
            for _ in range(n_layers)]
    prepared = []
    for q, pk, pv, table, p0t, tl in sets:
        bound = torch.clamp((p0t + tl + PS - 1) // PS, 1, mp).to(torch.int32)
        qr = q.reshape(1, S, KV, 1, Dh).permute(0, 2, 1, 3, 4).reshape(1, KV, S, Dh).contiguous()
        prepared.append((qr, pk, pv, table, bound, p0t))
    kernel_ms = device_time_ms([lambda a=a: chunked_prefill_cuda(*a, g=1) for a in prepared])
    plain_ms = device_time_ms([lambda s=s: ref.chunked_prefill_ref(*s) for s in sets])
    t = p0 + S
    lib_args = []
    rows = torch.arange(S, device=dev)[:, None] + p0
    mask = torch.arange(t, device=dev)[None, :] <= rows           # (S, T) causal
    for q, pk, pv, table, _, _ in sets:
        k = pk[table.long()].reshape(1, -1, KV, Dh)[:, :t].transpose(1, 2).contiguous()
        v = pv[table.long()].reshape(1, -1, KV, Dh)[:, :t].transpose(1, 2).contiguous()
        lib_args.append((q.transpose(1, 2).contiguous(), k, v))
    library_ms = device_time_ms(
        [lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=mask)
         for a in lib_args]
    )
    visible = S * (p0 + 1) + S * (S - 1) // 2                     # causal (row, key) pairs
    nbytes = 2 * t * KV * Dh * 2 + 2 * S * H * Dh * 2 + 4 * (mp + 2)
    flops = 4 * H * Dh * visible
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"K3 main shape (B=1, S {S}, p0 {p0}): kernel_ms {kernel_ms:.5f} plain_ms "
        f"{plain_ms:.5f} library_ms {library_ms:.5f} bound_ms {bound_ms:.6f} ({bound_by})")
    return {
        "name": "chunked_prefill", "route": "cuda",
        "source": "src/repro_torch/csrc/chunked_prefill.cu",
        "replaces": "src/repro/kernels/chunked_prefill/kernel.py:154",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


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
    the device busy time and the top kernels. Diagnostic only: a trace with
    no device time is reported as not measured, not as a failure."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    report = {}
    for name, (fn, per) in work.items():
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
                 "top_kernels_ms": [(k[:70], t / per, c // per) for k, t, c in rows[:8]]}
        report[name] = entry
        log(f"profile {name}: {json.dumps(entry)}")
    return report


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
    for line in (build.library_path().parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"build: {line.strip()}")

    n_layers = 24
    k1 = phase_k1(dev, n_layers)
    k3 = phase_k3(dev, n_layers)
    svc, last_turn, launches, summary = phase_main(dev)
    k1["launches"], k3["launches"] = launches["paged_attention"], launches["chunked_prefill"]
    diff = phase_equivalence(svc, last_turn, dev)
    phase_profile(svc, last_turn, dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"main_path": dict(summary, max_logit_diff=diff)}))
    print(json.dumps({"kernels": [{k: kk[k] for k in keys} for kk in (k1, k3)]}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
