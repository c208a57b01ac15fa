// Paged decode attention for Hopper (sm_90a): one decode query per lane
// against a paged KV pool, attending through the lane's page table.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// paged_attention_pallas (pallas_call at :310, body _paged_decode_kernel at
// :49). Same arguments after repro_torch/kernels/paged_attention/ops.py's
// reshapes: q (B, KV, G, Dh), pools (P, ps, KV, Dh), table (B, MP),
// bound (B,) = clip(ceil((q_pos+1)/ps), 1, MP), q_pos (B,), kv_pos (B, MP*ps);
// output (B, KV, G, Dh) in q's dtype. Mask 0 <= kv_pos <= q_pos, optional
// sliding window and tanh logit softcap; f32 online softmax; a lane with no
// valid key writes exact zeros. A page id outside [0, P) masks its tokens.
//
// Continuation mode (the suffix pass of the shared-prefix cascade, JAX's
// start/init arguments): with `start` > 0 the walk begins at page `start`,
// and with acc0/m0/l0 (f32, (B, KV, G, Dh) and (B, KV, G) — the stats the
// shared-prefix kernel, csrc/shared_prefix.cu, emits over pages [0, start))
// the seed is one more partial state of the merge: the exact continuation
// of the single-pass recurrence. A lane whose bound is <= start (its query
// lies inside the shared run) walks nothing and finalises straight from the
// seed. start = 0 with null seeds is the plain single pass.
//
// What bounds it on this card: bytes. Each visited token costs
// 2 * KV * Dh * sizeof(T) bytes of K/V and ~4 * G * Dh flops per KV head,
// far below the card's ~295 flop/byte ridge. A block per (lane, KV head)
// gives 16 blocks at B = 1 for the paper model on 132 SMs, a walk bound by
// one block's load latency, not by bandwidth.
//
// Design: a split walk (csrc/split_decode.cuh), as K5's. One cluster of
// `splits` blocks of 8 warps (fewer for K/V rows over 256 bytes: warps())
// per (lane, KV head, row group); the R <= RG query rows of a row group go
// together. A block holds at most kMaxRowsDh / Dh rows (a lane's
// 2 * kMaxPairs f32 accumulators), so a KV head whose G * Dh exceeds that
// (chatglm3's 16 x 128 = 2048: two groups of 8; nemotron's 12 x 192 =
// 2304: three of 4) is cut into ceil(G / RG) row groups, each its own
// cluster: K/V is then read once per row group, the second time mostly
// from L2 (kernels/paged_attention/kernel.py row_groups picks RG). The host
// picks `splits` from B * KV and the widest walk (MP - start) * ps
// (kernels/paged_attention/kernel.py paged_plan): 16 clusters of 8 at
// B = 1 for the paper model, 128 of 1 at B = 8. Each block takes its split
// of the lane's own range [lo, hi), lo = max(start * ps, q_pos - window + 1),
// hi = bound * ps (split_range on hi - lo, offset by lo; the Python
// paged_split_ranges is the same arithmetic), so every split of a long lane
// holds tokens. Each lane of a warp reads its token's page id
// table[b, t / ps] and its kv_pos a sub-tile ahead; a 32-token sub-tile
// with no attended token is skipped whole (warp-uniform, exact). Rank 0
// merges the seed first, then ranks 0..splits-1, normalises and writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "split_decode.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRowsDh = 1024;            // G * Dh per block
constexpr int kMaxPairs = kMaxRowsDh / 64;  // accumulator pairs per lane
// warps per block: 8, but 4 for rows over 256 bytes (f32 at Dh
// 128, bf16 at Dh 192) and 2 for rows over 512 (f32 at Dh 192), whose
// staged K/V rows would not fit more warps' shared memory
template <typename T, int DH>
constexpr int warps() {
  return DH * (int)sizeof(T) > 512 ? 2 : DH * (int)sizeof(T) > 256 ? 4 : 8;
}

template <typename T, int DH, int kWarps = warps<T, DH>(), int kThreads = 32 * kWarps>
__global__ void __launch_bounds__(kThreads) paged_attention_split(
    const T* __restrict__ q, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const int* __restrict__ table, const int* __restrict__ bound,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const float* __restrict__ acc0, const float* __restrict__ m0,
    const float* __restrict__ l0, T* __restrict__ out, int KV, int G, int RG, int P, int ps,
    int MP, int window, int start, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // blockIdx.y = KV head x row groups: this block's rows [r0, r0 + R) of
  // the KV head's G query rows
  const int n_rg = (G + RG - 1) / RG;
  const int h = blockIdx.y / n_rg, r0 = (blockIdx.y - h * n_rg) * RG, b = blockIdx.z;
  const int R = min(RG, G - r0);
  const split::Smem<T, DH, kWarps> sm(smem_raw, R, gridDim.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t lane_head = (size_t)b * KV + h;
  // the lane's range, then this block's split of it
  const int qp = q_pos[b];
  const int end = bound[b] * ps;
  const int from = max(start * ps, window > 0 ? qp - window + 1 : 0);
  int lo, hi;
  split::split_range(max(0, end - from), (int)gridDim.x, (int)blockIdx.x, lo, hi);
  lo += from;
  hi += from;
  const int* tbl = table + (size_t)b * MP;
  const int* pos_b = kv_pos + (size_t)b * MP * ps;
  const size_t tok_stride = (size_t)KV * DH;
  auto token_off = [&](int t, int phys) {
    return ((size_t)phys * ps + (t - (t / ps) * ps)) * tok_stride + (size_t)h * DH;
  };
  auto attended = [&](int t, int phys, int kp) {
    return t < hi && phys >= 0 && phys < P && kp >= 0 && kp <= qp &&
           (window <= 0 || qp - kp < window);
  };
  // each warp's first sub-tile: its tokens' page ids and positions load
  // with q, and its K/V copies start before q is stored; later sub-tiles'
  // load a step ahead
  const int first = lo + warp * 32;
  int phys = -1, kp = -1, phys_next = -1, kp_next = -1;
  if (first + lane < hi) {
    phys = tbl[(first + lane) / ps];
    kp = pos_b[first + lane];
  }
  if (first + kThreads + lane < hi) {
    phys_next = tbl[(first + kThreads + lane) / ps];
    kp_next = pos_b[first + kThreads + lane];
  }
  const size_t q0 = (lane_head * G + r0) * DH;
  split::load_q<kMaxRowsDh>(sm, R, q, [&](int r) { return q0 + (size_t)r * DH; }, [&] {
    const bool live = attended(first + lane, phys, kp);
    if (__any_sync(0xffffffffu, live))
      split::stage(sm, live, live ? token_off(first + lane, phys) : 0, pool_k, pool_v);
  });
  split::begin(sm, R);
  float acc[2 * kMaxPairs];
#pragma unroll
  for (int j = 0; j < 2 * kMaxPairs; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int base = first; base < hi; base += kThreads) {
    const int t = base + lane;
    const int phys_t = phys;
    const bool live = attended(t, phys, kp);
    phys = phys_next;
    kp = kp_next;
    if (t + 2 * kThreads < hi) {
      phys_next = tbl[(t + 2 * kThreads) / ps];
      kp_next = pos_b[t + 2 * kThreads];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform: an exact skip
    if (base != first) split::stage(sm, live, live ? token_off(t, phys_t) : 0, pool_k, pool_v);
    split::warp_step<kMaxPairs>(sm, R, live, [](int) { return true; }, scale, softcap, acc);
  }

  split::block_merge<kMaxPairs>(sm, R, acc);
  const split::Seed seed{acc0 != nullptr ? acc0 + q0 : nullptr,
                         m0 != nullptr ? m0 + lane_head * G + r0 : nullptr,
                         l0 != nullptr ? l0 + lane_head * G + r0 : nullptr};
  T* ob = out + q0;
  split::cluster_merge(
      sm, R, seed,
      [&](int c, int, float a, float l) { ob[c] = from_float<T>(a / (l == 0.f ? 1.f : l)); },
      [](int, float, float) {});
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* table,
                   const void* bound, const void* q_pos, const void* kv_pos, const void* acc0,
                   const void* m0, const void* l0, void* out, int B, int KV, int G, int RG,
                   int P, int ps, int MP, int splits, int window, int start, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr int kWarps = warps<T, DH>();
  return split::launch_split<kWarps>(
      paged_attention_split<T, DH>, splits, KV * ((G + RG - 1) / RG), B,
      split::Smem<T, DH, kWarps>::bytes(RG, splits),
      stream, static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(bound), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const float*>(acc0),
      static_cast<const float*>(m0), static_cast<const float*>(l0), static_cast<T*>(out), KV,
      G, RG, P, ps, MP, window, start, softcap, scale);
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* pool_k, const void* pool_v,
                        const void* table, const void* bound, const void* q_pos,
                        const void* kv_pos, const void* acc0, const void* m0, const void* l0,
                        void* out, int B, int KV, int G, int RG, int P, int ps, int MP,
                        int splits, int window, int start, float softcap, float scale,
                        cudaStream_t stream) {
#define REPRO_PAGED_CASE(D)                                                                 \
  case D:                                                                                   \
    return launch<T, D>(q, pool_k, pool_v, table, bound, q_pos, kv_pos, acc0, m0, l0, out, \
                        B, KV, G, RG, P, ps, MP, splits, window, start, softcap, scale,     \
                        stream);
  switch (Dh) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(128)
    REPRO_PAGED_CASE(192)  // nemotron-4-340b
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches one cluster launch on
// `stream` (grid (splits, KV * ceil(G / RG), B), clusters of splits
// blocks), allocates nothing, does not synchronise; returns the launch's
// error. RG is the query rows per block (RG * Dh <= kMaxRowsDh). acc0/m0/l0
// are null (start from the empty state) or all three set.
extern "C" int repro_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* table, const void* bound, const void* q_pos,
                                     const void* kv_pos, const void* acc0, const void* m0,
                                     const void* l0, void* out, int B, int KV, int G, int RG,
                                     int Dh, int P, int ps, int MP, int splits, int window,
                                     int start, float softcap, float scale, int dtype,
                                     void* stream) {
  using namespace repro_torch;
  if (B <= 0 || RG < 1 || RG > G || RG * Dh > kMaxRowsDh || splits < 1 ||
      splits > split::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (start < 0 || start >= MP) return (int)cudaErrorInvalidValue;
  if ((acc0 == nullptr) != (m0 == nullptr) || (m0 == nullptr) != (l0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, pool_k, pool_v, table, bound, q_pos, kv_pos,
                                           acc0, m0, l0, out, B, KV, G, RG, P, ps, MP,
                                           splits, window, start, softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, pool_k, pool_v, table, bound, q_pos, kv_pos, acc0,
                                   m0, l0, out, B, KV, G, RG, P, ps, MP, splits, window,
                                   start, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
