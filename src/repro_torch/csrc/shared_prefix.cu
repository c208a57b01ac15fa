// Shared-prefix (cascade) pass of paged decode attention for Hopper
// (sm_90a): every lane of a decode batch against the run of pages that
// every lane's page table starts with, emitting the per-lane partial
// online-softmax state (acc, m, l) for the per-lane suffix pass
// (csrc/paged_attention.cu in continuation mode) to continue from.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// shared_prefix_pallas (pallas_call at :228, body _shared_prefix_kernel at
// :119). Same arguments after repro_torch/kernels/paged_attention/ops.py's
// reshapes: q (B, KV, G, Dh), pools (P, ps, KV, Dh), shared_pages (S,)
// holding positions [0, S*ps), q_pos (B,); outputs f32 acc (B, KV, G, Dh),
// m and l (B, KV, G), unnormalised. The run is full and resident by
// contract, so slot == position: the mask is causal (kp <= q_pos[b]) plus
// the optional sliding window, with the tanh logit softcap. Masked slots
// contribute p = 0; a lane whose whole run is masked keeps m = -1e30,
// l = 0, acc = 0 (never -inf, so the suffix pass's merge cannot make NaNs).
//
// What bounds it on this card: bytes. The run's K/V is S*ps*KV*Dh*2 values
// (a 64-page run of the paper model: 64*16*16*64*2*2 B = 4 MiB per layer,
// 1.25 us at 3.35 TB/s) and is the same for every lane; the per-lane
// single-pass kernel would read it B times. The arithmetic is ~4*B*G*Dh
// flops per token per KV head, far below the ~295 flop/byte ridge.
//
// Design: a split walk (csrc/split_decode.cuh). One cluster of `splits`
// blocks of 4 warps per (KV head, tile of lanes); a tile holds as many
// lanes as keep its rows' accumulators within a warp's registers
// (lanes * G * Dh <= 2048: all 8 lanes of the server's batch at G = 1,
// Dh = 64), so each K/V token is read from device memory once per KV head
// for the whole batch — traffic is O(unique pages), not O(B x pages). The
// host picks `splits` (kernels/paged_attention/kernel.py
// shared_prefix_plan): at the server's shape 16 clusters of 8 blocks, 128
// run tokens each, one 32-token sub-tile per warp. Each block walks its
// split of the run, skipping sub-tiles that no row of the tile reaches
// (before the first window start or past the last query position); each
// lane reads the page id of its own token a sub-tile ahead. Each rank of
// the cluster writes its share of the merged (acc, m, l).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "split_decode.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxLanes = 64;     // lanes per block
constexpr int kMaxRowsDh = 2048;  // lanes * G * Dh per block
constexpr int kMaxPairs = kMaxRowsDh / 64;  // accumulator pairs per lane
constexpr int kWarps = 4;                   // a 128-token split is one sub-tile per warp
constexpr int kThreads = 32 * kWarps;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) shared_prefix_split(
    const T* __restrict__ q, const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    const int* __restrict__ pages, const int* __restrict__ q_pos, float* __restrict__ acc_o,
    float* __restrict__ m_o, float* __restrict__ l_o, int B, int KV, int G, int P, int ps,
    int S, int lanes, int window, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * lanes;
  const int nb = min(lanes, B - b0);
  const int R = nb * G;  // query rows of this block: row r = (lane b0 + r / G, head r % G)
  const split::Smem<T, DH, kWarps> sm(smem_raw, R, gridDim.x);
  int* qrow = sm.ints;   // each row's query position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this split of the run. Each warp's first sub-tile: its page ids load
  // with q, and its K/V copies start before q is stored (the rows' reach is
  // not known yet, so the whole sub-tile is copied); later sub-tiles' page
  // ids load a step ahead
  int lo, hi;
  split::split_range(S * ps, (int)gridDim.x, (int)blockIdx.x, lo, hi);
  const size_t tok_stride = (size_t)KV * DH;
  auto token_off = [&](int t, int phys) {
    return ((size_t)phys * ps + (t - (t / ps) * ps)) * tok_stride + (size_t)h * DH;
  };
  const int first = lo + warp * 32;
  const int phys_first = first + lane < hi ? pages[(first + lane) / ps] : -1;
  int phys_next = first + kThreads + lane < hi ? pages[(first + kThreads + lane) / ps] : -1;
  const int my_qpos = tid < R ? q_pos[b0 + tid / G] : 0;  // R <= 128
  // row r = (lane b0 + r / G, head r % G): a lane's G heads are contiguous
  split::load_q<kMaxRowsDh>(
      sm, R, q,
      [&](int r) { return (((size_t)(b0 + r / G) * KV + h) * G + (r - (r / G) * G)) * DH; },
      [&] {
        const bool resident = phys_first >= 0 && phys_first < P;
        if (__any_sync(0xffffffffu, resident))
          split::stage(sm, resident, resident ? token_off(first + lane, phys_first) : 0, pool_k,
                       pool_v);
      });
  if (tid < R) qrow[tid] = my_qpos;
  split::begin(sm, R);
  float acc[2 * kMaxPairs];
#pragma unroll
  for (int j = 0; j < 2 * kMaxPairs; ++j) acc[j] = 0.f;
  __syncthreads();

  // only the tokens some row attends: [first window start, last query]
  int qmax = -1, qmin = 0x7fffffff;
  for (int i = 0; i < nb; ++i) {
    qmax = max(qmax, qrow[i * G]);
    qmin = min(qmin, qrow[i * G]);
  }
  const int reach_lo = window > 0 ? qmin - window + 1 : 0;
  const int reach_hi = min(hi, qmax + 1);

  int phys = phys_first;
  for (int base = first; base < reach_hi; base += kThreads) {
    const int t = base + lane;
    const int phys_t = phys;
    phys = phys_next;
    if (t + 2 * kThreads < hi) phys_next = pages[(t + 2 * kThreads) / ps];
    if (base + 32 <= reach_lo) continue;  // warp-uniform: no row reaches this sub-tile
    const bool live = t >= reach_lo && t < reach_hi && phys_t >= 0 && phys_t < P;
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform: nothing resident
    if (base != first) split::stage(sm, live, live ? token_off(t, phys_t) : 0, pool_k, pool_v);
    split::warp_step<kMaxPairs>(
        sm, R, live,
        [&](int r) {
          const int qp = qrow[r];
          return t <= qp && (window <= 0 || qp - t < window);
        },
        scale, softcap, acc);
  }

  split::block_merge<kMaxPairs>(sm, R, acc);
  split::cluster_merge(
      sm, R,
      [&](int c, int r, float a, float) {
        const int d = c - r * DH, b = b0 + r / G, g = r - (r / G) * G;
        acc_o[(((size_t)b * KV + h) * G + g) * DH + d] = a;
      },
      [&](int r, float m, float l) {
        const size_t o = ((size_t)(b0 + r / G) * KV + h) * G + (r - (r / G) * G);
        m_o[o] = m;
        l_o[o] = l;
      });
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* pages,
                   const void* q_pos, void* acc, void* m, void* l, int B, int KV, int G,
                   int P, int ps, int S, int lanes, int splits, int window, float softcap,
                   float scale, cudaStream_t stream) {
  return split::launch_split<kWarps>(
      shared_prefix_split<T, DH>, splits, KV, (B + lanes - 1) / lanes,
      split::Smem<T, DH, kWarps>::bytes(lanes * G, splits), stream, static_cast<const T*>(q),
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(pages), static_cast<const int*>(q_pos),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), B, KV, G, P,
      ps, S, lanes, window, softcap, scale);
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* pool_k, const void* pool_v,
                        const void* pages, const void* q_pos, void* acc, void* m, void* l,
                        int B, int KV, int G, int P, int ps, int S, int lanes, int splits,
                        int window, float softcap, float scale, cudaStream_t stream) {
#define REPRO_SHARED_CASE(D)                                                             \
  case D:                                                                                \
    return launch<T, D>(q, pool_k, pool_v, pages, q_pos, acc, m, l, B, KV, G, P, ps, S, \
                        lanes, splits, window, softcap, scale, stream);
  switch (Dh) {
    REPRO_SHARED_CASE(16)
    REPRO_SHARED_CASE(32)
    REPRO_SHARED_CASE(64)
    REPRO_SHARED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SHARED_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches one cluster launch on
// `stream` (grid (splits, KV, ceil(B / lanes)), clusters of splits blocks),
// allocates nothing, does not synchronise; returns the launch's error.
extern "C" int repro_shared_prefix(const void* q, const void* pool_k, const void* pool_v,
                                   const void* pages, const void* q_pos, void* acc, void* m,
                                   void* l, int B, int KV, int G, int Dh, int P, int ps, int S,
                                   int lanes, int splits, int window, float softcap,
                                   float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || lanes < 1 || lanes > kMaxLanes || lanes * G * Dh > kMaxRowsDh ||
      splits < 1 || splits > split::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, pool_k, pool_v, pages, q_pos, acc, m, l, B,
                                           KV, G, P, ps, S, lanes, splits, window, softcap,
                                           scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, pool_k, pool_v, pages, q_pos, acc, m, l, B, KV, G,
                                   P, ps, S, lanes, splits, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
