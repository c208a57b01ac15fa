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
// Design: one block of 128 threads per (KV head, tile of lanes). A tile
// holds as many lanes as keep its B_tile*G query rows' accumulators within
// the block's registers (rows * Dh <= 128 * 16: all 8 lanes of the
// server's batch at the paper's G = 1, Dh = 64), so each K/V token is read
// from device memory once per KV head for the whole batch — traffic is
// O(unique pages), not O(B x pages). The block walks the run in tiles of
// 128 tokens across page boundaries (K1's tile: one token per thread):
// each thread reads shared_pages[t / ps] itself, loads its token's K row
// into registers and its V row into shared memory, and computes the logits
// of every query row of the block against it. One warp per row then does
// the online-softmax update (m, l in f32 shared memory), and each thread
// accumulates P.V for fixed (row, d) cells in f32 registers. Tokens past
// the block's last query position, and (with a window) before its first
// window start, are masked for every row and are not walked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // threads per block == tokens per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;    // rows * Dh <= kThreads * kMaxAcc
constexpr int kMaxLanes = 64;  // lanes per block (shared q_pos table)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) shared_prefix_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ pages,
    const int* __restrict__ q_pos, float* __restrict__ acc_o,
    float* __restrict__ m_o, float* __restrict__ l_o, int B, int KV, int G,
    int P, int ps, int S, int lanes, int window, float softcap, float scale) {
  constexpr int VS = DH + 4;  // padded V row stride (floats)
  const int rows_max = lanes * G;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                         // rows_max * DH query rows
  float* v_s = q_s + rows_max * DH;          // kThreads * VS value rows
  float* s_s = v_s + kThreads * VS;          // rows_max * kThreads logits
  float* alpha_s = s_s + rows_max * kThreads;  // rows_max
  float* m_s = alpha_s + rows_max;           // rows_max running max
  float* l_s = m_s + rows_max;               // rows_max running sum
  int* qp_s = reinterpret_cast<int*>(l_s + rows_max);  // lanes

  const int h = blockIdx.x;
  const int b0 = blockIdx.y * lanes;
  const int nb = min(lanes, B - b0);
  const int R = nb * G;  // query rows of this block
  const int RD = R * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // row r = (lane b0 + r / G, head group r % G)
  for (int i = tid; i < RD; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    const int b = b0 + r / G, g = r - (r / G) * G;
    q_s[i] = to_float(q[(((size_t)b * KV + h) * G + g) * DH + d]);
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < nb; i += kThreads) qp_s[i] = q_pos[b0 + i];
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  // the block's walk: no row attends past its query or before its window
  int qmax = -1, qmin = 0x7fffffff;
  for (int i = 0; i < nb; ++i) {
    qmax = max(qmax, qp_s[i]);
    qmin = min(qmin, qp_s[i]);
  }
  const int hi = min(S * ps, qmax + 1);
  const int lo = window > 0 ? max(0, qmin - window + 1) : 0;
  const size_t tok_stride = (size_t)KV * DH;

  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    __syncthreads();  // the previous tile's readers are done with v_s / s_s
    const int t = t0 + tid;
    float* v_row = v_s + tid * VS;
    float k_reg[DH];
    bool in = false;
    if (t < hi) {
      const int pg = t / ps;
      const int phys = pages[pg];
      if (phys >= 0 && phys < P) {
        const size_t off =
            ((size_t)phys * ps + (t - pg * ps)) * tok_stride + (size_t)h * DH;
#pragma unroll
        for (int d = 0; d < DH; d += Vec16<T>::N) {
          Vec16<T>::load(pool_k + off + d, k_reg + d);
          Vec16<T>::load(pool_v + off + d, v_row + d);
        }
        in = true;
      }
    }
    if (!in) {
      // masked for every row: p == 0 below, and it must meet a finite v
#pragma unroll
      for (int d = 0; d < DH; ++d) v_row[d] = 0.f;
    }
    for (int r = 0; r < R; ++r) {
      const int qp = qp_s[r / G];
      const bool valid = in && t <= qp && (window <= 0 || qp - t < window);
      float s = kNegInf;
      if (valid) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + r * DH);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 qv = q4[c];
          dot += qv.x * k_reg[4 * c] + qv.y * k_reg[4 * c + 1] +
                 qv.z * k_reg[4 * c + 2] + qv.w * k_reg[4 * c + 3];
        }
        s = apply_softcap(dot * scale, softcap);
      }
      s_s[r * kThreads + tid] = s;
    }
    __syncthreads();

    // online softmax: one warp per query row; a masked slot holds exactly
    // kNegInf and contributes p = 0
    for (int r = warp; r < R; r += kWarps) {
      float* sr = s_s + r * kThreads;
      float mx = kNegInf;
      for (int i = lane; i < kThreads; i += 32) mx = fmaxf(mx, sr[i]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < kThreads; i += 32) {
        const float pr = sr[i] == kNegInf ? 0.f : expf(sr[i] - m_new);
        sr[i] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, each thread owning fixed (row, d) cells
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < RD) {
        const int r = idx / DH, d = idx - r * DH;
        const float* pr = s_s + r * kThreads;
        float a = acc[j] * alpha_s[r];
        for (int i = 0; i < kThreads; ++i) a += pr[i] * v_s[i * VS + d];
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < RD) {
      const int r = idx / DH, d = idx - r * DH;
      const int b = b0 + r / G, g = r - (r / G) * G;
      acc_o[(((size_t)b * KV + h) * G + g) * DH + d] = acc[j];
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    const int b = b0 + r / G, g = r - (r / G) * G;
    const size_t o = ((size_t)b * KV + h) * G + g;
    m_o[o] = m_s[r];
    l_o[o] = l_s[r];
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* pages, const void* q_pos, void* acc, void* m,
                   void* l, int B, int KV, int G, int P, int ps, int S,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  const int lanes = min(B, min(kMaxLanes, max(1, kThreads * kMaxAcc / (G * DH))));
  const int rows_max = lanes * G;
  const size_t smem =
      sizeof(float) * ((size_t)rows_max * DH + (size_t)kThreads * (DH + 4) +
                       (size_t)rows_max * kThreads + 3 * (size_t)rows_max) +
      sizeof(int) * (size_t)lanes;
  auto kern = shared_prefix_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(KV, (B + lanes - 1) / lanes), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(pages),
      static_cast<const int*>(q_pos), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), B, KV, G, P, ps, S,
      lanes, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* pool_k,
                        const void* pool_v, const void* pages,
                        const void* q_pos, void* acc, void* m, void* l, int B,
                        int KV, int G, int P, int ps, int S, int window,
                        float softcap, float scale, cudaStream_t stream) {
#define REPRO_SHARED_CASE(D)                                                \
  case D:                                                                   \
    return launch<T, D>(q, pool_k, pool_v, pages, q_pos, acc, m, l, B, KV, \
                        G, P, ps, S, window, softcap, scale, stream);
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

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_shared_prefix(const void* q, const void* pool_k,
                                   const void* pool_v, const void* pages,
                                   const void* q_pos, void* acc, void* m,
                                   void* l, int B, int KV, int G, int Dh, int P,
                                   int ps, int S, int window, float softcap,
                                   float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (G * Dh > kThreads * kMaxAcc || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, pool_k, pool_v, pages, q_pos,
                                           acc, m, l, B, KV, G, P, ps, S, window,
                                           softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, pool_k, pool_v, pages, q_pos, acc, m,
                                   l, B, KV, G, P, ps, S, window, softcap,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
