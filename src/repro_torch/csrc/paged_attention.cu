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
// valid key writes exact zeros. The shared-prefix continuation (start/init,
// fed by shared_prefix_pallas) is not part of this kernel yet.
//
// What bounds it on this card: bytes. Each visited token costs
// 2 * KV * Dh * sizeof(T) bytes of K/V and ~4 * G * Dh flops per KV head,
// far below the card's ~295 flop/byte ridge. At the serving batch (B = 1)
// the grid is only B * KV blocks (16 for the paper model) on 132 SMs, so
// the walk is latency bound long before it is bandwidth bound; splitting
// the KV walk across blocks (split-KV) is later work.
//
// Design: one block of 128 threads per (lane, KV head). The block walks the
// lane's tokens [lo, bound*ps) in tiles of 128 tokens, one token per thread:
// each thread reads table[b, t/ps] itself, loads its token's K row straight
// into registers with 16-byte loads and its V row into shared memory, and
// computes its G logits against the G query rows held in shared memory. So a
// tile costs one global-memory round trip for 128 tokens instead of one per
// page. One warp per query row then does the online-softmax update (m, l in
// f32 shared memory), and the block accumulates P.V with each thread owning
// fixed (g, d) cells of acc in f32 registers. Pages at or past bound are
// never touched; with a window, tokens before q_pos - window + 1 are skipped
// (they are masked for the query, so the result is unchanged).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // threads per block == tokens per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 8;     // G * Dh <= kThreads * kMaxAcc

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ bound, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, T* __restrict__ out, int KV, int G, int P,
    int ps, int MP, int window, float softcap, float scale) {
  constexpr int VS = DH + 4;  // padded V row stride (floats)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // G * DH query rows
  float* v_s = q_s + G * DH;              // kThreads * VS value rows
  float* s_s = v_s + kThreads * VS;       // G * kThreads logits -> probabilities
  float* alpha_s = s_s + G * kThreads;    // G
  float* m_s = alpha_s + G;               // G running max
  float* l_s = m_s + G;                   // G running sum
  int* valid_s = reinterpret_cast<int*>(l_s + G);  // kThreads

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * DH;

  const T* qb = q + ((size_t)b * KV + h) * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int qp = q_pos[b];
  const int hi = bound[b] * ps;
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  const size_t tok_stride = (size_t)KV * DH;

  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    __syncthreads();  // the previous tile's readers are done with v_s / s_s
    const int t = t0 + tid;
    float* v_row = v_s + tid * VS;
    float k_reg[DH];
    bool valid = false;
    if (t < hi) {
      const int pg = t / ps;
      const int phys = table[(size_t)b * MP + pg];
      if (phys >= 0 && phys < P) {
        const size_t off =
            ((size_t)phys * ps + (t - pg * ps)) * tok_stride + (size_t)h * DH;
#pragma unroll
        for (int d = 0; d < DH; d += Vec16<T>::N) {
          Vec16<T>::load(pool_k + off + d, k_reg + d);
          Vec16<T>::load(pool_v + off + d, v_row + d);
        }
        const int kp = kv_pos[(size_t)b * MP * ps + t];
        valid = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
      }
    }
    valid_s[tid] = valid;
    if (valid) {
      for (int g = 0; g < G; ++g) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + g * DH);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 qv = q4[c];
          dot += qv.x * k_reg[4 * c] + qv.y * k_reg[4 * c + 1] +
                 qv.z * k_reg[4 * c + 2] + qv.w * k_reg[4 * c + 3];
        }
        s_s[g * kThreads + tid] = apply_softcap(dot * scale, softcap);
      }
    } else {
      // masked: p == 0 below, and it must meet a finite v
      for (int g = 0; g < G; ++g) s_s[g * kThreads + tid] = kNegInf;
#pragma unroll
      for (int d = 0; d < DH; ++d) v_row[d] = 0.f;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * kThreads;
      float mx = kNegInf;
      for (int i = lane; i < kThreads; i += 32) mx = fmaxf(mx, sg[i]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < kThreads; i += 32) {
        const float pr = valid_s[i] ? expf(sg[i] - m_new) : 0.f;
        sg[i] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, each thread owning fixed (g, d) cells
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < GD) {
        const int g = idx / DH, d = idx - g * DH;
        const float* pg = s_s + g * kThreads;
        float a = acc[j] * alpha_s[g];
        for (int i = 0; i < kThreads; ++i) a += pg[i] * v_s[i * VS + d];
        acc[j] = a;
      }
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * KV + h) * GD;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < GD) {
      float l = l_s[idx / DH];
      l = l == 0.f ? 1.f : l;
      ob[idx] = from_float<T>(acc[j] / l);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* table, const void* bound, const void* q_pos,
                   const void* kv_pos, void* out, int B, int KV, int G, int P,
                   int ps, int MP, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * DH + (size_t)kThreads * (DH + 4) +
                                       (size_t)G * kThreads + 3 * (size_t)G) +
                      sizeof(int) * kThreads;
  auto kern = paged_decode_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(bound), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out), KV, G, P, ps, MP,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* pool_k,
                        const void* pool_v, const void* table, const void* bound,
                        const void* q_pos, const void* kv_pos, void* out, int B,
                        int KV, int G, int P, int ps, int MP, int window,
                        float softcap, float scale, cudaStream_t stream) {
#define REPRO_PAGED_CASE(D)                                                   \
  case D:                                                                     \
    return launch<T, D>(q, pool_k, pool_v, table, bound, q_pos, kv_pos, out, \
                        B, KV, G, P, ps, MP, window, softcap, scale, stream);
  switch (Dh) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_paged_attention(const void* q, const void* pool_k,
                                     const void* pool_v, const void* table,
                                     const void* bound, const void* q_pos,
                                     const void* kv_pos, void* out, int B, int KV,
                                     int G, int Dh, int P, int ps, int MP,
                                     int window, float softcap, float scale,
                                     int dtype, void* stream) {
  using namespace repro_torch;
  if (G * Dh > kThreads * kMaxAcc) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, pool_k, pool_v, table, bound,
                                           q_pos, kv_pos, out, B, KV, G, P, ps,
                                           MP, window, softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, pool_k, pool_v, table, bound, q_pos,
                                   kv_pos, out, B, KV, G, P, ps, MP, window,
                                   softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
