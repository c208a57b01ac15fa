// Flash decode for Hopper (sm_90a): one query token per lane against the
// lane's whole linear (slot-indexed) KV cache — the dense route's decode.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// decode_attention_pallas (pallas_call at :96, body _decode_kernel at :27).
// Same arguments after repro_torch/kernels/decode_attention/ops.py's GQA
// reshape: q (B, KV, G, Dh), k/v (B, T, KV, Dh), q_pos (B,), kv_pos (B, T),
// kv_valid (B, T) int32; output (B, KV, G, Dh) in q's dtype. Mask:
// kv_valid && kv_pos <= q_pos, and q_pos - kv_pos < window when window > 0;
// optional tanh logit softcap; f32 online softmax. A lane with no unmasked
// key writes zeros (no caller reads it: a decode row always sees its own
// token).
//
// What bounds it on this card: bytes. Each attended token costs
// 2 * Dh * sizeof(T) bytes of K/V per KV head and ~4 * G * Dh flops, far
// below the card's ~295 flop/byte ridge. At the serving batch the grid is
// only B * KV blocks (16 at B = 1 for the paper model) on 132 SMs, so the
// walk is latency bound before it is bandwidth bound; splitting the walk
// across blocks (split-KV with a merge pass) is later work.
//
// Design (from csrc/paged_attention.cu, without the page table): one block
// of 128 threads per (lane, KV head) walks the cache in tiles of 128 slots,
// one slot per thread. Each thread reads its slot's kv_pos and kv_valid
// first; a tile with no unmasked slot is skipped whole (block-uniform, an
// exact skip — the kernel reads kv_pos rather than assuming slot ==
// position, so the caller may pass any positions). A live slot's K row goes
// straight into the thread's registers with 16-byte loads and its V row into
// shared memory, and the thread computes its G logits against the G query
// rows held in shared memory. One warp per query row then does the online-
// softmax update (m, l in f32 shared memory), and the block accumulates P.V
// with each thread owning fixed (g, d) cells of acc in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // threads per block == slots per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 8;     // G * Dh <= kThreads * kMaxAcc

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const int* __restrict__ kv_valid, T* __restrict__ out, int T_len, int KV,
    int G, int window, float softcap, float scale) {
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

  const size_t lane_head = (size_t)b * KV + h;
  const T* qb = q + lane_head * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int qp = q_pos[b];
  const size_t tok_stride = (size_t)KV * DH;
  const T* kb = k + (size_t)b * T_len * tok_stride + (size_t)h * DH;
  const T* vb = v + (size_t)b * T_len * tok_stride + (size_t)h * DH;

  for (int t0 = 0; t0 < T_len; t0 += kThreads) {
    __syncthreads();  // the previous tile's readers are done with v_s / s_s
    const int t = t0 + tid;
    bool valid = false;
    if (t < T_len) {
      const int kp = kv_pos[(size_t)b * T_len + t];
      valid = kv_valid[(size_t)b * T_len + t] != 0 && kp <= qp &&
              (window <= 0 || qp - kp < window);
    }
    if (!__syncthreads_or(valid)) continue;  // block-uniform: an exact skip

    float* v_row = v_s + tid * VS;
    valid_s[tid] = valid;
    if (valid) {
      float k_reg[DH];
      const size_t off = (size_t)t * tok_stride;
#pragma unroll
      for (int d = 0; d < DH; d += Vec16<T>::N) {
        Vec16<T>::load(kb + off + d, k_reg + d);
        Vec16<T>::load(vb + off + d, v_row + d);
      }
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

  T* ob = out + lane_head * GD;
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, const void* kv_valid, void* out, int B,
                   int T_len, int KV, int G, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * DH + (size_t)kThreads * (DH + 4) +
                                       (size_t)G * kThreads + 3 * (size_t)G) +
                      sizeof(int) * kThreads;
  auto kern = decode_attention_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), T_len, KV, G,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos,
                        const void* kv_valid, void* out, int B, int T_len, int KV,
                        int G, int window, float softcap, float scale,
                        cudaStream_t stream) {
#define REPRO_DECODE_CASE(D)                                                  \
  case D:                                                                     \
    return launch<T, D>(q, k, v, q_pos, kv_pos, kv_valid, out, B, T_len, KV, \
                        G, window, softcap, scale, stream);
  switch (Dh) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(112)  // Zamba2's shared attention block
    REPRO_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* kv_pos,
                                      const void* kv_valid, void* out, int B,
                                      int T_len, int KV, int G, int Dh, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  using namespace repro_torch;
  if (B <= 0 || T_len <= 0 || G * Dh > kThreads * kMaxAcc)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, k, v, q_pos, kv_pos, kv_valid,
                                           out, B, T_len, KV, G, window, softcap,
                                           scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, k, v, q_pos, kv_pos, kv_valid, out, B,
                                   T_len, KV, G, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
