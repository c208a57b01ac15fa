// Position-masked flash attention for Hopper (sm_90a): S query rows against
// T keys of a linear (slot-indexed) K/V — full prefill and the dense route's
// chunk append into a full-width cache.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (pallas_call at :105, body _flash_kernel at :30).
// Same arguments, in the JAX layout (no reshape, no padding): q (B, S, H, Dh),
// k/v (B, T, KV, Dh), q_pos (B, S), kv_pos (B, T), kv_valid (B, T) int32;
// output (B, S, H, Dh) in q's dtype. Query head h reads KV head h / G
// (G = H / KV: MHA, GQA and MQA alike). Mask: kv_valid && kv_pos <= q_pos,
// and q_pos - kv_pos < window when window > 0; optional tanh logit softcap;
// f32 online softmax. A row with no unmasked key writes zeros (the TPU
// kernel writes the mean of V over its padded block there; no caller reads
// such a row).
//
// What bounds it on this card: operations. A full prefill of S = T = 1024
// tokens does ~2 * S * S * Dh flops per query head against 2 * T * Dh bytes
// of K/V per KV head — far above the card's ridge. This first version does
// its products on the f32 FMA units (no tensor cores: mma.sync/wgmma tiles
// are later work), so its ceiling is the card's f32 rate.
//
// Design: one block of 256 threads per (lane, query head, tile of 64 query
// rows), four threads per row; each thread keeps its row's query in f32
// registers. Nothing carries across blocks, so the block owns the whole walk
// over the keys, in tiles of 64: it first reads the tile's kv_pos/kv_valid
// and skips the tile when every key is masked for every row of the block
// (invalid, after the block's last query position, or before its first
// row's window) — an exact skip, so a causal prefill walks only the lower
// triangle and a chunk append only the valid prefix. A live tile's K and V
// rows go to padded shared memory with 16-byte loads; each thread computes
// 16 of its row's 64 logits, the row's four threads combine max and sum with
// warp shuffles for the online-softmax update, and each thread accumulates
// P.V for a quarter of the row's Dh columns in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                    // query rows per block
constexpr int kSubs = kThreads / kRows;      // threads per row
constexpr int kKeys = 64;                    // keys per tile
constexpr int kKeysPerSub = kKeys / kSubs;   // logits per thread per tile

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const int* __restrict__ kv_valid, T* __restrict__ out, int S, int T_len,
    int H, int KV, int window, float softcap, float scale) {
  static_assert(DH % (4 * kSubs) == 0, "Dh must split into float4 per thread");
  constexpr int KS = DH + 4;        // padded K/V row stride (floats)
  constexpr int PS = kKeys + 1;     // padded probability row stride
  constexpr int NC = DH / (4 * kSubs);  // float4 column chunks per thread
  constexpr int VN = Vec16<T>::N;
  constexpr int CPR = DH / VN;      // 16-byte chunks per K/V row

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // kKeys * KS
  float* v_s = k_s + kKeys * KS;     // kKeys * KS
  float* p_s = v_s + kKeys * KS;     // kRows * PS
  int* kp_s = reinterpret_cast<int*>(p_s + kRows * PS);  // kKeys positions
  int* ok_s = kp_s + kKeys;                                // kKeys validity
  __shared__ int qmin_s, qmax_s;

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRows;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, row = tid / kSubs, sub = tid % kSubs;
  const bool row_out = r0 + row < S;
  const int r = min(r0 + row, S - 1);  // rows past S mirror the last row
  const int qp = q_pos[(size_t)b * S + r];

  // the block's query position range decides which key tiles are live
  if (tid == 0) {
    qmin_s = 0x7fffffff;
    qmax_s = -0x7fffffff - 1;
  }
  __syncthreads();
  if (sub == 0 && row_out) {
    atomicMin(&qmin_s, qp);
    atomicMax(&qmax_s, qp);
  }
  __syncthreads();
  const int qmin = qmin_s, qmax = qmax_s;

  float q_reg[DH];
  const T* qrow = q + (((size_t)b * S + r) * H + h) * DH;
#pragma unroll
  for (int d = 0; d < DH; d += VN) Vec16<T>::load(qrow + d, q_reg + d);

  float acc[4 * NC];
#pragma unroll
  for (int j = 0; j < 4 * NC; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done with shared memory
    int live = 0;
    if (tid < kKeys) {
      const int t = t0 + tid;
      int kp = 0, ok = 0;
      if (t < T_len) {
        kp = kv_pos[(size_t)b * T_len + t];
        ok = kv_valid[(size_t)b * T_len + t] != 0;
      }
      kp_s[tid] = kp;
      ok_s[tid] = ok;
      // unmasked for some row only if kp <= q and q - kp < window for a q
      // in [qmin, qmax]
      live = ok && kp <= qmax && (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(live)) continue;  // block-uniform: an exact skip

    for (int c = tid; c < kKeys * CPR; c += kThreads) {
      const int kk = c / CPR, d = (c - kk * CPR) * VN;
      const int t = t0 + kk;
      float* kd = k_s + kk * KS + d;
      float* vd = v_s + kk * KS + d;
      if (t < T_len) {
        const size_t off = (((size_t)b * T_len + t) * KV + hk) * DH + d;
        Vec16<T>::load(k + off, kd);
        Vec16<T>::load(v + off, vd);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kd[e] = vd[e] = 0.f;
      }
    }
    __syncthreads();

    float s[kKeysPerSub];
    unsigned ok_bits = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerSub; ++i) {
      const int kk = sub + kSubs * i;
      const int kp = kp_s[kk];
      const bool ok = ok_s[kk] && kp <= qp && (window <= 0 || qp - kp < window);
      float x = kNegInf;
      if (ok) {
        const float4* k4 = reinterpret_cast<const float4*>(k_s + kk * KS);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 kv = k4[c];
          dot += q_reg[4 * c] * kv.x + q_reg[4 * c + 1] * kv.y +
                 q_reg[4 * c + 2] * kv.z + q_reg[4 * c + 3] * kv.w;
        }
        x = apply_softcap(dot * scale, softcap);
        ok_bits |= 1u << i;
      }
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    // the row's four threads are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerSub; ++i) {
      const float pr = (ok_bits >> i) & 1u ? expf(s[i] - m_new) : 0.f;
      p_s[row * PS + sub + kSubs * i] = pr;
      sum += pr;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the row's probabilities are visible to its four threads

#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[j] *= alpha;
    const float* prow = p_s + row * PS;
    for (int kk = 0; kk < kKeys; ++kk) {
      const float pr = prow[kk];
      const float4* v4 = reinterpret_cast<const float4*>(v_s + kk * KS);
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float4 vv = v4[sub + kSubs * jj];
        acc[4 * jj] += pr * vv.x;
        acc[4 * jj + 1] += pr * vv.y;
        acc[4 * jj + 2] += pr * vv.z;
        acc[4 * jj + 3] += pr * vv.w;
      }
    }
  }

  if (row_out) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + (((size_t)b * S + r) * H + h) * DH;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int d = 4 * (sub + kSubs * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[d + e] = from_float<T>(acc[4 * jj + e] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, const void* kv_valid, void* out, int B,
                   int S, int T_len, int H, int KV, int window, float softcap,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kKeys * (DH + 4) +
                                       (size_t)kRows * (kKeys + 1)) +
                      sizeof(int) * 2 * kKeys;
  auto kern = flash_attention_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, H, (S + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), S, T_len, H, KV,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos,
                        const void* kv_valid, void* out, int B, int S, int T_len,
                        int H, int KV, int window, float softcap, float scale,
                        cudaStream_t stream) {
#define REPRO_FLASH_CASE(D)                                                   \
  case D:                                                                     \
    return launch<T, D>(q, k, v, q_pos, kv_pos, kv_valid, out, B, S, T_len, \
                        H, KV, window, softcap, scale, stream);
  switch (Dh) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(112)  // Zamba2's shared attention block
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* kv_pos,
                                     const void* kv_valid, void* out, int B, int S,
                                     int T_len, int H, int KV, int Dh, int window,
                                     float softcap, float scale, int dtype,
                                     void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, k, v, q_pos, kv_pos, kv_valid,
                                           out, B, S, T_len, H, KV, window,
                                           softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, k, v, q_pos, kv_pos, kv_valid, out, B,
                                   S, T_len, H, KV, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
