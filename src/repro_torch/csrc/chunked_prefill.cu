// Chunked paged prefill attention for Hopper (sm_90a): an S-token prompt
// chunk against a paged KV pool that already holds the chunk's own K/V.
//
// Replaces the TPU kernel repro/kernels/chunked_prefill/kernel.py
// chunked_prefill_pallas (pallas_call at :154, body _chunked_prefill_kernel
// at :48). Same arguments after repro_torch/kernels/chunked_prefill/ops.py's
// reshapes: q (B, KV, S*G, Dh) — chunk rows and the G query heads of one KV
// head as one query block — pools (P, ps, KV, Dh), table (B, MP),
// bound (B,) = clip(ceil((p0 + max(true_len, 1)) / ps), 1, MP), p0 (B,);
// output (B, KV, S*G, Dh) in q's dtype. The mask is positional only: row r
// queries position p0 + r / G and slot t holds position t (the paged layout
// invariant); optional sliding window and tanh logit softcap; f32 online
// softmax. Rows at or past true_len * G are padding: their output is garbage
// that no caller reads.
//
// What bounds it on this card: operations, at prefill sizes. A 256-row chunk
// against a ~1k-token prefix does ~4 * S * G * kv_len * Dh flops per KV head
// against 2 * kv_len * Dh * sizeof(T) bytes of K/V, well above the card's
// ridge. This first version does them on the f32 FMA units (no tensor
// cores: wgmma/mma.sync tiles are later work), so its ceiling is the card's
// f32 rate, not its bf16 tensor-core rate.
//
// Design: one block of 256 threads per (lane, KV head, tile of 64 query
// rows), four threads per row. Each thread keeps its row's query in f32
// registers. The block walks the keys the tile can see — from the window's
// start for its first row to min(bound * ps, last row's position + 1), which
// skips the causally masked upper part of the prefix exactly — in tiles of
// 64 keys: the block loads the tile's K and V rows (each thread dereferences
// table[b, t / ps] itself; 16-byte loads) into padded shared memory, each
// thread computes 16 of its row's 64 logits, the row's four threads combine
// max and sum with warp shuffles for the online-softmax update, and each
// thread accumulates P.V for a quarter of the row's Dh columns in f32
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                    // query rows (of S*G) per block
constexpr int kSubs = kThreads / kRows;      // threads per row
constexpr int kKeys = 64;                    // keys per tile
constexpr int kKeysPerSub = kKeys / kSubs;   // logits per thread per tile

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ bound, const int* __restrict__ p0,
    T* __restrict__ out, int KV, int SG, int G, int P, int ps, int MP,
    int window, float softcap, float scale) {
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
  int* key_ok_s = reinterpret_cast<int*>(p_s + kRows * PS);  // kKeys

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, row = tid / kSubs, sub = tid % kSubs;
  const int r = min(r0 + row, SG - 1);  // rows past S*G mirror the last row
  const bool row_out = r0 + row < SG;
  const int pb = p0[b];
  const int qp = pb + r / G;
  const int qp_min = pb + r0 / G;
  const int qp_max = pb + (min(r0 + kRows, SG) - 1) / G;
  const int hi = min(bound[b] * ps, qp_max + 1);
  const int lo = window > 0 ? max(0, qp_min - window + 1) : 0;
  const size_t tok_stride = (size_t)KV * DH;

  float q_reg[DH];
  const T* qrow = q + (((size_t)b * KV + h) * SG + r) * DH;
#pragma unroll
  for (int d = 0; d < DH; d += VN) Vec16<T>::load(qrow + d, q_reg + d);

  float acc[4 * NC];
#pragma unroll
  for (int j = 0; j < 4 * NC; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done with k_s / v_s
    for (int c = tid; c < kKeys * CPR; c += kThreads) {
      const int kk = c / CPR, d = (c - kk * CPR) * VN;
      const int t = t0 + kk;
      float* kd = k_s + kk * KS + d;
      float* vd = v_s + kk * KS + d;
      bool loaded = false;
      if (t < hi) {
        const int pg = t / ps;
        const int phys = table[(size_t)b * MP + pg];
        if (phys >= 0 && phys < P) {
          const size_t off = ((size_t)phys * ps + (t - pg * ps)) * tok_stride +
                             (size_t)h * DH + d;
          Vec16<T>::load(pool_k + off, kd);
          Vec16<T>::load(pool_v + off, vd);
          loaded = true;
        }
      }
      if (!loaded) {
#pragma unroll
        for (int e = 0; e < VN; ++e) kd[e] = vd[e] = 0.f;
      }
      if (d == 0) key_ok_s[kk] = loaded;
    }
    __syncthreads();

    float s[kKeysPerSub];
    unsigned ok_bits = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerSub; ++i) {
      const int kk = sub + kSubs * i;
      const int kp = t0 + kk;
      const bool ok = key_ok_s[kk] && kp <= qp && (window <= 0 || qp - kp < window);
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
    T* orow = out + (((size_t)b * KV + h) * SG + r) * DH;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int d = 4 * (sub + kSubs * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[d + e] = from_float<T>(acc[4 * jj + e] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* table, const void* bound, const void* p0,
                   void* out, int B, int KV, int SG, int G, int P, int ps,
                   int MP, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kKeys * (DH + 4) +
                                       (size_t)kRows * (kKeys + 1)) +
                      sizeof(int) * kKeys;
  auto kern = chunked_prefill_kernel<T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KV, (SG + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(bound), static_cast<const int*>(p0),
      static_cast<T*>(out), KV, SG, G, P, ps, MP, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* pool_k,
                        const void* pool_v, const void* table, const void* bound,
                        const void* p0, void* out, int B, int KV, int SG, int G,
                        int P, int ps, int MP, int window, float softcap,
                        float scale, cudaStream_t stream) {
#define REPRO_CHUNK_CASE(D)                                                    \
  case D:                                                                      \
    return launch<T, D>(q, pool_k, pool_v, table, bound, p0, out, B, KV, SG, \
                        G, P, ps, MP, window, softcap, scale, stream);
  switch (Dh) {
    REPRO_CHUNK_CASE(16)
    REPRO_CHUNK_CASE(32)
    REPRO_CHUNK_CASE(64)
    REPRO_CHUNK_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_CHUNK_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_chunked_prefill(const void* q, const void* pool_k,
                                     const void* pool_v, const void* table,
                                     const void* bound, const void* p0, void* out,
                                     int B, int KV, int SG, int G, int Dh, int P,
                                     int ps, int MP, int window, float softcap,
                                     float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (SG <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, pool_k, pool_v, table, bound,
                                           p0, out, B, KV, SG, G, P, ps, MP,
                                           window, softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, pool_k, pool_v, table, bound, p0, out,
                                   B, KV, SG, G, P, ps, MP, window, softcap,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
