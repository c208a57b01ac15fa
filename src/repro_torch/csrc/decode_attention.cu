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
// below the card's ~295 flop/byte ridge. A block per (lane, KV head) would
// give 16 blocks at B = 1 for the paper model on 132 SMs, a walk bound by
// one block's load latency, not by bandwidth.
//
// Design: a split walk (csrc/split_decode.cuh). One cluster of `splits`
// blocks of 8 warps per (lane, KV head); the host picks `splits`
// (kernels/decode_attention/kernel.py decode_plan): 16 clusters of 8 at
// B = 1 for the paper model (256 slots per block: one 32-slot sub-tile per
// warp), 32 of 4 for Zamba2, 128 of 1 at B = 8. The R = G query rows of the
// KV head go together. Each lane reads its slot's kv_pos and kv_valid a
// sub-tile ahead; a sub-tile with no unmasked slot is skipped whole
// (warp-uniform, an exact skip — the kernel reads kv_pos rather than
// assuming slot == position, so the caller may pass any positions), so a
// split past the valid slots reads no K/V and contributes the empty state.
// Each rank of the cluster normalises and writes its share of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "split_decode.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRowsDh = 1024;            // G * Dh per block
constexpr int kMaxPairs = kMaxRowsDh / 64;  // accumulator pairs per lane
// warps per block: 8, so that a 256-slot split is one sub-tile per warp,
// but 4 for rows over 256 bytes (f32 at Dh 112 and 128), whose staged K/V
// rows would not fit 8 warps' shared memory
template <typename T, int DH>
constexpr int warps() {
  return DH * (int)sizeof(T) > 256 ? 4 : 8;
}

template <typename T, int DH, int kWarps = warps<T, DH>(), int kThreads = 32 * kWarps>
__global__ void __launch_bounds__(kThreads) decode_attention_split(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const int* __restrict__ kv_valid, T* __restrict__ out, int T_len, int KV, int G,
    int window, float softcap, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int R = G;  // the KV head's query rows
  const split::Smem<T, DH, kWarps> sm(smem_raw, R, gridDim.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t lane_head = (size_t)b * KV + h;
  int lo, hi;
  split::split_range(T_len, (int)gridDim.x, (int)blockIdx.x, lo, hi);
  const int* pos_b = kv_pos + (size_t)b * T_len;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const size_t tok_stride = (size_t)KV * DH;
  const T* kb = k + (size_t)b * T_len * tok_stride + (size_t)h * DH;
  const T* vb = v + (size_t)b * T_len * tok_stride + (size_t)h * DH;
  const int qp = q_pos[b];
  auto attended = [&](int t, int kp, int valid) {
    return t < hi && valid != 0 && kp <= qp && (window <= 0 || qp - kp < window);
  };
  // each warp's first sub-tile: its slots' metadata loads with q, and its
  // K/V copies start before q is stored; later sub-tiles' metadata loads a
  // step ahead
  const int first = lo + warp * 32;
  int kp = 0, valid = 0, kp_next = 0, valid_next = 0;
  if (first + lane < hi) {
    kp = pos_b[first + lane];
    valid = valid_b[first + lane];
  }
  if (first + kThreads + lane < hi) {
    kp_next = pos_b[first + kThreads + lane];
    valid_next = valid_b[first + kThreads + lane];
  }
  const size_t q0 = lane_head * R * DH;
  split::load_q<kMaxRowsDh>(sm, R, q, [&](int r) { return q0 + (size_t)r * DH; }, [&] {
    const bool live = attended(first + lane, kp, valid);
    if (__any_sync(0xffffffffu, live))
      split::stage(sm, live, live ? (size_t)(first + lane) * tok_stride : 0, kb, vb);
  });
  split::begin(sm, R);
  float acc[2 * kMaxPairs];
#pragma unroll
  for (int j = 0; j < 2 * kMaxPairs; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int base = first; base < hi; base += kThreads) {
    const int t = base + lane;
    const bool live = attended(t, kp, valid);
    kp = kp_next;
    valid = valid_next;
    if (t + 2 * kThreads < hi) {
      kp_next = pos_b[t + 2 * kThreads];
      valid_next = valid_b[t + 2 * kThreads];
    }
    if (!__any_sync(0xffffffffu, live)) continue;  // warp-uniform: an exact skip
    if (base != first) split::stage(sm, live, live ? (size_t)t * tok_stride : 0, kb, vb);
    split::warp_step<kMaxPairs>(sm, R, live, [](int) { return true; }, scale, softcap, acc);
  }

  split::block_merge<kMaxPairs>(sm, R, acc);
  T* ob = out + lane_head * R * DH;
  split::cluster_merge(
      sm, R,
      [&](int c, int, float a, float l) { ob[c] = from_float<T>(a / (l == 0.f ? 1.f : l)); },
      [](int, float, float) {});
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, const void* kv_valid, void* out, int B, int T_len,
                   int KV, int G, int splits, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr int kWarps = warps<T, DH>();
  return split::launch_split<kWarps>(
      decode_attention_split<T, DH>, splits, KV, B,
      split::Smem<T, DH, kWarps>::bytes(G, splits), stream,
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<const int*>(kv_valid), static_cast<T*>(out), T_len, KV, G, window,
      softcap, scale);
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, const void* kv_valid,
                        void* out, int B, int T_len, int KV, int G, int splits, int window,
                        float softcap, float scale, cudaStream_t stream) {
#define REPRO_DECODE_CASE(D)                                                           \
  case D:                                                                              \
    return launch<T, D>(q, k, v, q_pos, kv_pos, kv_valid, out, B, T_len, KV, G, splits, \
                        window, softcap, scale, stream);
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

// Plain C entry point (bound with ctypes). Launches one cluster launch on
// `stream` (grid (splits, KV, B), clusters of splits blocks), allocates
// nothing, does not synchronise; returns the launch's error.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* kv_pos,
                                      const void* kv_valid, void* out, int B, int T_len,
                                      int KV, int G, int Dh, int splits, int window,
                                      float softcap, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || T_len <= 0 || G * Dh > kMaxRowsDh || splits < 1 ||
      splits > split::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, k, v, q_pos, kv_pos, kv_valid, out, B,
                                           T_len, KV, G, splits, window, softcap, scale, s);
  if (dtype == kFloat32)
    return (int)dispatch_dh<float>(Dh, q, k, v, q_pos, kv_pos, kv_valid, out, B, T_len, KV,
                                   G, splits, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
