// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): the quadratic,
// attention-like work of the state-space-duality decomposition, per
// (lane, chunk, head).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py ssd_chunk_pallas
// (pallas_call at :94, body _ssd_chunk_kernel at :32). Same arguments and
// outputs, all f32 and contiguous: x (B, L, H, P), dt (B, L, H) (post-
// softplus), A (H,), Bm/Cm (B, L, N) (B/C group 0); out y_intra (B, L, H, P),
// states (B, NC, H, N, P), dA_cs (B, L, H), NC = L / Q. For one chunk of Q
// rows and one head:
//
//   dA_cs   = inclusive cumsum of dt * A                     (Q)
//   CB      = C Bᵀ                                           (Q x Q)
//   W       = CB ⊙ exp(segsum) ⊙ dt_j, zero where i < j      (Q x Q)
//   y_intra = W x                                            (Q x P)
//   state   = (exp(dA_cs[Q-1] - dA_cs) · dt · B)ᵀ x          (N x P)
//
// The segment sum is set to 0 where i < j before exp, as on the TPU: those
// entries are positive and would overflow. The inter-chunk state chain and
// the y_inter term stay in PyTorch (kernels/ssd/ops.py), as they stay in jnp
// in the JAX package.
//
// What bounds it on this card: at the main path's shapes (Q = 128, P = 64,
// N = 128 or 64) each block reads and writes ~0.1 MB and does ~8 MFLOP, so
// the work sits near the card's ridge; in f32 on the FMA units (this first
// version: no tensor cores, whose TF32 would lose the f32 agreement the
// model is held to) it is bound by the f32 rate.
//
// Design: one block of 256 threads per (head, chunk, lane), as the TPU
// grid; nothing carries across blocks. CB does not depend on the head, but
// a block per (lane, chunk) would leave the card nearly empty (8 blocks at
// a 1024-token Mamba2 prefill), so each head's block recomputes it. Shared
// memory is reused across three phases so two blocks fit on an SM:
//   1. C and B stream through shared memory in tiles of 32 state columns;
//      each thread accumulates an 8 x 8 tile of CB in registers (rows
//      8 * ti + a, columns tj + 16 * c);
//   2. the thread scales its tile by the decay and dt into W in shared
//      memory (where the C/B tiles were), and y_intra = W x is computed
//      with each thread owning 8 contiguous rows x P / 16 columns, walking
//      only the causal part (j < its last row + 1);
//   3. the decay-weighted B replaces W, and state = Bwᵀ x is computed with
//      each thread owning N / 16 x P / 16 cells.
// The cumsum is one warp's scan (4 rows per lane, then a shuffle scan), in
// f64: with fast decays it reaches |dA_cs| ~ 1e3 within a chunk, where an
// f32 cumsum's rounding (a few ulps of the running sum) would become a
// relative error of exp(dA_cs[i] - dA_cs[j]) far above f32's; each segment
// sum is taken from the f64 sums and rounded once. Rows past Q (Q < 128)
// are zero-filled, compute to zero and are not stored.

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;          // chunk rows per block, at most
constexpr int kWS = kMaxQ + 2;      // W row stride (floats): no bank conflicts on stores
constexpr int kNT = 32;             // state columns per C/B tile
constexpr int kTS = kNT + 1;        // C/B tile row stride

template <int N, int P>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ states, float* __restrict__ dA_cs, int L, int H, int Q) {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P split over 16 threads");
  static_assert(kMaxQ * kWS >= 2 * kMaxQ * kTS && kMaxQ * kWS >= kMaxQ * N,
                "the shared buffer holds the C/B tiles, W and Bw in turn");
  constexpr int NT = N < kNT ? N : kNT;
  constexpr int PC = P / 16;        // columns of P per thread
  constexpr int NA = N / 16;        // rows of the state per thread

  extern __shared__ __align__(16) float smem[];
  double* cs_s = reinterpret_cast<double*>(smem);   // kMaxQ f64 inclusive sums
  float* big = smem + 2 * kMaxQ;    // kMaxQ * kWS: C/B tiles, then W, then Bw
  float* x_s = big + kMaxQ * kWS;   // kMaxQ * P
  float* dt_s = x_s + kMaxQ * P;    // kMaxQ

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.y;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * L + (size_t)c * Q;   // the chunk's first row

  // dt and x of this (chunk, head); rows past Q are zero
  if (tid < kMaxQ) dt_s[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  for (int e = tid; e < kMaxQ * P; e += kThreads) {
    const int q = e / P, p = e - q * P;
    x_s[e] = q < Q ? x[((row0 + q) * H + h) * P + p] : 0.f;
  }
  __syncthreads();

  // inclusive cumsum of dt * A in f64: 4 rows per lane, then a warp scan
  if (tid < 32) {
    const double a = A[h];
    double v[4], run = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += (double)dt_s[4 * tid + k] * a;
      v[k] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += up;
    }
    const double excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) cs_s[4 * tid + k] = v[k] + excl;
  }
  __syncthreads();
  if (tid < Q) dA_cs[(row0 + tid) * H + h] = (float)cs_s[tid];

  // phase 1: CB = C Bᵀ, an 8 x 8 tile per thread in registers
  const int ti = tid / 16, tj = tid % 16;
  float cb[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int k = 0; k < 8; ++k) cb[a][k] = 0.f;
  float* c_t = big;
  float* b_t = big + kMaxQ * kTS;
  for (int n0 = 0; n0 < N; n0 += NT) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kMaxQ * NT; e += kThreads) {
      const int q = e / NT, n = e - q * NT;
      float cv = 0.f, bv = 0.f;
      if (q < Q) {
        const size_t off = (row0 + q) * N + n0 + n;
        cv = Cm[off];
        bv = Bm[off];
      }
      c_t[q * kTS + n] = cv;
      b_t[q * kTS + n] = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < NT; ++n) {
      float cr[8], br[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) cr[a] = c_t[(8 * ti + a) * kTS + n];
#pragma unroll
      for (int k = 0; k < 8; ++k) br[k] = b_t[(tj + 16 * k) * kTS + n];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) cb[a][k] += cr[a] * br[k];
    }
  }
  __syncthreads();  // every thread is done with the C/B tiles

  // phase 2: W = CB ⊙ exp(segsum) ⊙ dt_j (causal), then y_intra = W x
  float* w_s = big;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = 8 * ti + a;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = tj + 16 * k;
      // clamp before exp: a masked (i < j) segment sum is positive
      const float w = i >= j ? cb[a][k] * expf((float)(cs_s[i] - cs_s[j])) * dt_s[j] : 0.f;
      w_s[i * kWS + j] = w;
    }
  }
  __syncthreads();
  {
    const int tp = tid % 16;
    float acc[8][PC];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int k = 0; k < PC; ++k) acc[a][k] = 0.f;
    const int jmax = min(Q, 8 * ti + 8);   // W is zero above the diagonal
    for (int j = 0; j < jmax; ++j) {
      float xr[PC];
#pragma unroll
      for (int k = 0; k < PC; ++k) xr[k] = x_s[j * P + tp + 16 * k];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float w = w_s[(8 * ti + a) * kWS + j];
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[a][k] += w * xr[k];
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = 8 * ti + a;
      if (i < Q) {
        float* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
        for (int k = 0; k < PC; ++k) yr[tp + 16 * k] = acc[a][k];
      }
    }
  }
  __syncthreads();  // every thread is done with W

  // phase 3: Bw = exp(dA_cs[Q-1] - dA_cs) * dt * B, then state = Bwᵀ x
  float* bw_s = big;   // kMaxQ * N
  const double cs_end = cs_s[Q - 1];
  for (int e = tid; e < kMaxQ * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    bw_s[e] = q < Q ? Bm[(row0 + q) * N + n] * (expf((float)(cs_end - cs_s[q])) * dt_s[q])
                    : 0.f;
  }
  __syncthreads();
  {
    const int tn = tid / 16, tp = tid % 16;
    float acc[NA][PC];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int k = 0; k < PC; ++k) acc[a][k] = 0.f;
    for (int q = 0; q < Q; ++q) {
      float xr[PC];
#pragma unroll
      for (int k = 0; k < PC; ++k) xr[k] = x_s[q * P + tp + 16 * k];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float bw = bw_s[q * N + tn + 16 * a];
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[a][k] += bw * xr[k];
      }
    }
    float* sb = states + (((size_t)b * NC + c) * H + h) * (size_t)(N * P);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int k = 0; k < PC; ++k) sb[(tn + 16 * a) * P + tp + 16 * k] = acc[a][k];
  }
}

template <int N, int P>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, float* y, float* states, float* dA_cs, int B,
                   int L, int H, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(double) * kMaxQ +
                      sizeof(float) * ((size_t)kMaxQ * kWS + (size_t)kMaxQ * P + kMaxQ);
  auto kern = ssd_chunk_kernel<N, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H, L / Q, B);
  kern<<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, y, states, dA_cs, L, H, Q);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, float* states,
                       float* dA_cs, int B, int L, int H, int Q, cudaStream_t stream) {
#define REPRO_SSD_CASE(NN)                                                      \
  case NN:                                                                      \
    return launch<NN, P>(x, dt, A, Bm, Cm, y, states, dA_cs, B, L, H, Q, stream);
  switch (N) {
    REPRO_SSD_CASE(16)
    REPRO_SSD_CASE(32)
    REPRO_SSD_CASE(64)
    REPRO_SSD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, void* states,
                               void* dA_cs, int B, int L, int H, int P, int N, int Q,
                               void* stream) {
  using namespace repro_torch;
  if (B <= 0 || L <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || L % Q != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(dA_cs);
  if (P == 32)
    return (int)dispatch_n<32>(N, xf, dtf, af, bf, cf, yf, sf, df, B, L, H, Q, s);
  if (P == 64)
    return (int)dispatch_n<64>(N, xf, dtf, af, bf, cf, yf, sf, df, B, L, H, Q, s);
  return (int)cudaErrorInvalidValue;
}
