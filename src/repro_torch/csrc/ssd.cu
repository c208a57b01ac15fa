// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a): the quadratic,
// attention-like work of the state-space-duality decomposition, per
// (lane, chunk, group of heads).
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
// What bounds it on this card: at Mamba2's shape (L 1024, H 64, P 64,
// N 128) the kernel moves 51.9 MB (x in, y and the states out: 15.5 us at
// 3.35 TB/s) and the TPU kernel's products are 4.3 GFLOP (64 us on the
// 67 TFLOP/s f32 FMA units). Here W x and the states run on the TF32
// tensor cores, three products per term (below), over the causal tiles
// (~5 GFLOP, 10 us at the 495 TFLOP/s TF32 rate), and CB once per
// cluster of head groups on the FP64 tensor cores (0.08 GFLOP, 1.1 us at
// 67 TFLOP/s). So the work sits near the ridge, and the loads must
// overlap the products.
//
// Design. One block of 16 warps per (lane, chunk, group of `hg` heads),
// the host picking `hg` so that the grid is one wave of the card
// (kernels/ssd/kernel.py ssd_plan: 4 heads at Mamba2's 1024-token prefill,
// 7 at Zamba2's, 128 blocks each). CB does not depend on the head: the
// blocks of one chunk are launched as clusters of CS = 4 (2, 1 where the
// head groups or the card's cluster occupancy do not allow it), and rank r
// takes the CB tiles of the row-tile pairs (p, 7 - p), p % CS == r, and
// pushes each into the other blocks' shared memory (st.async, completing
// on their mbarrier). W x and the state product run on the tensor cores as
// mma.sync.m16n8k8 with TF32 operands and f32 sums, each f32 operand split
// into a_hi = tf32(a) and a_lo = tf32(a - a_hi) (round to nearest) and each
// product taken as a_hi b_hi + a_hi b_lo + a_lo b_hi, summed from zero per
// 8-deep step and then added in f32: one-pass TF32 (10 mantissa bits)
// misses the f32 agreement the model is held to (1e-4 (1 + |ref|)) by
// ~30x, the split meets it (kernels/ssd/ref.py ssd_chunk_tf32,
// tests/test_torch_ssd_split.py). CB itself runs on the FP64 tensor cores
// (mma.sync.m8n8k4.f64: the f32 inputs' products exact, f64 sums, one
// rounding to f32): W = CB ⊙ exp(segsum) ⊙ dt multiplies CB by dt, and at
// large decays (dt ~ 50-150) CB taken in split TF32 (whose tensor-core f32
// sums truncate) was off the f32 version by more than the bound.
// Per block:
//   0. the cluster's mbarriers are armed; the C rows of the block's own row
//      tiles, B (row stride N + 4: the fragment loads hit 32 banks), the
//      first head's x and dt are copied in with cp.async (rows past Q
//      zero-filled);
//   1. the block's CB tiles (tile k to warp k % 16), each stored in
//      fragment order and pushed to the cluster; then every block waits
//      for the others' tiles;
// then per head, with the next head's x and dt copied in meanwhile (by the
// warps with the lighter W x):
//   2. warp 0 takes the cumsum of dt * A in f64 (4 rows per lane, then a
//      shuffle scan: with fast decays |dA_cs| reaches ~1e3 within a chunk,
//      where an f32 cumsum's rounding would dominate exp(dA_cs[i] -
//      dA_cs[j])) and the end decay s_q = exp(dA_cs[Q-1] - dA_cs[q]) dt_q;
//      all warps split x into x_hi and x_lo once (row pairs interleaved, so
//      one 16-byte load is a thread's B fragment pair);
//   3. warp w takes W x over row tile rt = w % 4 (w % 8 < 4) or 7 - w % 4
//      and half w / 8 of P: each scheduler's four warps own tiles s and
//      7 - s twice, 18 causal column tiles. W is formed in registers from
//      the CB tile (the C fragment of a 16 x 8 tile, with its two columns
//      per thread taken as k-slots t and t + 4, is the A fragment of one
//      8-deep step of W x when x's rows are read in the same order), as
//      exp2 of the segment sum taken in f64 and scaled by log2 e before its
//      one rounding; then split;
//   4. state = (s ⊙ B)ᵀ x: each warp MW 16-row tiles of the N rows by NW
//      tiles of P, A fragments read from B with the scale applied, then
//      split; y and the states leave as float2 stores, 32 contiguous bytes
//      per row, dA_cs at the head's end.
// Rows past Q (Q < 128) are zero-filled, compute to zero and are not
// stored. No atomics and fixed orders: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 128;  // chunk rows per block, at most (8 tiles of 16)

// Per-phase clock64 stamps, compiled in only with -DREPRO_SSD_STAMPS (by
// scripts/ssd_phases.py): lane 0 of each warp writes stamp k to slot k of
// its warp's kStampSlots; slot 3 + 8 hl + i is head hl's i-th stamp.
#ifdef REPRO_SSD_STAMPS
constexpr int kStampSlots = 80;
__device__ long long g_stamps[1 << 20];
#define SSD_STAMP(k)                        \
  do {                                      \
    if (lane == 0) stamps_w[k] = clock64(); \
  } while (0)
#else
#define SSD_STAMP(k) \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !pred (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// f32 -> TF32, round to nearest with ties away from zero (what
// cvt.rna.tf32.f32 does, in two integer operations where that takes four):
// add half of the 13 dropped bits to the magnitude, then drop them. The
// operands here are finite, so no NaN or overflow case arises.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~21 mantissa bits, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

constexpr double kLog2eD = 1.4426950408889634;

// 2^x on the special-function unit (relative error below 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// c += a . b (16 x 8 TF32 by 8 x 8 TF32, f32 sums). Fragments (lane = 4 g + t):
//   A: a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (row g+8, k t+4);
//   B: b0 (k t, col g), b1 (k t+4, col g);
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in split TF32: a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo
// dropped), summed on the tensor cores from zero and then added to c in
// f32. The tensor cores' own f32 sums round toward zero; a fresh sum per
// 8-deep step keeps that error at the step's magnitude instead of letting
// it build up along the whole product.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] += t[k];
}

constexpr int kCBTiles = 72;  // causal 16 x 8 tiles of CB: 2 rt + 2 in row tile rt

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Shared memory of one block (the f64 sums first): cs and cs log2(e) (kQ
// doubles each), the mbarrier the CB tiles pushed by the cluster complete
// on (16 bytes), then floats: sw (kQ), dt (2 x kQ: this head's and the
// next one's), B
// (kQ x SB), the raw x copy (kQ x SX), the split x (kQ / 2 row pairs of
// SP: per column c of rows 2p, 2p + 1 the four values hi, hi, lo, lo, so
// one 16-byte load is a thread's whole B fragment pair; the room holds C,
// kQ x SB, until CB is taken), and CB's causal tiles in fragment order
// (a lane's four values contiguous).
template <int N, int P>
struct Layout {
  static constexpr int SB = N + 4;      // row stride of B and C
  static constexpr int SX = P + 4;      // row stride of the raw x copy
  static constexpr int SP = 4 * P + 8;  // row-pair stride of the split x
  static constexpr int kSplit = kQ / 2 * SP > kQ * SB ? kQ / 2 * SP : kQ * SB;
  static constexpr size_t bytes() {
    return 2 * sizeof(double) * kQ + 16 +
           sizeof(float) * (3 * kQ + (size_t)kQ * SB + (size_t)kQ * SX + (size_t)kSplit +
                            (size_t)kCBTiles * 128);
  }
};

// d += a . b (8 x 4 f64 by 4 x 8 f64, f64 sums: the FP64 tensor cores).
// Fragments (lane = 4 g + t): a (row g, k t), b (k t, col g), d0, d1 (row
// g, cols 2t, 2t+1).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// One 16 x 8 tile (rows i0.., columns j0..) of CB = C Bᵀ on the FP64
// tensor cores: products of the f32 inputs exact in f64, sums in f64 (two
// chains over alternate 4-deep steps), rounded to f32 once; returns the
// thread's C fragment (rows i0 + g and i0 + g + 8, columns j0 + 2 t and
// the next), which is the two 8 x 8 f64 tiles' fragments stacked.
template <int N, int SB>
__device__ __forceinline__ float4 cb_tile(const float* __restrict__ c_s,
                                          const float* __restrict__ b_s, int i0, int j0, int gq,
                                          int tq) {
  double top[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, bot[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
  const float* ca = c_s + (i0 + gq) * SB + tq;
  const float* br = b_s + (j0 + gq) * SB + tq;
#pragma unroll 8
  for (int n = 0; n < N; n += 4) {
    const int e = (n >> 2) & 1;
    const double b = br[n];
    mma_f64(top[e], ca[n], b);
    mma_f64(bot[e], ca[8 * SB + n], b);
  }
  return make_float4((float)(top[0][0] + top[1][0]), (float)(top[0][1] + top[1][1]),
                     (float)(bot[0][0] + bot[1][0]), (float)(bot[0][1] + bot[1][1]));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_mma(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ states, float* __restrict__ dA_cs, int L, int H, int Q, int hg) {
  static_assert(N % 16 == 0 && N <= 128 && P % 8 == 0, "N in 16..128, P a multiple of 8");
  using Lay = Layout<N, P>;
  constexpr int SB = Lay::SB, SX = Lay::SX, SP = Lay::SP;
  constexpr int NT = P / 8;                         // 8-column tiles of P
  constexpr int MT = N / 16;                        // 16-row tiles of the state
  constexpr int MW = MT >= 2 ? 2 : 1;               // state row tiles per warp
  constexpr int MG = MT / MW;                       // groups of them
  constexpr int NW = NT * MG / kWarps > 0 ? NT * MG / kWarps : 1;  // P tiles per warp
  constexpr int NH = NT / 2;                        // P tiles per warp in W x

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs_s = reinterpret_cast<double*>(smem_raw);
  double* cl_s = cs_s + kQ;                                // cs_s * log2(e)
  uint64_t* bar = reinterpret_cast<uint64_t*>(cl_s + kQ);  // the CB tiles pushed here
  float* sw_s = reinterpret_cast<float*>(bar + 2);
  float* dt_s = sw_s + kQ;           // 2 x kQ
  float* b_s = dt_s + 2 * kQ;        // kQ x SB
  float* xr_s = b_s + kQ * SB;       // kQ x SX
  float* xs_s = xr_s + kQ * SX;      // kQ / 2 x SP; C before the heads
  float* cb_s = xs_s + Lay::kSplit;  // kCBTiles x 128
  float* c_s = xs_s;

  const int g0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.y;
  const int nh = min(hg, H - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t row0 = (size_t)b * L + (size_t)c * Q;  // the chunk's first row
#ifdef REPRO_SSD_STAMPS
  long long* stamps_w =
      g_stamps + ((((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                      kWarps + warp) * kStampSlots;
#endif
  SSD_STAMP(0);

  // x and dt of head h (rows past Q zero-filled) -> xr_s, dt_s[buf], by
  // the nt threads t < nt
  auto stage_head = [&](int h, int buf, int t, int nt) {
    constexpr int CPR = P / 4;
    for (int e = t; e < kQ * CPR; e += nt) {
      const int q = e / CPR, k = e - q * CPR;
      const bool ok = q < Q;
      cp_async16(xr_s + q * SX + 4 * k, ok ? x + ((row0 + q) * H + h) * P + 4 * k : x, ok);
    }
    if (t < kQ) {
      const bool ok = t < Q;
      cp_async4(dt_s + buf * kQ + t, ok ? dt + (row0 + t) * H + h : dt, ok);
    }
    cp_async_commit();
  };

  // The cluster (CS blocks of one chunk and lane, consecutive head groups)
  // shares CB: rank r takes the row-tile pairs (p, 7 - p) with p % CS == r,
  // 18 causal column tiles each, and pushes every tile it takes into the
  // other blocks' shared memory (st.async, completing on their mbarrier).
  const int CS = cluster_size(), rank = cluster_rank();
  const int n_own = 18 * (4 / CS);  // causal tiles this block takes
  auto owns = [&](int rt) { return (rt < 4 ? rt : 7 - rt) % CS == rank; };
  if (CS > 1) {
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)((kCBTiles - n_own) * 128 * sizeof(float));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bar)), "r"(bytes) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    cluster_arrive_relaxed();
  }

  // 0. C rows of this block's row tiles, B, the first head's x and dt
  {
    constexpr int CPR = N / 4;
    for (int e = tid; e < kQ * CPR; e += kThreads) {
      const int q = e / CPR, k = e - q * CPR;
      const bool ok = q < Q;
      const size_t off = ok ? (row0 + q) * N + 4 * k : 0;
      if (owns(q >> 4)) cp_async16(c_s + q * SB + 4 * k, Cm + off, ok);
      cp_async16(b_s + q * SB + 4 * k, Bm + off, ok);
    }
    cp_async_commit();
  }
  if (nh > 0) {
    stage_head(g0, 0, tid, kThreads);
  } else {
    cp_async_commit();  // a block past the last head group only takes CB tiles
  }
  cp_async_wait_one();  // C and B have landed (the first head's x may not have)
  __syncthreads();
  SSD_STAMP(1);

  // 1. this block's CB tiles on the FP64 tensor cores (CB is the one product
  // not taken in split TF32: see above), tile k of its n_own to warp k % 16,
  // each stored in fragment order here and pushed to the others
  if (CS > 1) cluster_wait();  // every block's mbarrier is armed
  SSD_STAMP(70);
  for (int k = warp; k < n_own; k += kWarps) {
    const int pi = k / 18, r = k - 18 * pi, p = rank + CS * pi;
    const int rt = r < 2 * p + 2 ? p : 7 - p, jt = r < 2 * p + 2 ? r : r - (2 * p + 2);
    const float4 v = cb_tile<N, SB>(c_s, b_s, 16 * rt, 8 * jt, gq, tq);
    float* dst = cb_s + (rt * (rt + 1) + jt) * 128 + 4 * lane;
    *reinterpret_cast<float4*>(dst) = v;
    for (int peer = 0; peer < CS; ++peer) {
      if (peer == rank) continue;
      uint32_t rdst, rbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rdst) : "r"(smem_addr(dst)), "r"(peer));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rbar) : "r"(smem_addr(bar)), "r"(peer));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
          "[%5];\n" ::"r"(rdst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
          "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(rbar)
          : "memory");
    }
  }
  SSD_STAMP(71);
  if (CS > 1) {
    // every thread waits for the other blocks' tiles (acquiring them); a
    // lost push would leave the barrier open: fail loudly, never hang
    uint32_t done = 0;
    for (long long spin = 0; !done; ++spin) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar))
          : "memory");
      if (spin > (1LL << 24)) __trap();
    }
    cluster_arrive_relaxed();  // this block's tiles have all landed (waited at the end)
  }

  // per head, warp w takes W x over row tile rt = w % 4 (w % 8 < 4) or
  // 7 - w % 4 and half w / 8 of P (each scheduler's four warps own tiles s
  // and 7 - s twice: 18 causal column tiles), then its state tiles
  const int rt = (warp & 4) ? 7 - (warp & 3) : (warp & 3), half = warp >> 3;
  const int i0 = 16 * rt, ncol = 2 * rt + 2;
  const float* cb_w = cb_s + rt * (rt + 1) * 128;  // row tile rt's first tile
  SSD_STAMP(2);
  const int mg = warp % MG, nt0 = (warp / MG) * NW;  // this warp's state tiles
  for (int hl = 0; hl < nh; ++hl) {
    const int h = g0 + hl, buf = hl & 1;
    const float* dt_h = dt_s + buf * kQ;
    cp_async_wait_all();  // this head's x and dt have landed
    __syncthreads();      // ... for every thread; every warp is done with C (first
                          // head) or the last head's x, cs and sw
    SSD_STAMP(3 + 8 * hl);

    // 2. warp 0: the f64 cumsum, dA_cs and the end decay; all: split x
    if (warp == 0) {
      const double a = A[h];
      double v[4], run = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += (double)dt_h[4 * lane + k] * a;
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const double excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cs_s[4 * lane + k] = v[k] + excl;
        cl_s[4 * lane + k] = (v[k] + excl) * kLog2eD;
      }
      __syncwarp();
      const double cs_end = cs_s[Q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = 4 * lane + k;
        sw_s[q] = q < Q ? expf((float)(cs_end - cs_s[q])) * dt_h[q] : 0.f;
      }
    }
    SSD_STAMP(4 + 8 * hl);
    for (int e = tid; e < kQ / 2 * P; e += kThreads) {
      const int pr = e / P, col = e - pr * P;
      uint4 o;
      split(xr_s[2 * pr * SX + col], o.x, o.z);
      split(xr_s[(2 * pr + 1) * SX + col], o.y, o.w);
      *reinterpret_cast<uint4*>(xs_s + pr * SP + 4 * col) = o;
    }
    SSD_STAMP(5 + 8 * hl);
    __syncthreads();
    SSD_STAMP(6 + 8 * hl);
    // the next head's x and dt land while this head's products run; the
    // warps with the lighter W x (row tiles 0..3) issue the copies
    if (rt < 4) {
      if (hl + 1 < nh) stage_head(h + 1, buf ^ 1, 32 * ((warp & 3) + 4 * half) + lane, kThreads / 2);
      else cp_async_commit();
    }
    SSD_STAMP(7 + 8 * hl);

    // 3. y_intra = W x over this warp's row tile and half of P, causal
    // column tiles only (W is formed by both halves' warps)
    {
      const int ia = i0 + gq, ib = ia + 8;
      const double ca = cl_s[ia], cbb = cl_s[ib];
      float acc[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
      auto step = [&](int jt) {
        const int j = 8 * jt + 2 * tq;  // the thread's columns j, j + 1
        const float4 cbv = *reinterpret_cast<const float4*>(cb_w + jt * 128 + 4 * lane);
        const double cj0 = cl_s[j], cj1 = cl_s[j + 1];
        const float d0 = dt_h[j], d1 = dt_h[j + 1];
        // exp(segsum) as 2^(segsum log2 e), the f64 difference rounded once;
        // clamp before exp: a masked (i < j) segment sum is positive
        auto w = [](float cbv, int i, double ci, int jj, double cj, float d) {
          const bool ok = i >= jj;
          return ok ? cbv * exp2_approx((float)(ci - cj)) * d : 0.f;
        };
        uint32_t ah[4], al[4];
        split(w(cbv.x, ia, ca, j, cj0, d0), ah[0], al[0]);
        split(w(cbv.z, ib, cbb, j, cj0, d0), ah[1], al[1]);
        split(w(cbv.y, ia, ca, j + 1, cj1, d1), ah[2], al[2]);
        split(w(cbv.w, ib, cbb, j + 1, cj1, d1), ah[3], al[3]);
        const float* xp = xs_s + (4 * jt + tq) * SP + 4 * gq + 32 * NH * half;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const uint4 v = *reinterpret_cast<const uint4*>(xp + 32 * n);
          mma3(acc[n], ah, al, v.x, v.y, v.z, v.w);
        }
      };
#pragma unroll 1
      for (int jt = 0; jt < ncol; jt += 2) {  // ncol is even: two tiles a step
        step(jt);
        step(jt + 1);
      }
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = 8 * (NH * half + n) + 2 * tq;
        if (ia < Q)
          *reinterpret_cast<float2*>(y + ((row0 + ia) * H + h) * P + col) =
              make_float2(acc[n][0], acc[n][1]);
        if (ib < Q)
          *reinterpret_cast<float2*>(y + ((row0 + ib) * H + h) * P + col) =
              make_float2(acc[n][2], acc[n][3]);
      }
    }

    SSD_STAMP(8 + 8 * hl);
    // 4. state = (s ⊙ B)ᵀ x: this warp's MW 16-row tiles of the N rows by
    // its NW P tiles, each B fragment pair read once for the MW tiles
    if (nt0 < NT) {
      float acc[MW][NW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.f;
#pragma unroll 2
      for (int q0 = 0; q0 < kQ; q0 += 8) {
        const int qa = q0 + 2 * tq;  // k-slots t and t + 4: rows qa, qa + 1
        const float sa = sw_s[qa], sb = sw_s[qa + 1];
        uint32_t ah[MW][4], al[MW][4];
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          const float* bq = b_s + qa * SB + 16 * (mg * MW + m) + gq;
          split(bq[0] * sa, ah[m][0], al[m][0]);
          split(bq[8] * sa, ah[m][1], al[m][1]);
          split(bq[SB] * sb, ah[m][2], al[m][2]);
          split(bq[SB + 8] * sb, ah[m][3], al[m][3]);
        }
        const float* xp = xs_s + (q0 / 2 + tq) * SP + 4 * gq;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const uint4 v = *reinterpret_cast<const uint4*>(xp + 32 * (nt0 + n));
#pragma unroll
          for (int m = 0; m < MW; ++m) mma3(acc[m][n], ah[m], al[m], v.x, v.y, v.z, v.w);
        }
      }
      float* sb_out = states + (((size_t)b * NC + c) * H + h) * (size_t)(N * P);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int r = 16 * (mg * MW + m) + gq;
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          const int col = 8 * (nt0 + n) + 2 * tq;
          *reinterpret_cast<float2*>(sb_out + r * P + col) =
              make_float2(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<float2*>(sb_out + (r + 8) * P + col) =
              make_float2(acc[m][n][2], acc[m][n][3]);
        }
      }
    }
    SSD_STAMP(9 + 8 * hl);
    if (tid < Q) dA_cs[(row0 + tid) * H + h] = (float)cs_s[tid];
  }
  if (CS > 1) cluster_wait();  // no block leaves before every push has landed
}

// The cluster size of a launch: 4 blocks (one chunk, four head groups)
// share CB where the head groups allow it and clusters of 4 still hold the
// whole grid in one wave (one block per SM), else 2, else 1. The last
// answer is kept per instantiation and thread, keyed on all it reads.
template <typename Kern>
int cluster_blocks(Kern kern, cudaLaunchConfig_t cfg, int groups) {
  struct Plan {
    int dev = -1, groups = -1, chunks = -1, cs = 1;
  };
  thread_local Plan last;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const int chunks = (int)(cfg.gridDim.y * cfg.gridDim.z), blocks = chunks * groups;
  if (dev == last.dev && groups == last.groups && chunks == last.chunks) return last.cs;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int cs = groups >= 4 ? 4 : groups >= 2 ? 2 : 1;
  for (; cs > 1; cs /= 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim.x = (groups + cs - 1) / cs * cs;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess &&
        (n * cs >= (int)(cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z) || blocks > sms))
      break;
  }
  cudaGetLastError();  // an occupancy query that failed leaves no error behind
  last = Plan{dev, groups, chunks, cs};
  return cs;
}

template <int N, int P>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, float* y, float* states, float* dA_cs, int B, int L, int H,
                   int Q, int hg, cudaStream_t stream) {
  const size_t smem = Layout<N, P>::bytes();
  auto kern = ssd_chunk_mma<N, P>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int groups = (H + hg - 1) / hg;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, L / Q, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  const int cs = cluster_blocks(kern, cfg, groups);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim.x = (groups + cs - 1) / cs * cs;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kern, x, dt, A, Bm, Cm, y, states, dA_cs, L, H,
                                            Q, hg);
  return le != cudaSuccess ? le : cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, float* states,
                       float* dA_cs, int B, int L, int H, int Q, int hg, cudaStream_t stream) {
#define REPRO_SSD_CASE(NN) \
  case NN:                 \
    return launch<NN, P>(x, dt, A, Bm, Cm, y, states, dA_cs, B, L, H, Q, hg, stream);
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

#ifdef REPRO_SSD_STAMPS
// the stamps of the last launch -> host (1 << 20 long longs)
extern "C" int repro_ssd_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(long long) * (1 << 20));
}
#endif
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream` (grid
// (ceil(H / hg), L / Q, B)), allocates nothing, does not synchronise;
// returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, void* states,
                               void* dA_cs, int B, int L, int H, int P, int N, int Q, int hg,
                               void* stream) {
  using namespace repro_torch;
  if (B <= 0 || L <= 0 || H <= 0 || Q <= 0 || Q > kQ || L % Q != 0 || hg < 1)
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
    return (int)dispatch_n<32>(N, xf, dtf, af, bf, cf, yf, sf, df, B, L, H, Q, hg, s);
  if (P == 64)
    return (int)dispatch_n<64>(N, xf, dtf, af, bf, cf, yf, sf, df, B, L, H, Q, hg, s);
  return (int)cudaErrorInvalidValue;
}
