// Split-walk decode attention for Hopper (sm_90a): the pieces shared by
// paged decode (csrc/paged_attention.cu, K1), the shared-prefix pass
// (csrc/shared_prefix.cu, K2) and flash decode (csrc/decode_attention.cu,
// K5).
//
// A decode query has one row per head (R = lanes x G rows per block), so a
// block per (KV head, lanes) leaves most of the card idle: 16 blocks for
// the paper model at B = 1. Here the key walk of one (KV head, lanes) is
// split across the `splits` blocks of a thread-block cluster (one 128-token
// tile or more each). Inside a block the NW warps walk independent 32-token
// sub-tiles with no block barrier. A sub-tile's 32 K and V rows are copied
// to the warp's shared rows with cp.async, consecutive lanes on consecutive
// 16-byte chunks of a row (so a copy instruction touches a few lines, not
// 32); then each lane owns one token (reading its K row), the row
// statistics come from warp shuffles, and for P.V the lanes run across
// pairs of head-dim columns with the probabilities read back as broadcasts,
// so a warp keeps R x Dh / 32 f32 accumulators in registers. At the end
// the warps' states merge into the block's, and every other block of the
// cluster pushes its state into rank 0's shared memory with st.async,
// completing on an mbarrier there; rank 0 merges and writes the result.
// Every sum runs in a fixed order (warps 0..NW-1, then ranks
// 0..splits-1), so a result is bit-identical from run to run. The merge is
// the online softmax's own, the one K1's continuation applies to K2's
// stats:
//   m = max_i m_i,  l = sum_i l_i e^(m_i - m),  acc = sum_i acc_i e^(m_i - m);
// K1's continuation seed is one more state, merged by rank 0 first.
// An empty split (all its tokens masked or out of range) keeps m = -1e30,
// l = 0, acc = 0, so a fully masked row stays exactly at that state and no
// NaN can arise: -1e30 is finite, never -inf.
//
// The cluster's only barriers are relaxed ones (barrier.cluster.arrive
// .relaxed): cooperative_groups' cluster.sync() compiles to a GPU-wide
// memory fence and an L1 invalidation, which cost more than the walk.
//
// The host picks `splits` (kernels/paged_attention/kernel.py plan_splits)
// and launches with launch_split: grid.x = splits, cluster (splits, 1, 1),
// so blockIdx.x is the block's rank. Split `rank` walks whole 128-token
// tiles [lo, hi) of the n tokens (split_range; the Python split_ranges is
// the same arithmetic).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace repro_torch {
namespace split {

using mma::cp_async16;
using mma::smem_addr;

constexpr int kTile = 128;     // tokens per unit of the split plan
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kPS = 36;        // stride (floats) of a warp's probability rows:
                               // rows 4 banks apart, 16-byte aligned

// Tokens [lo, hi) of split `rank` of `splits`: whole tiles, balanced, so
// that every split holds at least one tile when splits <= tiles.
__device__ __forceinline__ void split_range(int n, int splits, int rank, int& lo, int& hi) {
  const long long tiles = (n + kTile - 1) / kTile;
  lo = min(n, (int)(tiles * rank / splits) * kTile);
  hi = min(n, (int)(tiles * (rank + 1) / splits) * kTile);
}

// Shared memory of one block of NW warps with R query rows in a cluster of
// S blocks. Float regions first, each a multiple of 4 floats so that every
// region after them is 16-byte aligned; then rank 0's mbarrier; then
// `work`: during the walk each warp's 32 K and V rows (T) and R probability
// rows (f32), after it each warp's R x DH accumulators (f32); then `ints`
// (R ints for the kernel's own use).
template <typename T, int DH, int NW>
struct Smem {
  static constexpr int kThreads = 32 * NW;
  // row stride (T) of the staged K/V rows: 16 bytes of padding puts the 8
  // lanes of a 16-byte access phase on 8 different bank groups
  static constexpr int VS = DH + 16 / (int)sizeof(T);
  // wm..bl per row, padded: also room for cluster_merge's S + 3 floats per
  // row (blocks of 2 warps)
  static constexpr int kRowFloats =
      ((3 * NW + 2 > kMaxSplits + 3 ? 3 * NW + 2 : kMaxSplits + 3) + 3) / 4 * 4;
  float* q;       // R * DH   query rows
  float* bacc;    // R * DH   the block's merged acc
  float* wm;      // NW * R   each warp's running max
  float* wl;      // NW * R   each warp's running sum
  float* walpha;  // NW * R   each warp's rescale of its last sub-tile
  float* bm;      // R        the block's merged m, l
  float* bl;      // R
  float* rx;      // (S - 1) * stride   rank 0: the other ranks' (acc, (m, l) per row)
  uint64_t* bar;  // rank 0: completes when every pushed byte has landed
  unsigned char* work;
  int* ints;      // R

  // one rank's pushed state: R * DH + 2 R floats, at a 16-byte stride
  __host__ __device__ static int pushed(int R) { return R * DH + 2 * R; }
  __host__ __device__ static int stride(int R) { return (pushed(R) + 3) / 4 * 4; }
  __host__ __device__ static size_t rx_floats(int R, int S) {
    return (size_t)(S - 1) * stride(R);
  }
  __host__ __device__ static size_t work_bytes(int R) {
    const size_t walk =
        (size_t)NW * (2 * 32 * VS * sizeof(T) + (size_t)R * kPS * sizeof(float));
    const size_t acc = (size_t)NW * R * DH * sizeof(float);
    return walk > acc ? walk : acc;
  }
  __host__ __device__ static size_t bytes(int R, int S) {
    return sizeof(float) * ((size_t)2 * R * DH + (size_t)kRowFloats * R + rx_floats(R, S)) + 16 +
           work_bytes(R) + sizeof(int) * (size_t)R;
  }
  __device__ Smem(unsigned char* base, int R, int S) {
    q = reinterpret_cast<float*>(base);
    bacc = q + R * DH;
    wm = bacc + R * DH;
    wl = wm + NW * R;
    walpha = wl + NW * R;
    bm = walpha + NW * R;
    bl = bm + R;
    rx = wm + kRowFloats * R;
    bar = reinterpret_cast<uint64_t*>(rx + rx_floats(R, S));
    work = reinterpret_cast<unsigned char*>(bar) + 16;
    ints = reinterpret_cast<int*>(work + work_bytes(R));
  }
  __device__ T* k_rows(int warp) const {
    return reinterpret_cast<T*>(work) + (size_t)warp * 2 * 32 * VS;
  }
  __device__ T* v_rows(int warp) const { return k_rows(warp) + 32 * VS; }
  __device__ float* p_rows(int warp, int R) const {
    return reinterpret_cast<float*>(work + (size_t)NW * 2 * 32 * VS * sizeof(T)) + warp * R * kPS;
  }
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 loaded bytes of T, widened to f32 (bf16 is the upper half of an f32).
__device__ __forceinline__ void unpack16(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* out, __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Query rows -> shared memory (f32): row r of the block's R x DH rows
// starts at q[row_base(r)]. 16-byte loads, every one issued before the
// first store.
// `between()` runs after the loads are issued and before they are waited
// for, so that whatever it issues overlaps them.
template <int MAX_RD, typename T, int DH, int NW, typename RowBase, typename Between>
__device__ __forceinline__ void load_q(const Smem<T, DH, NW>& sm, int R, const T* __restrict__ q,
                                       RowBase row_base, Between between) {
  constexpr int NT = Smem<T, DH, NW>::kThreads;
  constexpr int EPC = 16 / (int)sizeof(T), CPR = DH / EPC;
  constexpr int PER = (MAX_RD / EPC + NT - 1) / NT;
  const int chunks = R * CPR;
  uint4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = threadIdx.x + u * NT;
    if (c < chunks) {
      const int r = c / CPR;
      v[u] = *reinterpret_cast<const uint4*>(q + row_base(r) + (c - r * CPR) * EPC);
    }
  }
  between();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = threadIdx.x + u * NT;
    if (c < chunks) unpack16(v[u], sm.q + c * EPC, T());
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The prologue of every block, before its first __syncthreads: every
// warp's running (m, l) starts empty, and in a cluster of more than one
// block rank 0 arms its mbarrier for the (S - 1) pushed states and every
// thread arrives at the cluster barrier that cluster_merge waits on (so the
// barrier's latency hides behind the walk).
template <typename T, int DH, int NW>
__device__ __forceinline__ void begin(const Smem<T, DH, NW>& sm, int R) {
  for (int i = threadIdx.x; i < NW * R; i += Smem<T, DH, NW>::kThreads) {
    sm.wm[i] = kNegInf;
    sm.wl[i] = 0.f;
  }
  const int S = gridDim.x;
  if (S == 1) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)((S - 1) * Smem<T, DH, NW>::pushed(R) * sizeof(float));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(sm.bar)) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(sm.bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  cluster_arrive_relaxed();
}

// The online-softmax update of rows [r0, r0 + RG) of one warp's sub-tile:
// logits of the lane's token (its staged K row) against each row, row max and sum by xor
// butterflies (every lane ends with the same bits), p to the warp's
// probability rows, and lane 0 updates (m, l) and the rescale alpha. The RG
// rows are processed together so that their dependent chains (dot
// products, shuffles, exponentials) overlap; a single row splits its dot
// product over partial sums instead. Rows past R repeat row R - 1 and are
// dropped.
template <int RG, typename T, int DH, typename RowOk>
__device__ __forceinline__ void rows_update(const float* __restrict__ q_s, float* m_w,
                                            float* l_w, float* a_w, float* p_w, int r0, int R,
                                            bool live, const T* __restrict__ k_row, RowOk row_ok,
                                            float scale, float softcap, int lane) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = DH / EPC;
  constexpr int NP = RG == 1 ? EPC / 4 : 1;  // partial sums per row
  int rr[RG];
  float dot[RG][NP];
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    rr[u] = min(r0 + u, R - 1);
#pragma unroll
    for (int w = 0; w < NP; ++w) dot[u][w] = 0.f;
  }
  if (live) {
    // the lane's K row, 16 bytes at a time from its staged shared row (a
    // rolled loop: the code of one step is small and stays in the
    // instruction cache)
#pragma unroll 2
    for (int c = 0; c < CPR; ++c) {
      float kv[EPC];
      unpack16(*reinterpret_cast<const uint4*>(k_row + c * EPC), kv, T());
#pragma unroll
      for (int u = 0; u < RG; ++u) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + rr[u] * DH + c * EPC);
#pragma unroll
        for (int e = 0; e < EPC / 4; ++e) {
          const float4 qv = q4[e];
          dot[u][e % NP] += qv.x * kv[4 * e] + qv.y * kv[4 * e + 1] + qv.z * kv[4 * e + 2] +
                            qv.w * kv[4 * e + 3];
        }
      }
    }
  }
  float s[RG], mx[RG], m_prev[RG], m_new[RG], p[RG], sum[RG];
  bool ok[RG];
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    float d = 0.f;
#pragma unroll
    for (int w = 0; w < NP; ++w) d += dot[u][w];
    ok[u] = live && r0 + u < R && row_ok(rr[u]);
    s[u] = ok[u] ? apply_softcap(d * scale, softcap) : kNegInf;
    mx[u] = s[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < RG; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
  }
#pragma unroll
  for (int u = 0; u < RG; ++u) {
    m_prev[u] = m_w[rr[u]];
    m_new[u] = fmaxf(m_prev[u], mx[u]);
    p[u] = ok[u] ? expf(s[u] - m_new[u]) : 0.f;
    sum[u] = p[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < RG; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
  }
#pragma unroll
  for (int u = 0; u < RG; ++u)
    if (r0 + u < R) p_w[(r0 + u) * kPS + lane] = p[u];
  __syncwarp();  // every lane has read m_w
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      const int r = r0 + u;
      if (r < R) {
        const float alpha = expf(m_prev[u] - m_new[u]);
        a_w[r] = alpha;
        l_w[r] = l_w[r] * alpha + sum[u];
        m_w[r] = m_new[u];
      }
    }
  }
}

// Copy a sub-tile's 32 K and V rows into the warp's shared rows: lane i's
// token has its rows at element `off` of kbase and vbase if `live`. Lanes
// copy consecutive 16-byte chunks of a row (cp.async, bypassing L1), so a
// copy instruction touches a few lines rather than 32; a row that is not
// live is zero-filled (p == 0 must meet a finite v). The copies stay in
// flight until warp_step waits for them.
template <typename T, int DH, int NW>
__device__ __forceinline__ void stage(const Smem<T, DH, NW>& sm, bool live, size_t off,
                                      const T* __restrict__ kbase, const T* __restrict__ vbase) {
  constexpr int VS = Smem<T, DH, NW>::VS;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DH / EPC;             // chunks per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* k_w = sm.k_rows(warp);
  T* v_w = sm.v_rows(warp);
  mma::cp_async_wait<0>();  // an earlier sub-tile's copies into these rows
  __syncwarp();             // and every lane's reads of them are done
  const unsigned live_mask = __ballot_sync(0xffffffffu, live);
  const unsigned off_lo = (unsigned)off, off_hi = (unsigned)(off >> 32);
#pragma unroll
  for (int u = 0; u < CPR; ++u) {
    const int qd = lane + 32 * u, row = qd / CPR, col = qd - row * CPR;
    const size_t src = ((size_t)__shfl_sync(0xffffffffu, off_hi, row) << 32) |
                       __shfl_sync(0xffffffffu, off_lo, row);
    const bool ok = (live_mask >> row) & 1u;
    const size_t at = ok ? src + (size_t)col * EPC : 0;
    cp_async16(k_w + row * VS + col * EPC, kbase + at, ok);
    cp_async16(v_w + row * VS + col * EPC, vbase + at, ok);
  }
  mma::cp_async_commit();
}

// One warp's step over the 32 tokens of its staged sub-tile, one per lane.
// `live`: the lane's token is attended by some row; `row_ok(r)`: row r
// attends it. acc holds cells c = lane + 32 j of the R x DH/2 column pairs
// (row c / (DH/2), columns 2 (c % (DH/2)) and the next).
template <int MAXP, typename T, int DH, int NW, typename RowOk>
__device__ __forceinline__ void warp_step(const Smem<T, DH, NW>& sm, int R, bool live,
                                          RowOk row_ok, float scale, float softcap,
                                          float (&acc)[2 * MAXP]) {
  constexpr int VS = Smem<T, DH, NW>::VS;
  constexpr int HP = DH / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* k_w = sm.k_rows(warp);
  const T* v_w = sm.v_rows(warp);
  float* p_w = sm.p_rows(warp, R);
  float* m_w = sm.wm + warp * R;
  float* l_w = sm.wl + warp * R;
  float* a_w = sm.walpha + warp * R;

  mma::cp_async_wait<0>();
  __syncwarp();
  const T* k_row = k_w + lane * VS;
  if (R == 1) {
    rows_update<1, T, DH>(sm.q, m_w, l_w, a_w, p_w, 0, R, live, k_row, row_ok, scale, softcap,
                          lane);
  } else if (R < 8) {
    for (int r0 = 0; r0 < R; r0 += 4)
      rows_update<4, T, DH>(sm.q, m_w, l_w, a_w, p_w, r0, R, live, k_row, row_ok, scale,
                            softcap, lane);
  } else {
    for (int r0 = 0; r0 < R; r0 += 8)
      rows_update<8, T, DH>(sm.q, m_w, l_w, a_w, p_w, r0, R, live, k_row, row_ok, scale,
                            softcap, lane);
  }
  __syncwarp();

  // acc = acc * alpha + P . V over the 32 tokens
  const int RHP = R * HP;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    if (32 * j >= RHP) break;
    const int c = lane + 32 * j;
    if (c < RHP) {
      const float a = a_w[c / HP];
      acc[2 * j] *= a;
      acc[2 * j + 1] *= a;
    }
  }
  if constexpr (HP % 32 == 0) {
    // a lane's column pairs are the same in every row (lane + 32 n): each
    // V pair is read once per token and serves all R rows
    constexpr int NC = HP / 32;
    for (int i = 0; i < 32; i += 8) {
      float2 v[NC][8];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[n][e] = load_pair(v_w + (i + e) * VS + 2 * (lane + 32 * n));
#pragma unroll
      for (int j = 0; j < MAXP; ++j) {
        if (32 * j >= RHP) break;  // cell c = lane + 32 j: row j / NC, pair lane + 32 (j % NC)
        const float* pr = p_w + (j / NC) * kPS + i;
        const float4 pa = *reinterpret_cast<const float4*>(pr);
        const float4 pb = *reinterpret_cast<const float4*>(pr + 4);
        const float2* w = v[j % NC];
        acc[2 * j] += (pa.x * w[0].x + pa.y * w[1].x + pa.z * w[2].x + pa.w * w[3].x) +
                      (pb.x * w[4].x + pb.y * w[5].x + pb.z * w[6].x + pb.w * w[7].x);
        acc[2 * j + 1] += (pa.x * w[0].y + pa.y * w[1].y + pa.z * w[2].y + pa.w * w[3].y) +
                          (pb.x * w[4].y + pb.y * w[5].y + pb.z * w[6].y + pb.w * w[7].y);
      }
    }
    return;
  }
  for (int i = 0; i < 32; i += 8) {
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      if (32 * j >= RHP) break;
      const int c = lane + 32 * j;
      if (c < RHP) {
        const int r = c / HP, col = 2 * (c - r * HP);
        const float4 pa = *reinterpret_cast<const float4*>(p_w + r * kPS + i);
        const float4 pb = *reinterpret_cast<const float4*>(p_w + r * kPS + i + 4);
        float2 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = load_pair(v_w + (i + e) * VS + col);
        const float x0 = pa.x * v[0].x + pa.y * v[1].x + pa.z * v[2].x + pa.w * v[3].x;
        const float x1 = pb.x * v[4].x + pb.y * v[5].x + pb.z * v[6].x + pb.w * v[7].x;
        const float y0 = pa.x * v[0].y + pa.y * v[1].y + pa.z * v[2].y + pa.w * v[3].y;
        const float y1 = pb.x * v[4].y + pb.y * v[5].y + pb.z * v[6].y + pb.w * v[7].y;
        acc[2 * j] += x0 + x1;
        acc[2 * j + 1] += y0 + y1;
      }
    }
  }
}

// The NW warps' states -> the block's (bacc, bm, bl), warps in order.
template <int MAXP, typename T, int DH, int NW>
__device__ __forceinline__ void block_merge(const Smem<T, DH, NW>& sm, int R,
                                            const float (&acc)[2 * MAXP]) {
  constexpr int HP = DH / 2, NT = Smem<T, DH, NW>::kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RHP = R * HP, RD = R * DH;
  mma::cp_async_wait<0>();  // a staged sub-tile that was skipped
  __syncthreads();          // every warp is done with the walk's rows in `work`
  float* wacc = reinterpret_cast<float*>(sm.work) + warp * RD;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    if (32 * j >= RHP) break;
    const int c = lane + 32 * j;
    if (c < RHP) {
      const int r = c / HP, col = 2 * (c - r * HP);
      *reinterpret_cast<float2*>(wacc + r * DH + col) = make_float2(acc[2 * j], acc[2 * j + 1]);
    }
  }
  // each warp's scale e^(m_w - m) per row, once, in walpha
  for (int r = tid; r < R; r += NT) {
    float m = sm.wm[r];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, sm.wm[w * R + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(sm.wm[w * R + r] - m);
      sm.walpha[w * R + r] = sc;
      l += sm.wl[w * R + r] * sc;
    }
    sm.bm[r] = m;
    sm.bl[r] = l;
  }
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(sm.work);
  for (int c = tid; c < RD; c += NT) {
    const int r = c / DH;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += all[w * RD + c] * sm.walpha[w * R + r];
    sm.bacc[c] = a;
  }
}

// No continuation seed (K2, K5).
struct NoSeed {
  __device__ bool on() const { return false; }
  __device__ float m(int) const { return kNegInf; }
  __device__ float l(int) const { return 0.f; }
  __device__ float acc(int) const { return 0.f; }
};

// K1's continuation seed: the shared-prefix pass's f32 state of the
// block's R rows (acc R x DH, m and l R each), or none when acc_ is null.
struct Seed {
  const float* acc_;
  const float* m_;
  const float* l_;
  __device__ bool on() const { return acc_ != nullptr; }
  __device__ float m(int r) const { return m_[r]; }
  __device__ float l(int r) const { return l_[r]; }
  __device__ float acc(int c) const { return acc_[c]; }
};

// The cluster's blocks' states -> the merged state, emitted by rank 0 as
// cell(c, row, acc, l) for every cell c of the R x DH rows and row(r, m, l)
// for every row; every block of the cluster calls it after block_merge.
// Ranks 1..S-1 push (bacc, bm, bl) into rank 0's `rx` with st.async; rank 0
// waits on its mbarrier for all of it and merges in a fixed order: the
// seed (when there is one), then ranks 0..S-1. A cluster of one block with
// no seed emits its own state.
template <typename T, int DH, int NW, typename SeedT, typename Cell, typename Row>
__device__ __forceinline__ void cluster_merge(const Smem<T, DH, NW>& sm, int R,
                                              const SeedT& seed, Cell cell, Row row) {
  constexpr int NT = Smem<T, DH, NW>::kThreads;
  const int S = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  const int RD = R * DH, stride = Smem<T, DH, NW>::stride(R);
  const bool seeded = seed.on();
  __syncthreads();  // block_merge's (bacc, bm, bl)
  if (S == 1 && !seeded) {
    for (int c = tid; c < RD; c += NT) {
      const int r = c / DH;
      cell(c, r, sm.bacc[c], sm.bl[r]);
    }
    for (int r = tid; r < R; r += NT) row(r, sm.bm[r], sm.bl[r]);
    return;
  }
  if (S > 1) cluster_wait();  // rank 0's mbarrier is armed (every block has begun)
  if (rank != 0) {
    uint32_t dst, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(dst)
                 : "r"(smem_addr(sm.rx + (size_t)(rank - 1) * stride)));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(bar) : "r"(smem_addr(sm.bar)));
    for (int i = tid; i < RD / 4; i += NT) {
      const float4 a = reinterpret_cast<const float4*>(sm.bacc)[i];
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
          "[%5];\n" ::"r"(dst + 16 * i),
          "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
          "r"(__float_as_uint(a.w)), "r"(bar)
          : "memory");
    }
    for (int r = tid; r < R; r += NT) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
          ::"r"(dst + 4 * (RD + 2 * r)), "r"(__float_as_uint(sm.bm[r])),
          "r"(__float_as_uint(sm.bl[r])), "r"(bar)
          : "memory");
    }
  } else {
    // every thread waits (acquiring the pushed bytes); a lost push would
    // leave the barrier open: fail loudly, never hang
    uint32_t done = S == 1;
    for (long long spin = 0; !done; ++spin) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(sm.bar))
          : "memory");
      if (spin > (1LL << 24)) __trap();
    }
    // per row: the merged m and l, and the scale e^(m_s - m) of the seed
    // (slot 0) and of each rank (slots 1..S), in the free per-warp rows
    // wm.. ((S + 3) R <= kRowFloats R floats)
    const float* rx = sm.rx;
    float* sc = sm.wm;
    for (int r = tid; r < R; r += NT) {
      const float ms = seeded ? seed.m(r) : kNegInf;
      float m = fmaxf(ms, sm.bm[r]);
      for (int s = 1; s < S; ++s) m = fmaxf(m, rx[(s - 1) * stride + RD + 2 * r]);
      float x = seeded ? expf(ms - m) : 0.f;
      sc[r] = x;
      float l = seeded ? seed.l(r) * x : 0.f;
      x = expf(sm.bm[r] - m);
      sc[R + r] = x;
      l += sm.bl[r] * x;
      for (int s = 1; s < S; ++s) {
        x = expf(rx[(s - 1) * stride + RD + 2 * r] - m);
        sc[(s + 1) * R + r] = x;
        l += rx[(s - 1) * stride + RD + 2 * r + 1] * x;
      }
      sc[(S + 1) * R + r] = m;
      sc[(S + 2) * R + r] = l;
    }
    __syncthreads();
    for (int c = tid; c < RD; c += NT) {
      const int r = c / DH;
      float a = seeded ? seed.acc(c) * sc[r] : 0.f;
      a += sm.bacc[c] * sc[R + r];
      for (int s = 1; s < S; ++s) a += rx[(s - 1) * stride + c] * sc[(s + 1) * R + r];
      cell(c, r, a, sc[(S + 2) * R + r]);
    }
    for (int r = tid; r < R; r += NT) row(r, sc[(S + 1) * R + r], sc[(S + 2) * R + r]);
  }
  if (S == 1) return;
  // the pushes have landed before any block leaves
  __syncwarp();
  cluster_arrive_relaxed();
  cluster_wait();
}

template <typename T, int DH, int NW, typename Cell, typename Row>
__device__ __forceinline__ void cluster_merge(const Smem<T, DH, NW>& sm, int R, Cell cell,
                                              Row row) {
  cluster_merge(sm, R, NoSeed(), cell, row);
}

// Launch `kern` with blocks of NW warps on grid (splits, y, z), clusters of
// (splits, 1, 1) and `smem` bytes of dynamic shared memory; returns the
// launch's error.
template <int NW, typename... KArgs, typename... Args>
cudaError_t launch_split(void (*kern)(KArgs...), int splits, int y, int z, size_t smem,
                         cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, y, z);
  cfg.blockDim = dim3(32 * NW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace split
}  // namespace repro_torch
