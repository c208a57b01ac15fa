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
// ridge, so the products belong on the tensor cores.
//
// Both kernels walk only the keys a tile of rows can see: from the window's
// start for its first row to min(bound * ps, last row's position + 1), which
// skips the causally masked part of the prefix exactly; every key in that
// range is visible to some row of the tile. Two kernels, chosen by dtype in
// the C entry point:
// - bf16, the serving dtype: chunked_prefill_mma, FlashAttention-2 on
//   mma.sync.m16n8k16 (bf16 operands, f32 sums; attention_mma.cuh). One
//   block per (lane, KV head, tile of 64 rows of S*G): the G query heads of
//   a KV head share the block, so each K/V row is read once for all of
//   them. The rows are four groups of 16 with SPLIT warps on each group:
//   every warp holds its 16 rows' Q fragments in registers (at Dh 192 it
//   reads them from shared memory at every tile, attention_mma.cuh) and
//   takes 64 / SPLIT keys of each key tile, so that several warps per scheduler
//   hide each other's latencies; the SPLIT softmax states of a row group
//   merge at the end. SPLIT is 4 (512 threads) at Dh <= 64 when the grid
//   has no more blocks than the card has SMs, else 2. The paper model's
//   256-token chunk (B = 1, 16 KV heads, G = 1) is 64 blocks on 132 SMs:
//   the key split inside a block, not a larger grid, adds the warps. A
//   64-key tile spans 8, 4 or 1 pages at ps 8, 16 or 64: each 16-byte
//   cp.async resolves table[b, t / ps] itself (the page ids are read one
//   tile ahead), into padded shared memory (rows of Dh + 8, so ldmatrix is
//   free of bank conflicts), four tiles in flight (three at Dh 192). Per
//   tile, S = Q.K^T
//   accumulates in f32 registers; scale, softcap and the mask apply per
//   element; the online softmax (m = -1e30, never -inf; exponentials in
//   base 2 on the SFU) reduces row max and sum over the lane quad; P is
//   rounded to bf16 in registers and is directly the A operand of P.V,
//   with V through ldmatrix.trans; 1/l is applied once at the end.
// - f32, the equivalence dtype, held to 1e-4 against the plain version:
//   chunked_prefill_simt, the f32 FMA kernel. One block of 256 threads per
//   (lane, KV head, tile of 64 rows), four threads per row, each keeping its
//   row's query in f32 registers (in shared memory at Dh 192); K and V
//   rows (each thread dereferences the table itself; 16-byte loads) in
//   padded shared memory, 16 logits per
//   thread per tile, max and sum combined by warp shuffles, P.V accumulated
//   in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// f32: chunked_prefill_simt
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 64;                    // query rows (of S*G) per block
constexpr int kSubs = kThreads / kRows;      // threads per row
constexpr int kKeys = 64;                    // keys per tile
constexpr int kKeysPerSub = kKeys / kSubs;   // logits per thread per tile
// each thread keeps its row's query in registers up to Dh 128; at Dh 192
// (192 registers) the block's query rows live in shared memory instead
__host__ __device__ constexpr bool simt_q_shared(int dh) { return dh > 128; }

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) chunked_prefill_simt(
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
  constexpr bool kQShared = simt_q_shared(DH);

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // kKeys * KS
  float* v_s = k_s + kKeys * KS;     // kKeys * KS
  float* p_s = v_s + kKeys * KS;     // kRows * PS
  int* key_ok_s = reinterpret_cast<int*>(p_s + kRows * PS);  // kKeys
  float* q_s = reinterpret_cast<float*>(key_ok_s + kKeys);    // kQShared: kRows * KS

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

  float q_reg[kQShared ? 1 : DH];
  const T* qrow = q + (((size_t)b * KV + h) * SG + r) * DH;
  float* q_row_s = q_s + row * KS;
  if constexpr (kQShared) {
    // the row's four threads load a quarter each; read after the tile
    // loop's first barrier
    for (int d = sub * VN; d < DH; d += kSubs * VN) Vec16<T>::load(qrow + d, q_row_s + d);
  } else {
#pragma unroll
    for (int d = 0; d < DH; d += VN) Vec16<T>::load(qrow + d, q_reg + d);
  }

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
          float4 qv;
          if constexpr (kQShared)
            qv = reinterpret_cast<const float4*>(q_row_s)[c];
          else
            qv = make_float4(q_reg[4 * c], q_reg[4 * c + 1], q_reg[4 * c + 2], q_reg[4 * c + 3]);
          dot += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
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

template <int DH>
cudaError_t launch_simt(const void* q, const void* pool_k, const void* pool_v,
                        const void* table, const void* bound, const void* p0,
                        void* out, int B, int KV, int SG, int G, int P, int ps,
                        int MP, int window, float softcap, float scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kKeys * (DH + 4) +
                                       (size_t)kRows * (kKeys + 1)) +
                      sizeof(int) * kKeys +
                      (simt_q_shared(DH) ? sizeof(float) * kRows * (DH + 4) : 0);
  auto kern = chunked_prefill_simt<float, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KV, (SG + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool_k),
      static_cast<const float*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(bound), static_cast<const int*>(p0),
      static_cast<float*>(out), KV, SG, G, P, ps, MP, window, softcap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: chunked_prefill_mma
// ---------------------------------------------------------------------------

// 64 rows per block in four row groups of 16; SPLIT warps on each row
// group, each on its share of every key tile (their states merge at the
// end), so that several warps per scheduler hide each other's latencies;
// mma::stages<D>() tiles of K/V in flight (kStages).
constexpr int kRowsMma = 64;
static_assert(kKeys == mma::kKeys, "the f32 and bf16 kernels share the 64-key tile");

template <int D>
constexpr size_t mma_smem_bytes() {
  constexpr int kStages = mma::stages<D>();
  return sizeof(__nv_bfloat16) * (kRowsMma + 2 * kStages * mma::kKeys) * (D + 8)  // Q, K, V
         + sizeof(int) * kStages * mma::kKeys;  // key positions per stage
}

template <int D, int SPLIT>
__global__ void __launch_bounds__(128 * SPLIT) chunked_prefill_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ pool_k,
    const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ bound, const int* __restrict__ p0,
    __nv_bfloat16* __restrict__ out, int KV, int SG, int G, int P, int ps, int MP,
    int window, float softcap, float scale) {
  using namespace mma;
  constexpr int NT = 128 * SPLIT, ROWS = kRowsMma, ST = D + 8, KW = kKeys / SPLIT;
  constexpr int kStages = stages<D>();
  constexpr int CPR = D / 8, CHUNKS = kKeys * CPR;  // 16-byte chunks per K (or V) tile
  constexpr int U = (CHUNKS + NT - 1) / NT;          // ... per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // ROWS rows
  __nv_bfloat16* k_s = q_s + ROWS * ST;                               // kStages tiles
  __nv_bfloat16* v_s = k_s + kStages * kKeys * ST;                    // kStages tiles
  int* kp_s = reinterpret_cast<int*>(v_s + kStages * kKeys * ST);     // kStages tiles

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) & 3, part = tid >> 7;  // row group, share of the key tile
  const int pb = p0[b];
  const int qp_min = pb + r0 / G;
  const int qp_max = pb + (min(r0 + ROWS, SG) - 1) / G;
  const int hi = min(bound[b] * ps, qp_max + 1);
  const int lo = window > 0 ? max(0, qp_min - window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const size_t tok_stride = (size_t)KV * D, head_off = (size_t)h * D;
  const int* table_b = table + (size_t)b * MP;

  const size_t row0 = ((size_t)b * KV + h) * SG + r0;
  load_rows<D, ROWS, NT>(q_s, q + row0 * D, D, SG - r0, tid);
  cp_async_commit();

  WarpRows<D, KW> w;
  const int ra = r0 + 16 * rg + (lane >> 2);
  w.qp[0] = ra < SG ? pb + ra / G : kNoRow;
  w.qp[1] = ra + 8 < SG ? pb + (ra + 8) / G : kNoRow;

  // Tile i holds keys [lo + 64 i, lo + 64 (i + 1)) and goes to stage
  // i % kStages. Each 16-byte chunk finds its own page: lookup() starts the
  // reads of a tile's page ids (and works out each chunk's slot in its
  // page) one tile before issue() needs them, so that no thread waits on
  // the table before its copies; a slot past hi or behind an out-of-range
  // page id is zero-filled and masked (position kNoKey).
  auto lookup = [&](int i, int (&phys)[U], int (&slot)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = lo + i * kKeys + (tid + u * NT) / CPR, pg = t / ps;
      phys[u] = i < n_tiles && tid + u * NT < CHUNKS && t < hi ? table_b[pg] : -1;
      slot[u] = t - pg * ps;
    }
  };
  auto issue = [&](int i, const int (&phys)[U], const int (&slot)[U]) {
    if (i >= n_tiles) return;
    const int stage = i % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = tid + u * NT, kk = c / CPR, d = (c - kk * CPR) * 8;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      const bool ok = phys[u] >= 0 && phys[u] < P;
      const size_t at = ok ? ((size_t)phys[u] * ps + slot[u]) * tok_stride + head_off + d : 0;
      cp_async16(k_s + (stage * kKeys + kk) * ST + d, pool_k + at, ok);
      cp_async16(v_s + (stage * kKeys + kk) * ST + d, pool_v + at, ok);
      if (d == 0) kp_s[stage * kKeys + kk] = ok ? lo + i * kKeys + kk : kNoKey;
    }
  };

  {
    int first[kStages - 1][U], first_slot[kStages - 1][U];  // every table read in flight
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) lookup(i, first[i], first_slot[i]);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      issue(i, first[i], first_slot[i]);
      cp_async_commit();
    }
  }
  int phys[U], slot[U];
  lookup(kStages - 1, phys, slot);
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();
  w.init(q_s, rg, lane);
  const int wnd = window > 0 ? window : INT_MAX;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed
    __syncthreads();  // ... for every thread, and tile i - 1's stage is free
    issue(i + kStages - 1, phys, slot);
    cp_async_commit();
    lookup(i + kStages, phys, slot);
    const int key0 = (i % kStages) * kKeys + part * KW;
    if (softcap > 0.f)
      w.template attend<true>(k_s + key0 * ST, v_s + key0 * ST, kp_s + key0, nullptr, wnd,
                              softcap, scale, lane);
    else
      w.template attend<false>(k_s + key0 * ST, v_s + key0 * ST, kp_s + key0, nullptr, wnd,
                               softcap, scale, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  // the other shares' warps hand their states to the first share's,
  // through the K/V stages
  constexpr int PARK = (D / 2 + 4) * 128;  // floats per share
  static_assert((SPLIT - 1) * PARK * 4 <= 2 * kStages * kKeys * ST * 2, "park fits in K/V");
  float* park_s = reinterpret_cast<float*>(k_s);
  if (part) w.park(park_s + (part - 1) * PARK, tid & 127, 128);
  __syncthreads();
  if (part) return;
#pragma unroll
  for (int p = 1; p < SPLIT; ++p) w.fold(park_s + (p - 1) * PARK, tid, 128);
  w.store(out + (row0 + 16 * rg) * D, D, SG - r0 - 16 * rg, lane);
}

template <int D, int SPLIT>
cudaError_t launch_split(const void* q, const void* pool_k, const void* pool_v,
                         const void* table, const void* bound, const void* p0, void* out,
                         int B, int KV, int SG, int G, int P, int ps, int MP, int window,
                         float softcap, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kern = chunked_prefill_mma<D, SPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, KV, (SG + kRowsMma - 1) / kRowsMma);
  kern<<<grid, 128 * SPLIT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(bound), static_cast<const int*>(p0),
      static_cast<__nv_bfloat16*>(out), KV, SG, G, P, ps, MP, window, softcap, scale);
  return cudaGetLastError();
}

// Four warps per row group (512 threads, at most 128 registers each: Dh <=
// 64) when every block has an SM to itself; two otherwise, so that two
// blocks share each SM.
template <int D>
cudaError_t launch_mma(const void* q, const void* pool_k, const void* pool_v,
                       const void* table, const void* bound, const void* p0, void* out,
                       int B, int KV, int SG, int G, int P, int ps, int MP, int window,
                       float softcap, float scale, cudaStream_t stream) {
  if constexpr (D <= 64) {
    const long blocks = (long)B * KV * ((SG + kRowsMma - 1) / kRowsMma);
    if (blocks <= mma::sm_count())
      return launch_split<D, 4>(q, pool_k, pool_v, table, bound, p0, out, B, KV, SG, G, P, ps,
                                MP, window, softcap, scale, stream);
  }
  return launch_split<D, 2>(q, pool_k, pool_v, table, bound, p0, out, B, KV, SG, G, P, ps, MP,
                            window, softcap, scale, stream);
}

}  // namespace
}  // namespace repro_torch

// the head dims both kernels are built for
#define REPRO_CHUNK_DH(LAUNCH)                                \
  switch (Dh) {                                               \
    case 16: return (int)LAUNCH<16>(REPRO_CHUNK_ARGS);       \
    case 32: return (int)LAUNCH<32>(REPRO_CHUNK_ARGS);       \
    case 64: return (int)LAUNCH<64>(REPRO_CHUNK_ARGS);       \
    case 128: return (int)LAUNCH<128>(REPRO_CHUNK_ARGS);     \
    case 192: return (int)LAUNCH<192>(REPRO_CHUNK_ARGS);     \
    default: return (int)cudaErrorInvalidValue;               \
  }
#define REPRO_CHUNK_ARGS \
  q, pool_k, pool_v, table, bound, p0, out, B, KV, SG, G, P, ps, MP, window, softcap, scale, s

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
  // The kernel is chosen by dtype, never by trying one: bf16 (serving) runs
  // on the tensor cores; f32 is the equivalence dtype, held to 1e-4 against
  // the plain version, which tensor-core f32 products (TF32 operands, 10-bit
  // mantissas) cannot meet, so it stays on the f32 FMA kernel.
  if (dtype == kBFloat16) REPRO_CHUNK_DH(launch_mma)
  if (dtype == kFloat32) REPRO_CHUNK_DH(launch_simt)
  return (int)cudaErrorInvalidValue;
}
