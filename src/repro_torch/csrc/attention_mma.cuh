// Tensor-core building blocks of the bf16 prefill kernels (K3
// chunked_prefill.cu, K4 flash_attention.cu): cp.async copies into shared
// memory, ldmatrix fragment loads, mma.sync m16n8k16 (bf16 operands, f32
// sums), and the per-tile step of a FlashAttention-2 style online softmax
// for one warp's 16 query rows against its share of a 64-key tile.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, the same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8): b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9 of col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So S = Q.K^T takes K rows as B through a plain ldmatrix, P.V takes V
// rows through ldmatrix.trans, and the C fragments of two adjacent 8-key
// blocks of S are, rounded to bf16, the A fragment of one 16-key step of
// P.V: P never leaves registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace mma {

constexpr int kKeys = 64;                 // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNoKey = 0x3fffffff;        // key position of a masked slot
constexpr int kNoRow = -0x3fffffff;       // query position of a row past the end

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b (16 x 16 bf16 by 16 x 8 bf16, f32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx.ftz: ~2 ulp, subnormal
// results flushed to 0, which a softmax weight below 2^-126 is)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(v);
  sum += f.x + f.y;  // the softmax sum counts what P.V multiplies
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy ROWS rows of D bf16 (global row r at src + r * src_stride; rows >=
// n_valid zero-filled) into shared memory rows of stride D + 8, NT threads
// a chunk of 16 bytes each per pass. The caller commits the cp.async group.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t src_stride, int n_valid, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int u = 0; u < (ROWS * CPR + NT - 1) / NT; ++u) {
    const int c = tid + u * NT, r = c / CPR, d = (c - r * CPR) * 8;
    if (ROWS * CPR % NT != 0 && c >= ROWS * CPR) break;
    const bool ok = r < n_valid;
    cp_async16(dst + r * (D + 8) + d, src + (ok ? r * src_stride : 0) + d, ok);
  }
}

// K/V tiles in flight in the prefill kernels' shared memory: four, but
// three at D = 192, where four would not fit beside the Q rows (227 KB).
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 128 ? 3 : 4;
}

// One warp's 16 query rows: Q as A fragments, the output accumulator, and
// the running max (log2 domain) and partial sum of the two rows (g and
// g + 8) this thread holds. The warp attends to KW keys of each tile; the
// warps that share its rows take the tile's other keys, and their states
// are merged at the end (park, then fold). Q's fragments stay in registers
// up to D = 128; at D = 192 they are read from the block's Q rows in shared
// memory at every tile (ldmatrix), since 48 more registers beside the 96 of
// the output accumulator would spill.
template <int D, int KW>
struct WarpRows {
  static_assert(KW % 16 == 0, "a warp's keys are whole 16-key steps");
  static constexpr bool kQShared = D > 128;
  uint32_t qf[kQShared ? 1 : D / 16][4];
  uint32_t q_addr;  // kQShared: shared address of this lane's ldmatrix row of Q
  float o[D / 8][4];
  float m[2], l[2];
  int qp[2];  // query positions of rows g and g + 8

  // Q fragments of rows [16 * warp, 16 * warp + 16) of a tile in shared
  // memory (row stride D + 8), or their address; zero the state.
  __device__ __forceinline__ void init(const __nv_bfloat16* q_s, int warp, int lane) {
    const __nv_bfloat16* base = q_s + (16 * warp + (lane & 15)) * (D + 8) + (lane >> 4) * 8;
    q_addr = smem_addr(base);
    if constexpr (!kQShared) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], smem_addr(base + kk * 16));
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // The online-softmax step over KW keys in shared memory (K and V rows of
  // stride D + 8). kpos[j] is key j's position and kvalid[j] (when given)
  // nonzero where the slot holds a key. Row q sees key j iff it is valid,
  // kpos[j] <= q and q - kpos[j] < window (INT_MAX for no window). CAP
  // applies the tanh logit softcap.
  template <bool CAP>
  __device__ __forceinline__ void attend(const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
                                         const int* kpos, const int* kvalid, int window,
                                         float softcap, float scale, int lane) {
    constexpr int ST = D + 8;
    const int t = lane & 3;
    float s[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

    // S = Q.K^T: one ldmatrix.x4 gives the B fragments of two 8-key blocks
    const __nv_bfloat16* kb =
        k_s + ((lane & 7) + ((lane >> 4) << 3)) * ST + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQShared) {
        ldmatrix_x4(a, q_addr + kk * 16 * (int)sizeof(__nv_bfloat16));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      }
#pragma unroll
      for (int j = 0; j < KW / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kb + j * 16 * ST + kk * 16));
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // scale (to the log2 domain), softcap and mask each logit from its
    // row's and key's position
    const float scale_log2 = scale * kLog2e;
    const float cap_log2 = softcap * kLog2e, cap_in = CAP ? scale / softcap : 0.f;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(kpos + 8 * j + 2 * t);
      const int2 ok =
          kvalid ? *reinterpret_cast<const int2*>(kvalid + 8 * j + 2 * t) : make_int2(1, 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qp[e >> 1], p = (e & 1) ? kp.y : kp.x;
        const bool vis = ((e & 1) ? ok.y : ok.x) != 0 && p <= q && q - p < window;
        const float x = CAP ? cap_log2 * tanhf(s[j][e] * cap_in) : s[j][e] * scale_log2;
        s[j][e] = vis ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    // a row that has seen no key yet keeps m = -1e30; its weights are
    // taken against 0 instead, so that every one is exactly 0
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      m_use[i] = m_new == kNegInf ? 0.f : m_new;
    }

    // P in bf16 registers, laid out as the A fragments of P.V
    uint32_t pa[KW / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      pa[j >> 1][(j & 1) * 2] =
          pack_bf16(ex2(s[j][0] - m_use[0]), ex2(s[j][1] - m_use[0]), sum[0]);
      pa[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(ex2(s[j][2] - m_use[1]), ex2(s[j][3] - m_use[1]), sum[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V: one ldmatrix.x4.trans gives the B fragments of two 8-column
    // blocks of V for one 16-key step
    const __nv_bfloat16* vb =
        v_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vb + kk * 16 * ST + j * 16));
        mma_bf16(o[2 * j], pa[kk], b[0], b[1]);
        mma_bf16(o[2 * j + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  // Merge across the warps that share these rows: one parks its state in
  // buf (slot `slot` of n_slots threads, D / 2 + 4 floats each, consecutive
  // threads on consecutive words), the other folds it into its own.
  __device__ __forceinline__ void park(float* buf, int slot, int n_slots) const {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[(4 * n + e) * n_slots + slot] = o[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      buf[(D / 2 + i) * n_slots + slot] = m[i];
      buf[(D / 2 + 2 + i) * n_slots + slot] = l[i];
    }
  }

  __device__ __forceinline__ void fold(const float* buf, int slot, int n_slots) {
    float a[2], b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m2 = buf[(D / 2 + i) * n_slots + slot];
      const float mm = fmaxf(m[i], m2);
      a[i] = ex2(m[i] - mm);  // both -1e30: 1 and 1, with o = l = 0
      b[i] = ex2(m2 - mm);
      m[i] = mm;
      l[i] = l[i] * a[i] + buf[(D / 2 + 2 + i) * n_slots + slot] * b[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * a[e >> 1] + buf[(4 * n + e) * n_slots + slot] * b[e >> 1];
  }

  // Normalise once and write rows g and g + 8 of the warp's 16 (those
  // below n_rows), row r at out + r * out_stride. A row that saw no key
  // writes zeros.
  __device__ __forceinline__ void store(__nv_bfloat16* out, size_t out_stride, int n_rows,
                                        int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = li > 0.f ? 1.f / li : 0.f;
      const int r = g + 8 * i;
      if (r < n_rows) {
        __nv_bfloat16* orow = out + r * out_stride + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
};

// The card's SM count (host side; read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    n = count > 0 ? count : 1;
  }
  return n;
}

}  // namespace mma
}  // namespace repro_torch
