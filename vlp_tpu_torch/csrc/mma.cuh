// PTX helpers of the tensor-core attention bodies (bf16): 16-byte (or
// narrower) asynchronous copies into shared memory, ldmatrix, the
// m16n8k16 bf16 mma with fp32 accumulation, and the tile geometry they
// share.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col")       b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// so the C fragments of n-tiles 2s and 2s+1 are, packed to bf16 pairs,
// the A fragment of k-step s: a probability or dS tile feeds the next
// product straight from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace vlp {

constexpr int kHeadDim = 64;           // D: every config in the repository
constexpr int kTileStride = kHeadDim + 8;  // bf16 per staged [L][64] row:
// 144 bytes, so the 8 rows an ldmatrix reads fall on 8 distinct 16-byte
// bank groups, and every row start stays 16-byte aligned for cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m,
// register m receives it (row lane/4, columns 2*(lane%4)..+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two matrices: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two matrices, each transposed on the way: lanes 0-15 give the row
// addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b on the tensor cores: bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows [0, L) of one head's [L][64] bf16 tile (row r at src + r*sl)
// into dst[Lp][kTileStride], zeros in rows [L, Lp), kBytes per copy.
// Asynchronous for kBytes >= 4 (the caller commits and waits); 2-byte
// copies are plain loads and stores.
template <int kBytes>
__device__ __forceinline__ void stage_rows_w(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long sl, int L, int Lp) {
  constexpr int kElems = kBytes / 2;
  constexpr int kPerRow = kHeadDim / kElems;
  for (int idx = threadIdx.x; idx < Lp * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kElems;
    __nv_bfloat16* d = dst + r * kTileStride + c;
    if (r >= L) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) d[e] = __float2bfloat16_rn(0.f);
    } else if constexpr (kBytes >= 4) {
      cp_async<kBytes>(d, src + r * sl + c);
    } else {
      d[0] = src[r * sl + c];
    }
  }
}

// stage_rows_w at the widest copy that `align` (the common power-of-two
// byte alignment of every base pointer and stride, capped at 16) allows.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long sl, int L, int Lp,
                                           int align) {
  switch (align) {
    case 16: stage_rows_w<16>(dst, src, sl, L, Lp); break;
    case 8: stage_rows_w<8>(dst, src, sl, L, Lp); break;
    case 4: stage_rows_w<4>(dst, src, sl, L, Lp); break;
    default: stage_rows_w<2>(dst, src, sl, L, Lp); break;
  }
}

// acc[n] = A(rows r0 .. r0+15) * B(rows c0 + 8n .. c0 + 8n + 7)^T for
// n < kN, A and B [.][kTileStride] bf16 tiles of 64 columns, and B rows
// below Lp only (the other tiles stay 0): S = Q K^T and dP = dO V^T over
// kN key tiles.  kN may be odd: the last tile then takes a two-matrix
// ldmatrix.
template <int kN>
__device__ __forceinline__ void mma_abt(float (&acc)[kN][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* bt, int r0,
                                        int c0, int Lp, int lane) {
  constexpr int TS = kTileStride;
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (r0 + (lane & 15)) * TS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < (kN + 1) / 2; ++np) {
      const int n0 = c0 + np * 16;
      if (n0 >= Lp) continue;
      const __nv_bfloat16* row = bt +
                                 (n0 + (lane & 7) + (lane >> 4) * 8) * TS +
                                 kk * 16 + ((lane >> 3) & 1) * 8;
      if (2 * np + 1 < kN) {   // folded: the loop is unrolled
        uint32_t fb[4];
        ldsm_x4(fb, row);
        mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
        mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
      } else {
        uint32_t fb[2];
        ldsm_x2(fb, row);
        mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      }
    }
  }
}

// Rows r0 + g and r0 + g + 8 (g = lane / 4) of a 16 x 8kN fp32
// accumulator, times scale, as bf16 at out + row * ol (rows < L only).
template <int kN>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ol,
                                           const float (&acc)[kN][4], int r0,
                                           int L, int lane, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + g + 8 * hh;
    if (i >= L) continue;
    __nv_bfloat16* row = out + (long long)i * ol + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(
          acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
  }
}

// The largest power of two <= 16 that divides every value (byte addresses
// and byte strides).
__host__ __forceinline__ int common_alignment(
    std::initializer_list<unsigned long long> bytes) {
  unsigned long long bits = 16;
  for (unsigned long long b : bytes) bits |= b;
  return (int)(bits & (~bits + 1));
}

}  // namespace vlp
