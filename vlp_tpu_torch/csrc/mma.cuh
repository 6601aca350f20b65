// PTX helpers of the tensor-core attention bodies: 16-byte (or narrower)
// asynchronous copies into shared memory, ldmatrix, the m16n8k16 mma with
// 16-bit operands (bf16 or fp16: the 16-bit bodies are templates over the
// element type T) and fp32 accumulation, the split-TF32 m16n8k8 products
// of the fp32 bodies, and the tile geometry they share.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col")       b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// so the C fragments of n-tiles 2s and 2s+1 are, packed to 16-bit pairs,
// the A fragment of k-step s: a probability or dS tile feeds the next
// product straight from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace vlp {

constexpr int kHeadDim = 64;           // D: VLP's head width
constexpr int kTileStride = kHeadDim + 8;  // 16-bit elements per staged
// [L][64] row: 144 bytes, so the 8 rows an ldmatrix reads fall on 8 distinct 16-byte
// bank groups, and every row start stays 16-byte aligned for cp.async

// MLA's head widths (Kimi-VL, DeepSeek-V3): q.k of 128 + 64 (RoPE), v.
constexpr int kMlaQkDim = 192;
constexpr int kMlaVDim = 128;

// The staged row of a 16-bit tile of kD columns (kD a multiple of 16): kD
// + 8 elements, 16 bytes past a multiple of 32, as kTileStride is for 64
// (MLA's q.k of 192 and v of 128: 400 and 272 bytes).
template <int kD>
__host__ __device__ constexpr int tile_stride() {
  static_assert(kD % 16 == 0, "tiles of 16-column steps");
  return kD + 8;
}

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

// The same with fp16 operands: one instruction, the bf16 rate.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats rounded to fp16 (round to nearest even; past 65504 the
// result is inf, which the loss scaler reads as an overflow), lo in the low
// half.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mma_bf16 / mma_f16 and pack_bf16 / pack_f16 by element type, for the
// 16-bit bodies (T = __nv_bfloat16 or __half).
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
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

// Waits for ring stage `it` after issuing stage it + 1 (if any).
template <typename Issue>
__device__ __forceinline__ void ring_next(int it, int n, Issue issue) {
  if (it + 1 < n) {
    issue(it + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// Stage rows [0, L) of one head's [L][64] tile of 16-bit elements T (row
// r at src + r*sl) into dst[Lp][kTileStride], zeros in rows [L, Lp),
// kBytes per copy.  Asynchronous for kBytes >= 4 (the caller commits and
// waits); 2-byte copies are plain loads and stores.
template <int kBytes, typename T, int kD = kHeadDim>
__device__ __forceinline__ void stage_rows_w(T* dst, const T* src,
                                             long long sl, int L, int Lp) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  constexpr int kElems = kBytes / 2;
  constexpr int kPerRow = kD / kElems;
  for (int idx = threadIdx.x; idx < Lp * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kElems;
    T* d = dst + r * tile_stride<kD>() + c;
    if (r >= L) {
      // +0 has all bits clear in both 16-bit types
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        reinterpret_cast<uint16_t*>(d)[e] = 0;
    } else if constexpr (kBytes >= 4) {
      cp_async<kBytes>(d, src + r * sl + c);
    } else {
      d[0] = src[r * sl + c];
    }
  }
}

// stage_rows_w at the widest copy that `align` (the common power-of-two
// byte alignment of every base pointer and stride, capped at 16) allows;
// kD columns a row (64 unless given).
template <typename T, int kD = kHeadDim>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long sl, int L, int Lp,
                                           int align) {
  switch (align) {
    case 16: stage_rows_w<16, T, kD>(dst, src, sl, L, Lp); break;
    case 8: stage_rows_w<8, T, kD>(dst, src, sl, L, Lp); break;
    case 4: stage_rows_w<4, T, kD>(dst, src, sl, L, Lp); break;
    default: stage_rows_w<2, T, kD>(dst, src, sl, L, Lp); break;
  }
}

// acc[n] = A(rows r0 .. r0+15) * B(rows c0 + 8n .. c0 + 8n + 7)^T for
// n < kN, A and B [.][tile_stride<kD>()] tiles of kD columns (64 unless
// given) of 16-bit T, and B rows below Lp only (the other tiles stay 0):
// S = Q K^T and dP = dO V^T over kN key tiles.  kN may be odd: the last
// tile then takes a two-matrix ldmatrix.
template <int kN, typename T, int kD = kHeadDim>
__device__ __forceinline__ void mma_abt(float (&acc)[kN][4], const T* a,
                                        const T* bt, int r0, int c0, int Lp,
                                        int lane) {
  constexpr int TS = tile_stride<kD>();
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (r0 + (lane & 15)) * TS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < (kN + 1) / 2; ++np) {
      const int n0 = c0 + np * 16;
      if (n0 >= Lp) continue;
      const T* row = bt + (n0 + (lane & 7) + (lane >> 4) * 8) * TS +
                     kk * 16 + ((lane >> 3) & 1) * 8;
      if (2 * np + 1 < kN) {   // folded: the loop is unrolled
        uint32_t fb[4];
        ldsm_x4(fb, row);
        mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
        mma16<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
      } else {
        uint32_t fb[2];
        ldsm_x2(fb, row);
        mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
      }
    }
  }
}

// Rows r0 + g and r0 + g + 8 (g = lane / 4) of a 16 x 8kN fp32
// accumulator, times scale, as 16-bit T at out + row * ol (rows < L only).
template <int kN, typename T>
__device__ __forceinline__ void store_rows(T* out, long long ol,
                                           const float (&acc)[kN][4], int r0,
                                           int L, int lane, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + g + 8 * hh;
    if (i >= L) continue;
    T* row = out + (long long)i * ol + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack16<T>(
          acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
  }
}

// ---- fp32 on the tensor cores: split TF32 ("3xTF32")
//
// Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (as cvt.rna rounds: to nearest, ties away from zero, to TF32's 10
// mantissa bits), and a product is lo*hi + hi*lo + hi*hi, accumulated in
// fp32, the small terms first.  The dropped lo*lo term and the rounding of
// lo leave ~2^-21 relative error per product: the size of an fp32
// summation-order difference.  tests/test_torch_tf32_split.py emulates the
// arithmetic on the CPU.
//
// Fragment layout of mma.m16n8k8 with tf32 operands:
//   A (16 x 8, row major)   a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, "col")        b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// Unlike m16n8k16's, C's columns are not A's k.  A probability or dS tile
// feeds the next product from registers with its summed index permuted:
// k = t is key 2t and k = t + 4 key 2t + 1 of the n8 tile, so
// a = (c0, c2, c1, c3) and the B operand reads the other matrix's rows 2t
// and 2t + 1 (any consistent order of a summed index leaves the sum's
// terms as they are).  Staged fp32 tiles are [rows][kF32Stride] floats.

constexpr int kF32Stride = kHeadDim + 4;  // floats per staged fp32 row: 272
// bytes (16-byte aligned rows for cp.async and ldmatrix), and 4 banks
// apart, so that ldmatrix's 8 rows x 16 bytes and the 8-byte reads of rows
// 2t, 2t+1 x columns 2g below hit 32 distinct banks

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: half a TF32 ulp
// added to the magnitude's bits, then the 13 bits below TF32's cleared.
// Two integer instructions, where ptxas expands cvt.rna into several (it
// also tests for NaN and infinity), and the split pays it twice an element.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo (to ~2^-22 relative), both TF32; x finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b on the tensor cores: tf32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 operand fragment split in two: hi[i] + lo[i] is element i.
template <int kN>
struct SplitFrag {
  uint32_t hi[kN], lo[kN];
};

// d += a * b in split TF32: lo*hi and hi*lo first, then hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const SplitFrag<4>& a,
                                           const SplitFrag<2>& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of rows r0 + g, r0 + g + 8 and columns k0 + t, k0 + t + 4
// of a staged fp32 tile (the summed index runs over the tile's columns):
// one ldmatrix.x4, whose 8 x 8 b16 matrices are 8 x 4 fp32 ones, lane
// (g, t) receiving element (g, t) of each.
__device__ __forceinline__ SplitFrag<4> lds_a_f32(const float* a, int r0,
                                                  int k0, int lane) {
  uint32_t x[4];
  ldsm_x4(x, a + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kF32Stride +
                 k0 + (lane >> 4) * 4);
  SplitFrag<4> f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(x[e]), f.hi[e], f.lo[e]);
  return f;
}

// The B fragments of B = T^T for a staged tile T and the two n-tiles at
// rows n0 and n0 + 8: n = row + g, k = columns k0 + t and k0 + t + 4 (S =
// Q K^T, dP = dO V^T and their transposes); one ldmatrix.x4.
__device__ __forceinline__ void lds_b2_f32(SplitFrag<2> (&f)[2],
                                           const float* bt, int n0, int k0,
                                           int lane) {
  uint32_t x[4];
  ldsm_x4(x, bt + (n0 + (lane & 7) + (lane >> 4) * 8) * kF32Stride + k0 +
                 ((lane >> 3) & 1) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(x[e]), f[e >> 1].hi[e & 1], f[e >> 1].lo[e & 1]);
}

// acc[n] = A(rows r0 .. r0+15) * B(rows c0 + 8n .. c0 + 8n + 7)^T over the
// 64 columns of two staged fp32 tiles, n < kN (even), in split TF32.
template <int kN>
__device__ __forceinline__ void mma_abt_f32(float (&acc)[kN][4],
                                            const float* a, const float* bt,
                                            int r0, int c0, int lane) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHeadDim; kk += 8) {
    const SplitFrag<4> fa = lds_a_f32(a, r0, kk, lane);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      SplitFrag<2> fb[2];
      lds_b2_f32(fb, bt, c0 + 8 * n, kk, lane);
      mma_3xtf32(acc[n], fa, fb[0]);
      mma_3xtf32(acc[n + 1], fa, fb[1]);
    }
  }
}

// The A fragment of an accumulator tile c (rows g, g + 8; columns 2t,
// 2t + 1) under the k permutation above.
__device__ __forceinline__ SplitFrag<4> frag_from_acc(const float (&c)[4]) {
  SplitFrag<4> f;
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], f.hi[e], f.lo[e]);
  return f;
}

// acc += A * T(rows k0 .. k0+7, all 64 columns), A from frag_from_acc (so
// B's k = t, t + 4 are T's rows k0 + 2t, k0 + 2t + 1).  The output columns
// are permuted so that the reads are 8 bytes wide and conflict-free:
// n-tiles 2i and 2i+1 read columns 16i + 2g and 16i + 2g + 1, so a lane's
// accumulator elements (acc[2i][e], acc[2i+1][e]) hold, for row g (e = 0,
// 1) or g + 8 (e = 2, 3), columns 16i + 4t + 2(e & 1) and one more:
// store_rows_f32 writes them.  P V, (P o keep)^T dO, dS^T Q and dS K.
// (16-byte reads of columns 32i + 4g .. + 3 were 2.5% slower in the
// backward at B=64 L=128 and 3-5% faster in the forward: PERF.md.)
__device__ __forceinline__ void mma_at_f32(float (&acc)[kHeadDim / 8][4],
                                           const SplitFrag<4>& a,
                                           const float* t_rows, int k0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* r = t_rows + (k0 + 2 * t) * kF32Stride + 2 * g;
#pragma unroll
  for (int i = 0; i < kHeadDim / 16; ++i) {
    const float2 x0 = *reinterpret_cast<const float2*>(r + 16 * i);
    const float2 x1 =
        *reinterpret_cast<const float2*>(r + kF32Stride + 16 * i);
    SplitFrag<2> b0, b1;
    split_tf32(x0.x, b0.hi[0], b0.lo[0]);
    split_tf32(x1.x, b0.hi[1], b0.lo[1]);
    split_tf32(x0.y, b1.hi[0], b1.lo[0]);
    split_tf32(x1.y, b1.hi[1], b1.lo[1]);
    mma_3xtf32(acc[2 * i], a, b0);
    mma_3xtf32(acc[2 * i + 1], a, b1);
  }
}

// Rows r0 + g and r0 + g + 8 of an accumulator of mma_at_f32, times
// scale, at out + row * ol (rows < L only): 16-byte stores.
__device__ __forceinline__ void store_rows_f32(
    float* out, long long ol, const float (&acc)[kHeadDim / 8][4], int r0,
    int L, int lane, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + g + 8 * hh;
    if (i >= L) continue;
    float* row = out + (long long)i * ol + 4 * t;
#pragma unroll
    for (int c = 0; c < kHeadDim / 16; ++c)
      *reinterpret_cast<float4*>(row + 16 * c) = make_float4(
          acc[2 * c][2 * hh] * scale, acc[2 * c + 1][2 * hh] * scale,
          acc[2 * c][2 * hh + 1] * scale, acc[2 * c + 1][2 * hh + 1] * scale);
  }
}

// Stage rows [0, valid) of n rows of an fp32 [.][64] slice (row r at
// src + r * sl) into dst[n][kF32Stride], zeros in rows [valid, n), kBytes
// per copy (asynchronous: the caller commits and waits).
template <int kBytes>
__device__ __forceinline__ void stage_rows_f32_w(float* dst, const float* src,
                                                 long long sl, int valid,
                                                 int n) {
  constexpr int kElems = kBytes / 4;
  constexpr int kPerRow = kHeadDim / kElems;
  for (int idx = threadIdx.x; idx < n * kPerRow; idx += blockDim.x) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kElems;
    float* d = dst + r * kF32Stride + c;
    if (r >= valid) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) d[e] = 0.f;
    } else {
      cp_async<kBytes>(d, src + r * sl + c);
    }
  }
}

// stage_rows_f32_w at the widest copy that `align` (as for stage_rows)
// allows; fp32 data are at least 4-byte aligned.
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               long long sl, int valid, int n,
                                               int align) {
  switch (align) {
    case 16: stage_rows_f32_w<16>(dst, src, sl, valid, n); break;
    case 8: stage_rows_f32_w<8>(dst, src, sl, valid, n); break;
    default: stage_rows_f32_w<4>(dst, src, sl, valid, n); break;
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
