// Helpers shared by the attention kernels: the structural mask as a row
// limit and a column bias, dtype conversion, the rounding of probabilities
// to the activation dtype, warp reductions, and the Philox generator of
// the attention-dropout bits (per block of 4 columns, and per lane of an
// mma tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vlp {

constexpr float kNegInf = -10000.0f;  // the reference's additive mask value
constexpr int kModeS2S = 1;           // vlp_tpu_torch/config.py MODE_S2S
constexpr int kMaxSmemBytes = 232448; // per-block opt-in limit on sm_90

// The activation dtype of an attention call, as the C entry points take it
// (ops/attention.py DTYPE_CODES): fp32 runs the split-TF32 bodies, bf16 and
// fp16 the 16-bit tensor-core bodies (one template over the element type).
enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// The longest L the attention kernels take, in every dtype and in both
// directions: the 512 positions of max_position_embeddings and one 16-row
// tile more (the length the first 16-bit forward's shared memory allowed,
// kept as it was).  No body's shared memory depends on it beyond a column
// bias of 4 bytes a key.
constexpr int attention_fwd_max_len() { return 528; }

// The structural mask (attention.py:_mask_bias) of query row i as a column
// limit: s2s rows see the prefix, and caption rows (i < text_end) causally
// up to i; bi rows every column before text_end.  Column j of row i is
// visible iff j <= row_limit(...) and colkeep[j].
__device__ __forceinline__ int row_limit(int mode, int text_end, int prefix,
                                         int i) {
  return mode == kModeS2S ? max(prefix - 1, i < text_end ? i : -1)
                          : text_end - 1;
}

// The additive mask of column j in a row of limit `limit`, from the
// column's own bias: 0 (kept), kNegInf (dropped by colkeep) or -inf (past
// L: excluded from the softmax, not masked).
__device__ __forceinline__ float mask_bias(float colbias, int j, int limit) {
  return j <= limit ? colbias : fminf(colbias, kNegInf);
}

// The first column that colkeep keeps (L if none).
__device__ __forceinline__ int first_kept(const float* colkeep, int L) {
  int j = 0;
  while (j < L && !(colkeep[j] > 0.5f)) ++j;
  return j;
}

// Whether query rows [i0, i1) see none of the keys from j0 on through the
// structural mask while each of them sees a kept column (`first`, from
// first_kept, lies within its limit).  Such scores sit at -10000 + s
// beside a row max of at least s' for a visible column, so exp(S - m)
// underflows to exactly 0 there (for |s - s'| < 9,896) and P o keep and dS
// are exact zeros: the tiled kernels skip such regions.  s2s rows see at
// least the prefix, bi rows every column before text_end.  Monotone in j0:
// a region that is skipped stays skipped for any later j0.
__device__ __forceinline__ bool masked_region(int md, int te, int prefix,
                                              int first, int i0, int i1,
                                              int j0) {
  if (md == kModeS2S) {
    const int hi = i0 < te ? max(prefix - 1, min(i1, te) - 1) : prefix - 1;
    return j0 > hi && prefix - 1 >= first;
  }
  return j0 > te - 1 && te - 1 >= first;
}

// 2^x by the special-function unit (ex2.approx, subnormal results flushed
// to 0): the attention bodies keep their scores in log2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tiled bodies keep scores in log2 units (S * log2(e)), so that
// exp(S - m) is one ex2 of a difference; the masks are scaled alike.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;

// mask_bias in log2 units: colbias2 is 0, kNegInf2 or -inf.
__device__ __forceinline__ float mask_bias2(float colbias2, int j,
                                            int limit) {
  return j <= limit ? colbias2 : fminf(colbias2, kNegInf2);
}

// The column bias of key j in log2 units: 0 (kept), kNegInf2 (dropped by
// colkeep), -inf past L.
__device__ __forceinline__ float colbias2(const float* colkeep, int j,
                                          int L) {
  return j >= L ? -CUDART_INF_F : colkeep[j] > 0.5f ? 0.f : kNegInf2;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// P is cast to the activation dtype before P.V, as the TPU kernels do.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A value summed (maxed) over the 4 lanes of a quad, which hold one row of
// an mma accumulator.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Philox4x32-10 (Random123) under a 64-bit key; the plain PyTorch version
// is vlp_tpu_torch/ops/philox.py, which must give the same bits.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c,
                                               unsigned long long seed) {
  unsigned int k0 = (unsigned int)seed, k1 = (unsigned int)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned int lo0 = 0xD2511F53u * c.x;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned int lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Attention-prob dropout of one call: the seed keys Philox, a word
// >= threshold (uint32(rate * 2^32)) keeps its element, kept elements are
// multiplied by scale (1 / (1 - rate)).
struct Dropout {
  unsigned long long seed;
  unsigned int threshold;
  float scale;
};

// How K1, K2 and dropout_mask take their dropout: the seed lies in device
// memory, as the TPU kernels take theirs as a scalar-prefetch operand
// (vlp_tpu/ops/attention.py:295), so that a captured CUDA graph draws
// whatever seed its slot holds when it is replayed.  Each block reads the
// seed once, in its prologue (load()), into the Dropout its body keys
// Philox with; the bits are those of the same seed passed by value.  With
// threshold 0 (no dropout) the pointer may be null and is not read.  The
// decode step (K5) and its regenerator (K6) take theirs by value.
struct DropoutArg {
  const unsigned long long* seed;
  unsigned int threshold;
  float scale;
  __device__ __forceinline__ Dropout load() const {
    return Dropout{threshold ? __ldg(seed) : 0ull, threshold, scale};
  }
};

inline DropoutArg dropout_arg(const void* seed, unsigned int threshold,
                              float scale) {
  return DropoutArg{static_cast<const unsigned long long*>(seed), threshold,
                    scale};
}

// Element strides of a [B, H, L, 64] view: element (b, h, i, d) sits at
// b * b_ + h * h_ + i * l_ + d.  The blhd layout ([B, L, H*64], heads as
// column slices of a row) is {sb, 64, sl}; the bhld layout ([B, H, L, 64],
// one L x 64 block per head) is {sb, sh, sl}.  The attention kernels address
// q/k/v/dO and their outputs only through these, so one body serves both
// layouts and the dropout counter (column/4, row, head, example) stays the
// same: bhld and blhd draw identical multipliers for one seed.
struct Strides {
  long long b, h, l;
};

// Multipliers of columns 4*jblk .. 4*jblk+3 of row i of (example b, head
// h): the counter is (jblk, i, h, b).  In a decode step, i is the query row
// s and the columns run over the joint (prompt | generated) axis.
__device__ __forceinline__ void keep_scale4(const Dropout& dp, int b, int h,
                                            int i, int jblk, float out[4]) {
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)jblk, (unsigned)i, (unsigned)h, (unsigned)b),
      dp.seed);
  out[0] = w.x >= dp.threshold ? dp.scale : 0.f;
  out[1] = w.y >= dp.threshold ? dp.scale : 0.f;
  out[2] = w.z >= dp.threshold ? dp.scale : 0.f;
  out[3] = w.w >= dp.threshold ? dp.scale : 0.f;
}

// The multipliers of one lane's four elements of an mma accumulator tile
// (mma.cuh): columns c0 + 2t, c0 + 2t + 1 (t = lane % 4, c0 a multiple of
// 8) of rows i and i + 8.  Both columns lie in counter block c0/4 + t/2, at
// words 2(t%2) and 2(t%2)+1, which lane t^1 needs too, so each lane pair
// draws once per row: the even lane row i, the odd lane row i + 8, and
// they swap the two words the other needs.  The bits are keep_scale4's.
// Every lane of the warp must call it (it shuffles).
__device__ __forceinline__ void keep_frag(const Dropout& dp, int b, int h,
                                          int i, int c0, int lane,
                                          float out[4]) {
  const int t = lane & 3;
  const bool odd = t & 1;
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)((c0 >> 2) + (t >> 1)), (unsigned)(odd ? i + 8 : i),
                 (unsigned)h, (unsigned)b),
      dp.seed);
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const unsigned x[4] = {odd ? r0 : w.x, odd ? r1 : w.y, odd ? w.z : r0,
                         odd ? w.w : r1};
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = x[e] >= dp.threshold ? dp.scale : 0.f;
}

}  // namespace vlp
