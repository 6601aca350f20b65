// Helpers shared by the attention kernels: dtype conversion, the rounding
// of probabilities to the activation dtype, warp reductions, and the
// Philox generator of the attention-dropout bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vlp {

constexpr float kNegInf = -10000.0f;  // the reference's additive mask value
constexpr int kModeS2S = 1;           // vlp_tpu_torch/config.py MODE_S2S
constexpr int kMaxSmemBytes = 232448; // per-block opt-in limit on sm_90

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

// Multipliers of columns 4*jblk .. 4*jblk+3 of row i of (example b, head
// h): the counter is (jblk, i, h, b).
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

}  // namespace vlp
