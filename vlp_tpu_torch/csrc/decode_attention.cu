// Fused KV-cached decode-step attention (one generation step of one layer).
//
// Replaces the TPU kernel vlp_tpu/ops/decode_attention.py:_kernel (:104),
// all three branches: K3 (beam-local generated cache, greedy decode), K4
// (has_anc, :143-153: the ancestry bias of the fused beam reorder) and K5
// (drop_rate > 0, :159-200: attention-prob dropout in the SCST sampled
// rollout, K == 1).  K5 multiplies the softmax probabilities by the Philox
// keep/scale multipliers of common.cuh (counter (column/4, row, head,
// example) under one seed per decode step and layer) before the cast to the
// activation dtype, as the TPU kernel does (pp * drop, then .astype(dt));
// decode_dropout.cu (K6) writes the same multipliers for the replay.
//
// One step, per (example b, head h):
//   1. write the S new tokens' K/V (previous token, [MASK] probe) of each of
//      the example's K beams into generated-cache slots gen_len+s, in place,
//      in this head's columns only (slots >= G are dropped, as the TPU
//      kernel's one-hot select dropped them);
//   2. score each of the K*S query rows against the example's prompt cache
//      [P, D] — stored once per example and never beam-expanded — and
//      against the generated cache: the row's own beam, slot j visible iff
//      j <= gen_len + s (K3), or all K beams of the example plus the
//      additive ancestry bias (K4; a column can then carry -20000);
//   3. one softmax over (prompt | generated), from the two pieces, P cast to
//      the activation dtype, and the context in fp32.
//
// What bounds it on an H100: at beam-5 serving (B=100, K=5, S=2, P=102,
// G=24, H=12, D=64, bf16) one call reads the prompt K/V once per example
// (100*102*768 * 2 B * 2 = 31 MB) and up to 37 MB of generated K/V (all
// five beams' slots), and writes ~0.6 MB — 9-20 us at 3.35 TB/s — and does
// ~0.2 GFLOP.  At the SCST rollout (K5: B=64, K=1) the prompt K/V is 20 MB
// and the generated K/V at most 4.7 MB, ~7.5 us.  The ideal is a memory-
// and launch-latency-bound kernel.  The cost is the latency of
// staging each block's caches: the block copies its head's prompt and
// generated caches into shared memory once, in the activation dtype (~67 KB
// in bf16 at those shapes, so three blocks share an SM), with 16-byte
// loads; every query row of the example is then served from shared memory
// on the CUDA cores (no tensor cores yet).
//
// Layout: grid = B*H blocks of kWarps warps, one warp per query row; lane c
// owns columns c, c+32, ... of the joint (prompt | generated) row and output
// dims 2*lane, 2*lane+1.  K rows are padded by two elements so that the 32
// lanes reading 32 different rows hit distinct banks.  In K5 a lane draws
// its own columns' multipliers (one Philox call per column, four times the
// draws that are needed: 126 columns a row at the SCST shape, negligible
// beside the staging).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int kWarps = 8;
constexpr int kRowStride = D + 2;  // padded K rows (elements)

template <typename T>
size_t smem_bytes(int P, int K, int G) {
  const size_t cols = size_t(P) + size_t(K) * G;
  return sizeof(float) * (kWarps * D + kWarps * cols) +
         sizeof(T) * (cols * kRowStride + cols * D);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16 bytes into shared memory that is only 4-byte aligned (padded rows)
__device__ __forceinline__ void stage16(void* dst, const uint4& v) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *static_cast<const uint4*>(p);
}

template <typename T, bool kHasAnc, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pk, const T* __restrict__ pv, T* __restrict__ gk,
    T* __restrict__ gv, const float* __restrict__ beam_bias,
    T* __restrict__ out, int K, int S, int P, int G, int H, long long psb,
    int gen_len, float scale, vlp::Dropout dp) {
  static_assert(!(kHasAnc && kDrop), "dropout is for sampling (K == 1)");
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / E;         // chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KG = K * G;
  const int cols = P + KG;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kWarps][D]
  float* ps = qs + kWarps * D;                     // [kWarps][P + K*G]
  T* pks = reinterpret_cast<T*>(ps + kWarps * cols);  // [P][kRowStride]
  T* pvs = pks + P * kRowStride;                      // [P][D]
  T* gks = pvs + P * D;             // [K*G][kRowStride], rows beam-major
  T* gvs = gks + KG * kRowStride;   // [K*G][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HD = H * D;
  const int hc = h * D;

#pragma unroll 4
  for (int c = threadIdx.x; c < P * CPR; c += blockDim.x) {
    const int j = c / CPR, e = (c % CPR) * E;
    const long long src = b * psb + (long long)j * HD + hc + e;
    const uint4 kx = ld16(pk + src), vx = ld16(pv + src);
    stage16(pks + j * kRowStride + e, kx);
    stage16(pvs + j * D + e, vx);
  }
  // generated caches of the example's K beams; the step's new K/V go to
  // slots gen_len.. both in HBM (in place) and in the staged copy
#pragma unroll 4
  for (int c = threadIdx.x; c < KG * CPR; c += blockDim.x) {
    const int r = c / CPR, e = (c % CPR) * E;
    const long long row = (long long)b * K + r / G;
    const int j = r % G;
    const long long g = (row * G + j) * HD + hc + e;
    const int s = j - gen_len;
    uint4 kx, vx;
    if (s >= 0 && s < S) {
      const long long src = (row * S + s) * HD + hc + e;
      kx = ld16(k + src);
      vx = ld16(v + src);
      *reinterpret_cast<uint4*>(gk + g) = kx;
      *reinterpret_cast<uint4*>(gv + g) = vx;
    } else {
      kx = ld16(gk + g);
      vx = ld16(gv + g);
    }
    stage16(gks + r * kRowStride + e, kx);
    stage16(gvs + r * D + e, vx);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ncol = P + (kHasAnc ? KG : G);
  float* qw = qs + warp * D;
  float* pw = ps + warp * cols;

  for (int r = warp; r < K * S; r += kWarps) {
    const int kk = r / S, s = r % S;
    const long long row = (long long)b * K + kk;
    const long long qo = (row * S + s) * HD + hc;
    const float2 q2 = load_pair(q + qo + 2 * lane);
    qw[2 * lane] = q2.x;
    qw[2 * lane + 1] = q2.y;
    __syncwarp();

    float mx = -CUDART_INF_F;
    for (int c = lane; c < ncol; c += 32) {
      const T* kr;
      float bias = 0.f;
      if (c < P) {
        kr = pks + c * kRowStride;  // prompt: always visible
      } else {
        const int cg = c - P;
        const int grow = kHasAnc ? cg : kk * G + cg;
        kr = gks + grow * kRowStride;
        bias = (grow % G) <= gen_len + s ? 0.f : vlp::kNegInf;
        if (kHasAnc) bias = __fadd_rn(bias, beam_bias[row * KG + cg]);
      }
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 2) {
        const float2 kv = load_pair(kr + d);
        const float2 qv = *reinterpret_cast<const float2*>(qw + d);
        acc = fmaf(qv.x, kv.x, acc);
        acc = fmaf(qv.y, kv.y, acc);
      }
      const float sc = __fadd_rn(__fmul_rn(acc, scale), bias);
      pw[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = vlp::warp_max(mx);
    float sum_p = 0.f, sum_g = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float e = expf(pw[c] - mx);
      pw[c] = e;
      if (c < P) sum_p += e; else sum_g += e;
    }
    const float denom = vlp::warp_sum(sum_p) + vlp::warp_sum(sum_g);
    for (int c = lane; c < ncol; c += 32) {
      float p = pw[c] / denom;
      // K == 1, so the row's counter row is its query row s
      if constexpr (kDrop) p = p * vlp::keep_scale1(dp, b, h, s, c);
      pw[c] = vlp::round_to<T>(p);
    }
    __syncwarp();

    const int d0 = 2 * lane;
    const T* gv_rows = gvs + (kHasAnc ? 0 : kk * G * D);
    float px = 0.f, py = 0.f, gx = 0.f, gy = 0.f;
    for (int j = 0; j < P; ++j) {
      const float p = pw[j];
      const float2 vv = load_pair(pvs + j * D + d0);
      px = fmaf(p, vv.x, px);
      py = fmaf(p, vv.y, py);
    }
    for (int c = 0; c < ncol - P; ++c) {
      const float p = pw[P + c];
      const float2 vv = load_pair(gv_rows + c * D + d0);
      gx = fmaf(p, vv.x, gx);
      gy = fmaf(p, vv.y, gy);
    }
    store_pair(out + qo + d0, px + gx, py + gy);
    __syncwarp();
  }
}

template <typename T, bool kHasAnc, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* pk,
           const void* pv, void* gk, void* gv, const float* beam_bias,
           void* out, int B, int K, int S, int P, int G, int H,
           long long psb, int gen_len, float scale, vlp::Dropout dp,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(P, K, G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, kHasAnc, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, kHasAnc, kDrop>
      <<<B * H, kWarps * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(pk),
          static_cast<const T*>(pv), static_cast<T*>(gk),
          static_cast<T*>(gv), beam_bias, static_cast<T*>(out), K, S, P, G,
          H, psb, gen_len, scale, dp);
  return (int)cudaGetLastError();
}

// dp.threshold == 0 (no dropout) selects K3 or K4; otherwise K5, which the
// entry point only reaches with K == 1 and no beam bias
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* pk,
             const void* pv, void* gk, void* gv, const float* beam_bias,
             void* out, int B, int K, int S, int P, int G, int H,
             long long psb, int gen_len, float scale, vlp::Dropout dp,
             cudaStream_t stream) {
  if (smem_bytes<T>(P, K, G) > (size_t)vlp::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (dp.threshold)
    return launch<T, false, true>(q, k, v, pk, pv, gk, gv, nullptr, out, B,
                                  K, S, P, G, H, psb, gen_len, scale, dp,
                                  stream);
  if (beam_bias)
    return launch<T, true, false>(q, k, v, pk, pv, gk, gv, beam_bias, out, B,
                                  K, S, P, G, H, psb, gen_len, scale, dp,
                                  stream);
  return launch<T, false, false>(q, k, v, pk, pv, gk, gv, nullptr, out, B, K,
                                 S, P, G, H, psb, gen_len, scale, dp, stream);
}

template <typename... Args>
int dispatch_dtype(int is_bf16, Args... args) {
  return is_bf16 ? dispatch<__nv_bfloat16>(args...) : dispatch<float>(args...);
}

}  // namespace

extern "C" {

// q/k/v/out: contiguous [B*K, S, H*64]; pk/pv: [B, P, H*64] with batch
// stride psb (elements) and contiguous rows; gk/gv: contiguous
// [B*K, G, H*64], updated in place; beam_bias: contiguous fp32 [B*K, K*G]
// or null (K3).  Every pointer and psb*sizeof(T) must be 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int vlp_decode_attention(const void* q, const void* k, const void* v,
                         const void* pk, const void* pv, void* gk, void* gv,
                         const void* beam_bias, void* out, int B, int K,
                         int S, int P, int G, int H, long long psb,
                         int gen_len, float scale, int is_bf16,
                         void* stream) {
  if (B <= 0 || K <= 0 || S <= 0 || P <= 0 || G <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtype(is_bf16, q, k, v, pk, pv, gk, gv,
                        static_cast<const float*>(beam_bias), out, B, K, S, P,
                        G, H, psb, gen_len, scale, vlp::Dropout{0, 0, 1.f},
                        static_cast<cudaStream_t>(stream));
}

// K5, the SCST sampled rollout: as vlp_decode_attention with K == 1 and no
// beam bias, the probabilities multiplied by the Philox keep/scale
// multipliers keyed on the 64-bit seed (threshold = uint32(rate * 2^32),
// keep_scale = 1 / (1 - rate)) before their cast to the activation dtype.
int vlp_decode_attention_drop(const void* q, const void* k, const void* v,
                              const void* pk, const void* pv, void* gk,
                              void* gv, void* out, int B, int S, int P,
                              int G, int H, long long psb, int gen_len,
                              float scale, unsigned long long seed,
                              unsigned int threshold, float keep_scale,
                              int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || P <= 0 || G <= 0 || H <= 0 || threshold == 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_dtype(is_bf16, q, k, v, pk, pv, gk, gv,
                        static_cast<const float*>(nullptr), out, B, 1, S, P,
                        G, H, psb, gen_len, scale,
                        vlp::Dropout{seed, threshold, keep_scale},
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
