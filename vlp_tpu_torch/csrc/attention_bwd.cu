// Backward of the fused structurally-masked attention, in both layouts of
// the JAX package's attention_pallas: [B, L, H*D] ("blhd") and [B, H, L, D]
// ("bhld").
//
// Replaces the TPU kernels vlp_tpu/ops/attention.py:_bwd_kernel_blhd (:197)
// and _bwd_kernel (:155, the bhld layout).  Per (example, head), with no
// L x L residual kept in HBM between the passes: recompute
// S = Q K^T * scale + mask and P = softmax(S) in fp32 from
// Q and K, regenerate the forward's dropout multipliers (keep) from the same
// Philox seed (common.cuh), then
//   dV = (P o keep)^T dO
//   dP = (dO V^T) o keep
//   dS = P o (dP - rowsum(dP o P))        (P without keep, dP with it)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// all in fp32 from the inputs cast to fp32, as the TPU kernel does
// (attention.py:214-242).  dq/dk/dv are written contiguous in the input's
// layout and dtype.  One kernel body serves both layouts: it addresses
// q/k/v, dO and the gradients only through vlp::Strides, and the dropout
// counter is the logical (column/4, row, head, example), so bhld and blhd
// regenerate the same multipliers for one seed.
//
// What bounds it on an H100: at the training shape (B=64, L=128, H=12,
// D=64, bf16) one call reads q, k, v, dO and writes dq, dk, dv: ~88 MB,
// ~26 us at 3.35 TB/s; the five products are 8.1 GFLOP.  This first
// version runs the products on the CUDA cores in fp32 (no wgmma), so it is
// bound by FMA issue and shared-memory reads.  One block per (example,
// head) holds the whole problem in shared memory: two [L][D+1] fp32 tiles
// (K and V; later Q and dO take their places) and two [L][L+1] fp32
// matrices (P o keep and dS), ~210 KB at L=128, so one block runs per SM.
// The padding makes the column-walking products conflict-free.  Pass 1 is
// one warp per query row (the forward's layout); pass 2 forms dQ, dK and
// dV with each warp owning kRows output rows and each lane two of the 64
// columns.  The wrapper rejects an L whose tiles do not fit
// (vlp_attention_bwd_max_len).

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int LDD = D + 1;  // padded row of an [L][D] tile
constexpr int kWarps = 16;
constexpr int kRows = 4;    // output rows per warp in the products

size_t smem_bytes(int L) {
  const size_t Lz = L;
  return sizeof(float) * (2 * Lz * LDD + 2 * Lz * (Lz + 1) + Lz +
                          kWarps * Lz + kWarps * 2 * D);
}

// dst[j][d] = src[base + j * sl + d] as fp32, d < D, j < L.  (In bhld,
// src is one contiguous L*D block per head, which 16-byte loads could
// stage; left for the faster version.)
template <typename T>
__device__ void stage(float* dst, const T* __restrict__ src, long long base,
                      long long sl, int L) {
  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    dst[j * LDD + d] = vlp::to_f(src[base + j * sl + d]);
  }
}

// out[out_base + r * ol + d] = scale * sum_j A(r, j) * bt[j][d] for r < L,
// d < D, where A(r, j) = a[r * lda + j], or a[j * lda + r] when kTrans;
// ol is the output's row stride (H*D in blhd, D in bhld).
template <typename T, bool kTrans>
__device__ void product(T* __restrict__ out, long long out_base, long long ol,
                        const float* a, int lda, const float* bt, int L,
                        float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp * kRows; r0 < L; r0 += kWarps * kRows) {
    float acc[kRows][2] = {};
    for (int j = 0; j < L; ++j) {
      const float b0 = bt[j * LDD + lane], b1 = bt[j * LDD + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = min(r0 + r, L - 1);  // rows past L are not stored
        const float av = kTrans ? a[j * lda + row] : a[row * lda + j];
        acc[r][0] = fmaf(av, b0, acc[r][0]);
        acc[r][1] = fmaf(av, b1, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= L) break;
      T* o = out + out_base + (r0 + r) * ol;
      o[lane] = vlp::from_f<T>(acc[r][0] * scale);
      o[lane + 32] = vlp::from_f<T>(acc[r][1] * scale);
    }
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dq, T* __restrict__ dk,
                         T* __restrict__ dv, const int* __restrict__ mode,
                         const int* __restrict__ text_end,
                         const float* __restrict__ colkeep, int L, int H,
                         vlp::Strides in, vlp::Strides ds_in,
                         vlp::Strides os, int prefix, float scale,
                         vlp::Dropout dp) {
  extern __shared__ float smem[];
  const int LDP = L + 1;
  float* ta = smem;                 // [L][LDD]  K, then dO
  float* tb = ta + L * LDD;         // [L][LDD]  V, then Q
  float* pd = tb + L * LDD;         // [L][LDP]  P, then P o keep
  float* ds = pd + L * LDP;         // [L][LDP]  dP, then dS
  float* colok = ds + L * LDP;      // [L]       1 = column kept
  float* kws = colok + L;           // [kWarps][L]    keep of a row
  float* rws = kws + kWarps * L;    // [kWarps][2*D]  q row, dO row

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  const long long sl = in.l, dsl = ds_in.l;
  const long long out_base = b * os.b + h * os.h;

  stage(ta, k, in_base, sl, L);
  stage(tb, v, in_base, sl, L);
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    colok[j] = colkeep[(long long)b * L + j] > 0.5f ? 1.f : 0.f;
  __syncthreads();

  // ---- pass 1: one warp per query row i -> rows i of P o keep and dS
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int md = mode[b], te = text_end[b];
  float* kw = kws + warp * L;
  float* rw = rws + warp * 2 * D;
  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < D; d += 32) {
      rw[d] = vlp::to_f(q[in_base + i * sl + d]);
      rw[D + d] = vlp::to_f(dout[do_base + i * dsl + d]);
    }
    __syncwarp();
    float* prow = pd + i * LDP;
    float* srow = ds + i * LDP;
    {
      float qr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) qr[d] = rw[d];
      float mx = -CUDART_INF_F;
      for (int j = lane; j < L; j += 32) {
        const float* kr = ta + j * LDD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        const bool vis =
            (md == vlp::kModeS2S ? (j < prefix || (j <= i && i < te))
                                 : (j < te)) &&
            colok[j] > 0.5f;
        const float s =
            __fadd_rn(__fmul_rn(acc, scale), vis ? 0.f : vlp::kNegInf);
        prow[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = vlp::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(prow[j] - mx);
        prow[j] = e;
        sum += e;
      }
      sum = vlp::warp_sum(sum);
      for (int j = lane; j < L; j += 32) prow[j] = prow[j] / sum;
    }
    if constexpr (kDrop) {
      for (int c = lane; 4 * c < L; c += 32) {
        float mult[4];
        vlp::keep_scale4(dp, b, h, i, c, mult);
        for (int w = 0; w < 4 && 4 * c + w < L; ++w) kw[4 * c + w] = mult[w];
      }
    }
    __syncwarp();
    {
      float dr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dr[d] = rw[D + d];
      float rs = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float* vr = tb + j * LDD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc = fmaf(dr[d], vr[d], acc);
        const float dpj = kDrop ? acc * kw[j] : acc;
        srow[j] = dpj;
        rs += dpj * prow[j];
      }
      rs = vlp::warp_sum(rs);
      for (int j = lane; j < L; j += 32) {
        const float p = prow[j];
        srow[j] = p * (srow[j] - rs);
        if (kDrop) prow[j] = p * kw[j];
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- pass 2: Q takes V's place; dQ = dS K, dK = dS^T Q; then dO takes
  // K's place; dV = (P o keep)^T dO
  stage(tb, q, in_base, sl, L);
  __syncthreads();
  product<T, false>(dq, out_base, os.l, ds, LDP, ta, L, scale);
  product<T, true>(dk, out_base, os.l, ds, LDP, tb, L, scale);
  __syncthreads();
  stage(ta, dout, do_base, dsl, L);
  __syncthreads();
  product<T, true>(dv, out_base, os.l, pd, LDP, ta, L, 1.f);
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, const int* mode, const int* text_end,
           const float* colkeep, int B, int L, int H, vlp::Strides in,
           vlp::Strides ds_in, vlp::Strides os, int prefix, float scale,
           vlp::Dropout dp, cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<T, kDrop><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), mode,
      text_end, colkeep, L, H, in, ds_in, os, prefix, scale, dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
               int prefix, float scale, vlp::Dropout dp, cudaStream_t stream) {
  if (dp.threshold == 0)  // rate 0: every element kept with scale 1
    return launch<T, false>(q, k, v, dout, dq, dk, dv, mode, text_end,
                            colkeep, B, L, H, in, ds_in, os, prefix, scale,
                            dp, stream);
  return launch<T, true>(q, k, v, dout, dq, dk, dv, mode, text_end, colkeep,
                         B, L, H, in, ds_in, os, prefix, scale, dp, stream);
}

int backward(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, const void* mode,
             const void* text_end, const void* colkeep, int B, int L, int H,
             vlp::Strides in, vlp::Strides ds_in, vlp::Strides os, int prefix,
             float scale, vlp::Dropout dp, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 ||
      smem_bytes(L) > (size_t)vlp::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  if (is_bf16)
    return launch_any<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, md, te, ck, B,
                                     L, H, in, ds_in, os, prefix, scale, dp,
                                     s);
  return launch_any<float>(q, k, v, dout, dq, dk, dv, md, te, ck, B, L, H, in,
                           ds_in, os, prefix, scale, dp, s);
}

}  // namespace

extern "C" {

// The largest L whose tiles fit a block's shared memory.
int vlp_attention_bwd_max_len() {
  int L = 1;
  while (smem_bytes(L + 1) <= (size_t)vlp::kMaxSmemBytes) ++L;
  return L;
}

// q/k/v: [B, L, H*64] with element strides sb (batch) and sl (row); dout:
// [B, L, H*64] with strides dsb, dsl; the last dimension contiguous in
// all four.  dq/dk/dv: contiguous [B, L, H*64].  seed/threshold/keep_scale
// are the forward's dropout (threshold 0 = no dropout).  is_bf16 selects
// bf16 (1) or fp32 (0).  Returns cudaGetLastError() after the launch.
int vlp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      const void* mode, const void* text_end,
                      const void* colkeep, int B, int L, int H, long long sb,
                      long long sl, long long dsb, long long dsl, int prefix,
                      float scale, unsigned long long seed,
                      unsigned int threshold, float keep_scale, int is_bf16,
                      void* stream) {
  const long long HD = (long long)H * D;
  return backward(q, k, v, dout, dq, dk, dv, mode, text_end, colkeep, B, L, H,
                  vlp::Strides{sb, D, sl}, vlp::Strides{dsb, D, dsl},
                  vlp::Strides{L * HD, D, HD}, prefix, scale,
                  vlp::Dropout{seed, threshold, keep_scale}, is_bf16, stream);
}

// The bhld layout: q/k/v [B, H, L, 64] with element strides sb (batch), sh
// (head) and sl (row); dout [B, H, L, 64] with strides dsb, dsh, dsl; the
// last dimension contiguous in all four.  dq/dk/dv: contiguous
// [B, H, L, 64].  Otherwise as vlp_attention_bwd.
int vlp_attention_bwd_bhld(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           const void* mode, const void* text_end,
                           const void* colkeep, int B, int L, int H,
                           long long sb, long long sh, long long sl,
                           long long dsb, long long dsh, long long dsl,
                           int prefix, float scale, unsigned long long seed,
                           unsigned int threshold, float keep_scale,
                           int is_bf16, void* stream) {
  const long long LD = (long long)L * D;
  return backward(q, k, v, dout, dq, dk, dv, mode, text_end, colkeep, B, L, H,
                  vlp::Strides{sb, sh, sl}, vlp::Strides{dsb, dsh, dsl},
                  vlp::Strides{H * LD, LD, D}, prefix, scale,
                  vlp::Dropout{seed, threshold, keep_scale}, is_bf16, stream);
}

}  // extern "C"
