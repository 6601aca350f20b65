// Fused structurally-masked attention forward, [B, L, H*D] layout.
//
// Replaces the TPU kernel vlp_tpu/ops/attention.py:_fwd_kernel_blhd (:117),
// both branches.  Per (example, head): S = Q K^T * (1/sqrt(D)) in fp32 plus
// the additive -10000 mask built on the fly from (mode, text_end, colkeep,
// prefix) (attention.py:_mask_bias), fp32 softmax, then -- in the dropout
// branch (training, attention.py:148) -- P times the Philox keep/scale
// multipliers of common.cuh, P cast to the input dtype, then P V
// accumulated in fp32.  The backward kernel (attention_bwd.cu) regenerates
// the same multipliers from the same seed.  Q/K/V are read straight off the
// projections (heads are column slices of the row), so no head transpose
// exists.
//
// What bounds it on an H100: at the decode prefill (B=100, L=103, H=12,
// D=64) one call moves ~63 MB (q, k, v in, out back, bf16) — ~19 us at
// 3.35 TB/s — and does 3.3 GFLOP; at the training shape (B=64, L=128) it
// moves ~50 MB (~15 us) and does 3.2 GFLOP, plus L/4 Philox draws per
// row in the dropout branch.  This first version computes both
// products on the CUDA cores in fp32 (no wgmma yet), so it is bound by
// FMA issue and shared-memory reads, not by HBM: each block stages its
// head's K and V once in shared memory (fp32, K rows padded to D+1 words
// so the 32 lanes of a warp hit 32 banks), and each warp then serves whole
// query rows from them with its query row held in registers.
//
// Layout: grid = (B*H, ceil(L / kRowsPerBlock)), kWarps warps per block,
// one warp per query row.  Lane j owns key columns j, j+32, ...; the
// reductions are warp shuffles.  D is fixed at 64 (every config in the
// repository); the wrapper rejects anything else.

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;

size_t smem_bytes(int L) {
  return sizeof(float) *
         (size_t(L) * (D + 1) + size_t(L) * D + L + kWarps * D + kWarps * L);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         const int* __restrict__ mode,
                         const int* __restrict__ text_end,
                         const float* __restrict__ colkeep, int L, int H,
                         long long sb, long long sl, int prefix,
                         float scale, vlp::Dropout dp) {
  extern __shared__ float smem[];
  float* ks = smem;                  // [L][D+1]
  float* vs = ks + L * (D + 1);      // [L][D]
  float* colok = vs + L * D;         // [L]  1 = column kept
  float* qs = colok + L;             // [kWarps][D]
  float* ps = qs + kWarps * D;       // [kWarps][L]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * sb + h * D;
  const int HD = H * D;
  const long long out_base = (long long)b * L * HD + h * D;

  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    ks[j * (D + 1) + d] = vlp::to_f(k[in_base + j * sl + d]);
    vs[j * D + d] = vlp::to_f(v[in_base + j * sl + d]);
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    colok[j] = colkeep[(long long)b * L + j] > 0.5f ? 1.f : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int md = mode[b], te = text_end[b];
  float* qw = qs + warp * D;
  float* pw = ps + warp * L;
  const int row_end = min(L, (int)(blockIdx.y + 1) * kRowsPerBlock);

  for (int i = blockIdx.y * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    for (int d = lane; d < D; d += 32) qw[d] = vlp::to_f(q[in_base + i * sl + d]);
    __syncwarp();
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qw[d];

    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      const float* kr = ks + j * (D + 1);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      // s2s: the prefix is visible to every row, the caption causally to
      // caption rows; bi: every column before text_end.  AND colkeep.
      const bool vis = (md == vlp::kModeS2S ? (j < prefix || (j <= i && i < te))
                                            : (j < te)) &&
                       colok[j] > 0.5f;
      const float s = __fadd_rn(__fmul_rn(acc, scale), vis ? 0.f : vlp::kNegInf);
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = vlp::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = vlp::warp_sum(sum);
    if constexpr (kDrop) {
      for (int j = lane; j < L; j += 32) pw[j] = pw[j] / sum;
      __syncwarp();
      // lane c draws the multipliers of columns 4c .. 4c+3
      for (int c = lane; 4 * c < L; c += 32) {
        float mult[4];
        vlp::keep_scale4(dp, b, h, i, c, mult);
        for (int w = 0; w < 4 && 4 * c + w < L; ++w)
          pw[4 * c + w] = vlp::round_to<T>(pw[4 * c + w] * mult[w]);
      }
    } else {
      for (int j = lane; j < L; j += 32)
        pw[j] = vlp::round_to<T>(pw[j] / sum);
    }
    __syncwarp();

    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(pw[j], vs[j * D + d], acc);
      out[out_base + (long long)i * HD + d] = vlp::from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T, bool kDrop>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* mode, const int* text_end, const float* colkeep, int B,
           int L, int H, long long sb, long long sl, int prefix, float scale,
           vlp::Dropout dp, cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + kRowsPerBlock - 1) / kRowsPerBlock);
  attention_fwd_kernel<T, kDrop><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), mode, text_end, colkeep,
      L, H, sb, sl, prefix, scale, dp);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const void* mode, const void* text_end, const void* colkeep,
             int B, int L, int H, long long sb, long long sl, int prefix,
             float scale, vlp::Dropout dp, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 ||
      smem_bytes(L) > (size_t)vlp::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  if (is_bf16)
    return launch<__nv_bfloat16, kDrop>(q, k, v, out, md, te, ck, B, L, H, sb,
                                        sl, prefix, scale, dp, s);
  return launch<float, kDrop>(q, k, v, out, md, te, ck, B, L, H, sb, sl,
                              prefix, scale, dp, s);
}

}  // namespace

extern "C" {

// q/k/v: [B, L, H*64] with element strides sb (batch) and sl (row), the
// last dimension contiguous; out: contiguous [B, L, H*64].  is_bf16 selects
// bf16 (1) or fp32 (0).  Returns cudaGetLastError() after the launch.
int vlp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      const void* mode, const void* text_end,
                      const void* colkeep, int B, int L, int H, long long sb,
                      long long sl, int prefix, float scale, int is_bf16,
                      void* stream) {
  return dispatch<false>(q, k, v, out, mode, text_end, colkeep, B, L, H, sb,
                         sl, prefix, scale, vlp::Dropout{0, 0, 1.f}, is_bf16,
                         stream);
}

// The training forward: as vlp_attention_fwd, with attention-prob dropout
// keyed on the 64-bit seed (threshold = uint32(rate * 2^32), keep_scale =
// 1 / (1 - rate)).
int vlp_attention_fwd_drop(const void* q, const void* k, const void* v,
                           void* out, const void* mode, const void* text_end,
                           const void* colkeep, int B, int L, int H,
                           long long sb, long long sl, int prefix, float scale,
                           unsigned long long seed, unsigned int threshold,
                           float keep_scale, int is_bf16, void* stream) {
  if (threshold == 0)  // rate 0: every element kept with scale 1
    return dispatch<false>(q, k, v, out, mode, text_end, colkeep, B, L, H, sb,
                           sl, prefix, scale, vlp::Dropout{0, 0, 1.f},
                           is_bf16, stream);
  return dispatch<true>(q, k, v, out, mode, text_end, colkeep, B, L, H, sb, sl,
                        prefix, scale,
                        vlp::Dropout{seed, threshold, keep_scale}, is_bf16,
                        stream);
}

}  // extern "C"
