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
// as the TPU kernel does (attention.py:214-242).  dq/dk/dv are written
// contiguous in the input's layout and dtype.  Each body addresses q/k/v,
// dO and the gradients only through vlp::Strides, and the dropout counter
// is the logical (column/4, row, head, example), so bhld and blhd
// regenerate the same multipliers for one seed.
//
// The body is chosen by dtype and length (never by a failure):
// * bf16, every main path, L <= 144: attention_bwd_mma, on the tensor
//   cores (mma.m16n8k16, bf16 operands, fp32 accumulation).  One block per
//   (example, head) holds the whole problem: Q, K, V and dO staged once
//   with 16-byte cp.async (narrower copies for unaligned inputs) into rows
//   padded to 72 bf16, Q and K in the first copy group, V and dO in the
//   second, so S starts before V and dO have landed.  Two warps share each
//   16-row query tile, one per half of the key columns: S and P in
//   registers (fp32 softmax; the pair adds up its row max and sum through
//   shared memory), keep from vlp::keep_frag (a bit mask), dP = dO V^T,
//   rowsum(dP o keep o P) likewise, dS = P o (dP o keep - rowsum).  P o
//   keep and dS go to shared memory as bf16 ([L][L+8]); after one
//   __syncthreads each warp forms 16 rows of dQ = dS K * scale, dK =
//   dS^T Q * scale and dV = (P o keep)^T dO in 32 of the 64 d-columns
//   (ldmatrix.trans for the transposed operands).  P o keep and dS are
//   rounded to bf16 before their products (as FlashAttention does; the
//   TPU kernel keeps them in fp32): the CPU test
//   tests/test_torch_attention_bwd.py::
//   test_bf16_rounded_backward_fits_the_jax_bf16_backward holds that
//   arithmetic within the bf16 tolerance of JAX's bf16 backward.  Padded
//   rows and columns of a ragged L are exact zeros in P o keep and dS.
// * bf16, 144 < L <= the bf16 forward's limit (vlp::attention_fwd_max_len:
//   its tiles fit at 528, these at 544 query rows): attention_bwd_long,
//   the same products, rounding and Philox bits over 128-column key chunks
//   (the whole problem no longer fits a block).  Q and dO stay staged;
//   each pass stages one chunk's K (and V) at a time: (1) the row max and
//   sum, rescaled chunk to chunk, (2) rowsum(dP o keep o P), (3) per chunk
//   and 32 query rows, P o keep and dS through shared memory into dK and
//   dV (registers, stored after the chunk) and dQ, added up over the
//   chunks in fp32 in a scratch that the wrapper allocates.
// * fp32: attention_bwd_fp32, the first version on the CUDA cores (fp32
//   FMAs), which the card-vs-CPU fp32 gates need: tensor cores give
//   neither fp32 nor its exact products.  Its block holds two [L][D+1]
//   fp32 tiles and two [L][L+1] fp32 matrices (P o keep and dS); pass 1 is
//   one warp per query row, pass 2 forms dQ, dK and dV with each warp
//   owning kRows output rows and each lane two of the 64 columns.
//
// What bounds it on an H100: at the training shape (B=64, L=128, H=12,
// D=64, bf16) one call reads q, k, v, dO and writes dq, dk, dv: ~88 MB,
// ~26 us at 3.35 TB/s; the five products are 8.1 GFLOP, ~8 us at 989
// TFLOP/s.  The bf16 body's block needs ~144 KB of shared memory at L=128
// (four [128][72] tiles, two [128][136]), so one block of 16 warps runs
// per SM, and it takes ~14 us per head at one block per SM (PERF.md):
// it is bound by the latency of its serial phases (stage, S, softmax, dP,
// dS, the three products, store) more than by bytes or operations.
// Registers and spills:
// `-Xptxas -v` in the build log (chip_smoke.py prints it).  The wrapper
// rejects an L whose tiles do not fit (vlp_attention_bwd_max_len, per
// dtype).

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = vlp::kHeadDim;
using bf16 = __nv_bfloat16;

// ---- fp32: the first version, on the CUDA cores

constexpr int LDD = D + 1;  // padded row of an [L][D] tile
constexpr int kWarps = 16;
constexpr int kRows = 4;    // output rows per warp in the products

size_t smem_bytes_fp32(int L) {
  const size_t Lz = L;
  return sizeof(float) * (2 * Lz * LDD + 2 * Lz * (Lz + 1) + Lz +
                          kWarps * Lz + kWarps * 2 * D);
}

// dst[j][d] = src[base + j * sl + d], d < D, j < L.
__device__ void stage(float* dst, const float* __restrict__ src,
                      long long base, long long sl, int L) {
  for (int idx = threadIdx.x; idx < L * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    dst[j * LDD + d] = src[base + j * sl + d];
  }
}

// out[out_base + r * ol + d] = scale * sum_j A(r, j) * bt[j][d] for r < L,
// d < D, where A(r, j) = a[r * lda + j], or a[j * lda + r] when kTrans;
// ol is the output's row stride (H*D in blhd, D in bhld).
template <bool kTrans>
__device__ void product(float* __restrict__ out, long long out_base,
                        long long ol, const float* a, int lda,
                        const float* bt, int L, float scale) {
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
      float* o = out + out_base + (r0 + r) * ol;
      o[lane] = acc[r][0] * scale;
      o[lane + 32] = acc[r][1] * scale;
    }
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_fp32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, const int* __restrict__ mode,
                       const int* __restrict__ text_end,
                       const float* __restrict__ colkeep, int L, int H,
                       vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                       int prefix, float scale, vlp::Dropout dp) {
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
      rw[d] = q[in_base + i * sl + d];
      rw[D + d] = dout[do_base + i * dsl + d];
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
  product<false>(dq, out_base, os.l, ds, LDP, ta, L, scale);
  product<true>(dk, out_base, os.l, ds, LDP, tb, L, scale);
  __syncthreads();
  stage(ta, dout, do_base, dsl, L);
  __syncthreads();
  product<true>(dv, out_base, os.l, pd, LDP, ta, L, 1.f);
}

// ---- bf16: on the tensor cores

constexpr int kMaxNT = 18;  // n8 key tiles of a row: L <= 144
constexpr float kLog2e = 1.4426950408889634f;

// Four [Lp][72] tiles, two [Lp][Lp+8] ones, the column bias of kNT * 8
// columns, and three rows of 16 floats per warp (Lp / 8 warps) through
// which the two warps of a row tile add up their halves.
size_t smem_bytes_mma(int Lp, int kNT) {
  return sizeof(bf16) * (4 * size_t(Lp) * vlp::kTileStride +
                         2 * size_t(Lp) * (Lp + 8)) +
         sizeof(float) * (kNT * 8 + 3 * (Lp / 8) * 16);
}

// Two warps per 16-row tile (Lp / 8 warps): warp w owns query rows
// 16 (w / 2) .. +15 and the key columns of half w % 2 for S, P, dP and dS,
// the pair adding up its row max, sum and rowsum through shared memory;
// after P o keep and dS are in shared memory it owns the 16 rows of dQ, dK
// and dV of tile w / 2 in d-columns 32 (w % 2) .. +31.
template <int kNT, bool kDrop>
__global__ void __launch_bounds__(kNT * 32, 1)
    attention_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      const int* __restrict__ mode,
                      const int* __restrict__ text_end,
                      const float* __restrict__ colkeep, int L, int H,
                      vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                      int prefix, float scale, vlp::Dropout dp, int align) {
  constexpr int kH = kNT / 2;       // n8 tiles of a warp's half of a row
  constexpr int TS = vlp::kTileStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;    // blockDim.x == 4 * Lp
  const int LS = Lp + 8;            // row of an [Lp][Lp] bf16 tile
  const int nw = Lp / 8;
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + Lp * TS;
  bf16* sv = sk + Lp * TS;
  bf16* sdo = sv + Lp * TS;
  bf16* spk = sdo + Lp * TS;        // P o keep
  bf16* sds = spk + Lp * LS;        // dS
  float* colbias = reinterpret_cast<float*>(sds + Lp * LS);  // [kNT * 8]
  float* xmax = colbias + kNT * 8;  // [nw][16] each
  float* xsum = xmax + nw * 16;
  float* xrs = xsum + nw * 16;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  vlp::stage_rows(sq, q + in_base, in.l, L, Lp, align);
  vlp::stage_rows(sk, k + in_base, in.l, L, Lp, align);
  vlp::cp_async_commit();
  vlp::stage_rows(sv, v + in_base, in.l, L, Lp, align);
  vlp::stage_rows(sdo, dout + do_base, ds_in.l, L, Lp, align);
  vlp::cp_async_commit();
  for (int j = threadIdx.x; j < kNT * 8; j += blockDim.x)
    colbias[j] = j >= L ? -CUDART_INF_F
                 : colkeep[(long long)b * L + j] > 0.5f ? 0.f
                                                        : vlp::kNegInf;
  vlp::cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 1) * 16;
  const int c0 = (warp & 1) * kH * 8;
  const int md = mode[b], te = text_end[b];
  // the pair's rows through shared memory: this lane's rows g and g + 8
  auto exchange = [&](float* x, float (&val)[2], bool is_max) {
    if (t == 0) {
      x[warp * 16 + g] = val[0];
      x[warp * 16 + g + 8] = val[1];
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float o = x[(warp ^ 1) * 16 + g + 8 * hh];
      val[hh] = is_max ? fmaxf(val[hh], o) : val[hh] + o;
    }
  };
  auto quad = [](float (&val)[2], bool is_max) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, val[hh], o);
        val[hh] = is_max ? fmaxf(val[hh], y) : val[hh] + y;
      }
  };

  // ---- S, then P in place (fp32), rows r0 .. r0+15, this half's columns
  float p[kH][4];
  vlp::mma_abt<kH>(p, sq, sk, r0, c0, Lp, lane);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  const int lim[2] = {vlp::row_limit(md, te, prefix, r0 + g),
                      vlp::row_limit(md, te, prefix, r0 + g + 8)};
#pragma unroll
  for (int n = 0; n < kH; ++n) {
    // columns past L have bias -inf: excluded from the softmax
    const int j0 = c0 + n * 8 + 2 * t;
    const float2 cb = *reinterpret_cast<const float2*>(colbias + j0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] = __fadd_rn(
          __fmul_rn(p[n][e], scale),
          vlp::mask_bias(e & 1 ? cb.y : cb.x, j0 + (e & 1), lim[e >> 1]));
      m[e >> 1] = fmaxf(m[e >> 1], p[n][e]);
    }
  }
  quad(m, true);
  exchange(xmax, m, true);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] = exp2f((p[n][e] - m[e >> 1]) * kLog2e);
      sum[e >> 1] += p[n][e];
    }
  quad(sum, false);
  vlp::cp_async_wait<0>();          // V and dO, visible after the barrier
  exchange(xsum, sum, false);
  // rows past L: P = 0, so dS = 0 there
  const float inv[2] = {r0 + g < L ? 1.f / sum[0] : 0.f,
                        r0 + g + 8 < L ? 1.f / sum[1] : 0.f};
#pragma unroll
  for (int n = 0; n < kH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n][e] *= inv[e >> 1];

  // ---- keep (bit n*4+e of kb), and P o keep to shared memory as bf16
  constexpr int kWords = (kH * 4 + 31) / 32;
  uint32_t kb[kWords] = {};
#pragma unroll
  for (int n = 0; n < kH; ++n) {
    float mult[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (kDrop) {
      if (c0 + n * 8 < L)
        vlp::keep_frag(dp, b, h, r0 + g, c0 + n * 8, lane, mult);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (mult[e] != 0.f) kb[(n * 4 + e) / 32] |= 1u << ((n * 4 + e) % 32);
    }
    if (c0 + n * 8 < Lp) {
      bf16* row = spk + (r0 + g) * LS + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) =
          vlp::pack_bf16(p[n][0] * mult[0], p[n][1] * mult[1]);
      *reinterpret_cast<uint32_t*>(row + 8 * LS) =
          vlp::pack_bf16(p[n][2] * mult[2], p[n][3] * mult[3]);
    }
  }

  // ---- dP = dO V^T, its keep, rowsum(dP o keep o P) over the pair
  float dpk[kH][4];
  vlp::mma_abt<kH>(dpk, sdo, sv, r0, c0, Lp, lane);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDrop)
        dpk[n][e] *= (kb[(n * 4 + e) / 32] >> ((n * 4 + e) % 32)) & 1u
                         ? dp.scale
                         : 0.f;
      rs[e >> 1] += dpk[n][e] * p[n][e];
    }
  quad(rs, false);
  exchange(xrs, rs, false);

  // ---- dS = P o (dP o keep - rowsum) to shared memory as bf16
#pragma unroll
  for (int n = 0; n < kH; ++n) {
    if (c0 + n * 8 < Lp) {
      bf16* row = sds + (r0 + g) * LS + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) =
          vlp::pack_bf16(p[n][0] * (dpk[n][0] - rs[0]),
                         p[n][1] * (dpk[n][1] - rs[0]));
      *reinterpret_cast<uint32_t*>(row + 8 * LS) =
          vlp::pack_bf16(p[n][2] * (dpk[n][2] - rs[1]),
                         p[n][3] * (dpk[n][3] - rs[1]));
    }
  }
  __syncthreads();

  // ---- tile r0 in d-columns d0 .. d0+31: dQ = dS K * scale (query rows),
  // dK = dS^T Q * scale and dV = (P o keep)^T dO (key rows)
  const int d0 = (warp & 1) * 32;
  float qa[4][4] = {}, ka[4][4] = {}, va[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kNT * 8; k0 += 16) {
    if (k0 >= Lp) continue;
    uint32_t fa[4], fs[4], fp[4];
    vlp::ldsm_x4(fa, sds + (r0 + (lane & 15)) * LS + k0 + (lane >> 4) * 8);
    const int off = (k0 + (lane & 7) + (lane >> 4) * 8) * LS + r0 +
                    ((lane >> 3) & 1) * 8;
    vlp::ldsm_x4_t(fs, sds + off);
    vlp::ldsm_x4_t(fp, spk + off);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int boff = (k0 + (lane & 15)) * TS + d0 + np * 16 +
                       (lane >> 4) * 8;
      uint32_t fb[4];
      vlp::ldsm_x4_t(fb, sk + boff);
      vlp::mma_bf16(qa[2 * np], fa, fb[0], fb[1]);
      vlp::mma_bf16(qa[2 * np + 1], fa, fb[2], fb[3]);
      vlp::ldsm_x4_t(fb, sq + boff);
      vlp::mma_bf16(ka[2 * np], fs, fb[0], fb[1]);
      vlp::mma_bf16(ka[2 * np + 1], fs, fb[2], fb[3]);
      vlp::ldsm_x4_t(fb, sdo + boff);
      vlp::mma_bf16(va[2 * np], fp, fb[0], fb[1]);
      vlp::mma_bf16(va[2 * np + 1], fp, fb[2], fb[3]);
    }
  }
  const long long out_base = b * os.b + h * os.h + d0;
  vlp::store_rows(dq + out_base, os.l, qa, r0, L, lane, scale);
  vlp::store_rows(dk + out_base, os.l, ka, r0, L, lane, scale);
  vlp::store_rows(dv + out_base, os.l, va, r0, L, lane, 1.f);
}

// ---- bf16, 144 < L <= the forward's limit: key-chunked, on the tensor
// cores

constexpr int kLongWarps = 16;
constexpr int kKeyChunk = 128;        // key columns staged at a time
constexpr int kGroup = 32;            // query rows of one gradient step
constexpr int kCS = kKeyChunk + 8;    // row of a [kGroup][kKeyChunk] tile

__host__ __device__ __forceinline__ int long_rows(int L) {
  return (L + kGroup - 1) & ~(kGroup - 1);
}
__host__ __device__ __forceinline__ int long_chunks(int L) {
  return (L + kKeyChunk - 1) / kKeyChunk;
}

// Q and dO [Lq][72], one key chunk of K and V [128][72], P o keep and dS of
// one group [32][136]; the column bias of every chunk, and the row max,
// sum and rowsum(dP o keep o P) of every query row.
size_t smem_bytes_long(int L) {
  const size_t Lq = long_rows(L);
  return sizeof(bf16) * (2 * Lq * vlp::kTileStride +
                         2 * kKeyChunk * vlp::kTileStride + 2 * kGroup * kCS) +
         sizeof(float) * (long_chunks(L) * kKeyChunk + 3 * Lq);
}

// s = the masked, scaled scores of query rows r0 + g and r0 + g + 8 against
// the kN n8 tiles at column c0 of the staged key chunk (whose first column
// is cb); columns past L are -inf.
template <int kN>
__device__ __forceinline__ void chunk_scores(
    float (&s)[kN][4], const bf16* sq, const bf16* sk, const float* colbias,
    int r0, int cb, int c0, int lane, const int (&lim)[2], float scale) {
  vlp::mma_abt<kN>(s, sq, sk, r0, c0, kKeyChunk, lane);
  const int j0 = cb + c0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const float2 cb2 = *reinterpret_cast<const float2*>(colbias + j0 + n * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = __fadd_rn(
          __fmul_rn(s[n][e], scale),
          vlp::mask_bias(e & 1 ? cb2.y : cb2.x, j0 + n * 8 + (e & 1),
                         lim[e >> 1]));
  }
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

// Three passes over 128-column key chunks (K, or K and V, staged once per
// pass and chunk; Q and dO stay staged throughout):
//   1. each warp's 16-row query tiles: the row max and sum over all keys,
//      rescaled from chunk to chunk;
//   2. the same tiles: rowsum(dP o keep o P), P from the final max and sum;
//   3. per chunk, 32 query rows at a time: each warp forms P o keep and dS
//      (bf16, the L <= 144 body's rounding) of one 16 x 16 tile into shared
//      memory, then owns 16 key rows x 32 d-columns of dK and dV (kept in
//      registers over the chunk's groups) and 16 query rows x 8 d-columns of
//      dQ, which it adds up over the chunks in fp32 in dq_acc
//      ([B*H][Lq][64], the rows this block alone touches) and stores as bf16
//      after the last.
template <bool kDrop>
__global__ void __launch_bounds__(kLongWarps * 32, 1)
    attention_bwd_long(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dq_acc,
                       const int* __restrict__ mode,
                       const int* __restrict__ text_end,
                       const float* __restrict__ colkeep, int L, int H,
                       vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                       int prefix, float scale, vlp::Dropout dp, int align) {
  constexpr int TS = vlp::kTileStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lq = long_rows(L), nc = long_chunks(L);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + Lq * TS;
  bf16* sk = sdo + Lq * TS;             // key chunk c
  bf16* sv = sk + kKeyChunk * TS;
  bf16* spk = sv + kKeyChunk * TS;      // P o keep of a group
  bf16* sds = spk + kGroup * kCS;       // dS of a group
  float* colbias = reinterpret_cast<float*>(sds + kGroup * kCS);
  float* rmax = colbias + nc * kKeyChunk;
  float* rsum = rmax + Lq;
  float* rdot = rsum + Lq;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  const long long out_base = b * os.b + h * os.h;
  float* acc = dq_acc + (long long)blockIdx.x * Lq * D;
  vlp::stage_rows(sq, q + in_base, in.l, L, Lq, align);
  vlp::stage_rows(sdo, dout + do_base, ds_in.l, L, Lq, align);
  vlp::cp_async_commit();
  for (int j = threadIdx.x; j < nc * kKeyChunk; j += blockDim.x)
    colbias[j] = j >= L ? -CUDART_INF_F
                 : colkeep[(long long)b * L + j] > 0.5f ? 0.f
                                                        : vlp::kNegInf;
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) {
    rmax[i] = -CUDART_INF_F;
    rsum[i] = 0.f;
    rdot[i] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int md = mode[b], te = text_end[b];
  // stages chunk c's K (and V); the barriers fence the previous readers
  auto stage_chunk = [&](int cb, bool with_v) {
    __syncthreads();
    const int Lc = min(kKeyChunk, L - cb);
    vlp::stage_rows(sk, k + in_base + cb * in.l, in.l, Lc, kKeyChunk, align);
    if (with_v)
      vlp::stage_rows(sv, v + in_base + cb * in.l, in.l, Lc, kKeyChunk,
                      align);
    vlp::cp_async_commit();
    vlp::cp_async_wait<0>();
    __syncthreads();
  };
  auto limits = [&](int r0, int (&lim)[2]) {
    lim[0] = vlp::row_limit(md, te, prefix, r0 + g);
    lim[1] = vlp::row_limit(md, te, prefix, r0 + g + 8);
  };
  // P = exp(S - max) / sum in place; rows past L are 0
  auto probs = [&](auto& s, int r0) {
    float m[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = r0 + g + 8 * hh;
      m[hh] = rmax[i];
      inv[hh] = i < L ? 1.f / rsum[i] : 0.f;
    }
#pragma unroll
    for (auto& tile : s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[e] = exp2f((tile[e] - m[e >> 1]) * kLog2e) * inv[e >> 1];
  };

  // ---- pass 1: row max and sum, one 128-column chunk in registers
  for (int c = 0; c < nc; ++c) {
    const int cb = c * kKeyChunk;
    stage_chunk(cb, false);
    for (int r0 = warp * 16; r0 < Lq; r0 += kLongWarps * 16) {
      int lim[2];
      limits(r0, lim);
      float s[kKeyChunk / 8][4];
      chunk_scores(s, sq, sk, colbias, r0, cb, 0, lane, lim, scale);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = r0 + g + 8 * hh;
        float cm = -CUDART_INF_F;
#pragma unroll
        for (auto& tile : s)
          cm = fmaxf(cm, fmaxf(tile[2 * hh], tile[2 * hh + 1]));
        // every chunk holds a column < L, so cm is finite
        const float m_old = rmax[i];
        const float m_new = fmaxf(m_old, quad_max(cm));
        float cs = 0.f;
#pragma unroll
        for (auto& tile : s)
          cs += exp2f((tile[2 * hh] - m_new) * kLog2e) +
                exp2f((tile[2 * hh + 1] - m_new) * kLog2e);
        cs = quad_sum(cs);
        const float l = rsum[i] * exp2f((m_old - m_new) * kLog2e) + cs;
        __syncwarp();
        if (t == 0) {
          rmax[i] = m_new;
          rsum[i] = l;
        }
      }
    }
  }

  // ---- pass 2: rowsum(dP o keep o P) (P without keep), in two halves of
  // the chunk
  for (int c = 0; c < nc; ++c) {
    const int cb = c * kKeyChunk;
    stage_chunk(cb, true);
    for (int r0 = warp * 16; r0 < Lq; r0 += kLongWarps * 16) {
      int lim[2];
      limits(r0, lim);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c0 = 0; c0 < kKeyChunk; c0 += kKeyChunk / 2) {
        float p[kKeyChunk / 16][4], dpk[kKeyChunk / 16][4];
        chunk_scores(p, sq, sk, colbias, r0, cb, c0, lane, lim, scale);
        probs(p, r0);
        vlp::mma_abt<kKeyChunk / 16>(dpk, sdo, sv, r0, c0, kKeyChunk, lane);
#pragma unroll
        for (int n = 0; n < kKeyChunk / 16; ++n) {
          float mult[4] = {1.f, 1.f, 1.f, 1.f};
          if (kDrop && cb + c0 + n * 8 < L)
            vlp::keep_frag(dp, b, h, r0 + g, cb + c0 + n * 8, lane, mult);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[e >> 1] += dpk[n][e] * mult[e] * p[n][e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x = quad_sum(rs[hh]);
        if (t == 0) rdot[r0 + g + 8 * hh] += x;
      }
    }
  }

  // ---- pass 3: dS, then dK and dV per chunk, dQ over the chunks
  const int qt = warp >> 3;           // query tile of the group
  const int kc = (warp & 7) * 16;     // key columns of the chunk (step 1)
  const int kr0 = (warp >> 1) * 16;   // dK/dV key rows of the chunk
  const int d0 = (warp & 1) * 32;     // their d-columns
  const int dn = (warp & 7) * 8;      // dQ d-columns of rows qt
  for (int c = 0; c < nc; ++c) {
    const int cb = c * kKeyChunk;
    stage_chunk(cb, true);
    float ka[4][4] = {}, va[4][4] = {};
    for (int g0 = 0; g0 < Lq; g0 += kGroup) {
      const int r0 = g0 + qt * 16;
      // this lane's dQ sums of the earlier chunks, loaded ahead of their use
      float2* dq_sum[2];
      float2 before[2] = {};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dq_sum[hh] = reinterpret_cast<float2*>(acc + (r0 + g + 8 * hh) * D +
                                               dn + 2 * t);
        if (c > 0) before[hh] = *dq_sum[hh];
      }
      int lim[2];
      limits(r0, lim);
      float p[2][4], dpk[2][4];
      chunk_scores(p, sq, sk, colbias, r0, cb, kc, lane, lim, scale);
      probs(p, r0);
      vlp::mma_abt<2>(dpk, sdo, sv, r0, kc, kKeyChunk, lane);
      const float rs[2] = {rdot[r0 + g], rdot[r0 + g + 8]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float mult[4] = {1.f, 1.f, 1.f, 1.f};
        if (kDrop && cb + kc + n * 8 < L)
          vlp::keep_frag(dp, b, h, r0 + g, cb + kc + n * 8, lane, mult);
        const int off = (qt * 16 + g) * kCS + kc + n * 8 + 2 * t;
        bf16* pk_row = spk + off;
        bf16* ds_row = sds + off;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* x = p[n] + 2 * hh;
          const float* y = dpk[n] + 2 * hh;
          *reinterpret_cast<uint32_t*>(pk_row + 8 * hh * kCS) =
              vlp::pack_bf16(x[0] * mult[2 * hh], x[1] * mult[2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(ds_row + 8 * hh * kCS) =
              vlp::pack_bf16(x[0] * (y[0] * mult[2 * hh] - rs[hh]),
                             x[1] * (y[1] * mult[2 * hh + 1] - rs[hh]));
        }
      }
      __syncthreads();

      // dK = dS^T Q, dV = (P o keep)^T dO over the group's 32 rows
#pragma unroll
      for (int k0 = 0; k0 < kGroup; k0 += 16) {
        uint32_t fs[4], fp[4];
        const int off = (k0 + (lane & 7) + (lane >> 4) * 8) * kCS + kr0 +
                        ((lane >> 3) & 1) * 8;
        vlp::ldsm_x4_t(fs, sds + off);
        vlp::ldsm_x4_t(fp, spk + off);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int boff = (g0 + k0 + (lane & 15)) * TS + d0 + np * 16 +
                           (lane >> 4) * 8;
          uint32_t fb[4];
          vlp::ldsm_x4_t(fb, sq + boff);
          vlp::mma_bf16(ka[2 * np], fs, fb[0], fb[1]);
          vlp::mma_bf16(ka[2 * np + 1], fs, fb[2], fb[3]);
          vlp::ldsm_x4_t(fb, sdo + boff);
          vlp::mma_bf16(va[2 * np], fp, fb[0], fb[1]);
          vlp::mma_bf16(va[2 * np + 1], fp, fb[2], fb[3]);
        }
      }
      // dQ = dS K over the chunk's 128 keys, added up over the chunks
      float qa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < kKeyChunk; k0 += 16) {
        uint32_t fa[4], fb[2];
        vlp::ldsm_x4(fa, sds + (qt * 16 + (lane & 15)) * kCS + k0 +
                             (lane >> 4) * 8);
        vlp::ldsm_x2_t(fb, sk + (k0 + (lane & 15)) * TS + dn);
        vlp::mma_bf16(qa, fa, fb[0], fb[1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = r0 + g + 8 * hh;
        const float x = qa[2 * hh] + before[hh].x;
        const float y = qa[2 * hh + 1] + before[hh].y;
        if (c + 1 < nc)
          *dq_sum[hh] = make_float2(x, y);
        else if (i < L)
          *reinterpret_cast<uint32_t*>(dq + out_base + i * os.l + dn +
                                       2 * t) =
              vlp::pack_bf16(x * scale, y * scale);
      }
      __syncthreads();   // the next group rewrites P o keep and dS
    }
    const long long cbase = out_base + cb * os.l + d0;
    const int Lc = min(kKeyChunk, L - cb);
    vlp::store_rows(dk + cbase, os.l, ka, kr0, Lc, lane, scale);
    vlp::store_rows(dv + cbase, os.l, va, kr0, Lc, lane, 1.f);
  }
}

template <bool kDrop>
int launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, const int* mode,
                const int* text_end, const float* colkeep, int B, int L,
                int H, vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                int prefix, float scale, vlp::Dropout dp,
                cudaStream_t stream) {
  const size_t smem = smem_bytes_fp32(L);
  if (smem > (size_t)vlp::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_fp32<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_fp32<kDrop><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), mode, text_end, colkeep, L, H, in, ds_in, os,
      prefix, scale, dp);
  return (int)cudaGetLastError();
}

template <int kNT, bool kDrop>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
               int prefix, float scale, vlp::Dropout dp, cudaStream_t stream) {
  const int Lp = (L + 15) & ~15;
  const size_t smem = smem_bytes_mma(Lp, kNT);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 2ull * in.b, 2ull * in.h, 2ull * in.l,
       2ull * ds_in.b, 2ull * ds_in.h, 2ull * ds_in.l});
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_mma<kNT, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_mma<kNT, kDrop><<<B * H, 4 * Lp, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      mode, text_end, colkeep, L, H, in, ds_in, os, prefix, scale, dp, align);
  return (int)cudaGetLastError();
}

// The key-chunked body, for 8 * kMaxNT < L; dq_acc holds its dQ sums.
template <bool kDrop>
int launch_long(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* dq_acc, const int* mode,
                const int* text_end, const float* colkeep, int B, int L,
                int H, vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                int prefix, float scale, vlp::Dropout dp,
                cudaStream_t stream) {
  const size_t smem = smem_bytes_long(L);
  if (smem > (size_t)vlp::kMaxSmemBytes || dq_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 2ull * in.b, 2ull * in.h, 2ull * in.l,
       2ull * ds_in.b, 2ull * ds_in.h, 2ull * ds_in.l});
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_long<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_long<kDrop><<<B * H, kLongWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dq_acc, mode, text_end, colkeep, L, H, in, ds_in, os, prefix, scale, dp,
      align);
  return (int)cudaGetLastError();
}

// The largest L the body of this dtype takes: in bf16 the forward's own
// limit, in fp32 the first version's.
int max_len(int is_bf16) {
  if (is_bf16) return vlp::attention_fwd_max_len(1);
  int L = 1;
  while (smem_bytes_fp32(L + 1) <= (size_t)vlp::kMaxSmemBytes) ++L;
  return L;
}

// fp32 scratch (floats per example and head) the body for L needs: the
// key-chunked body's dQ sums.
int scratch_floats(int L, int is_bf16) {
  return is_bf16 && L > 8 * kMaxNT ? long_rows(L) * D : 0;
}

// bf16: the whole problem in one block up to 8 * kMaxNT, key chunks
// beyond; fp32: the first version.
template <bool kDrop>
int launch_any(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* dq_acc, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
               int prefix, float scale, vlp::Dropout dp, int is_bf16,
               cudaStream_t stream) {
  if (!is_bf16)
    return launch_fp32<kDrop>(q, k, v, dout, dq, dk, dv, mode, text_end,
                              colkeep, B, L, H, in, ds_in, os, prefix, scale,
                              dp, stream);
  if (L <= 128)
    return launch_mma<16, kDrop>(q, k, v, dout, dq, dk, dv, mode, text_end,
                                 colkeep, B, L, H, in, ds_in, os, prefix,
                                 scale, dp, stream);
  if (L <= 8 * kMaxNT)
    return launch_mma<kMaxNT, kDrop>(q, k, v, dout, dq, dk, dv, mode,
                                     text_end, colkeep, B, L, H, in, ds_in,
                                     os, prefix, scale, dp, stream);
  return launch_long<kDrop>(q, k, v, dout, dq, dk, dv, dq_acc, mode, text_end,
                            colkeep, B, L, H, in, ds_in, os, prefix, scale,
                            dp, stream);
}

int backward(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, void* dq_acc, const void* mode,
             const void* text_end, const void* colkeep, int B, int L, int H,
             vlp::Strides in, vlp::Strides ds_in, vlp::Strides os, int prefix,
             float scale, vlp::Dropout dp, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || L > max_len(is_bf16))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto acc = static_cast<float*>(dq_acc);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  if (dp.threshold == 0)  // rate 0: every element kept with scale 1
    return launch_any<false>(q, k, v, dout, dq, dk, dv, acc, md, te, ck, B, L,
                             H, in, ds_in, os, prefix, scale, dp, is_bf16, s);
  return launch_any<true>(q, k, v, dout, dq, dk, dv, acc, md, te, ck, B, L, H,
                          in, ds_in, os, prefix, scale, dp, is_bf16, s);
}

}  // namespace

extern "C" {

// The largest L whose tiles fit the body that is_bf16 selects: the bf16
// tensor-core bodies (1) or the fp32 body (0).
int vlp_attention_bwd_max_len(int is_bf16) { return max_len(is_bf16); }

// The fp32 scratch, in floats per (example, head), that a backward at L
// needs in dq_acc (0: none; dq_acc may then be null).
int vlp_attention_bwd_scratch_floats(int L, int is_bf16) {
  return scratch_floats(L, is_bf16);
}

// q/k/v: [B, L, H*64] with element strides sb (batch) and sl (row); dout:
// [B, L, H*64] with strides dsb, dsl; the last dimension contiguous in
// all four.  dq/dk/dv: contiguous [B, L, H*64]; dq_acc: fp32 scratch of
// B * H * vlp_attention_bwd_scratch_floats(L, is_bf16) floats.
// seed/threshold/keep_scale are the forward's dropout (threshold 0 = no
// dropout).  is_bf16 selects the bf16 tensor-core bodies (1) or the fp32
// body (0).  Returns cudaGetLastError() after the launch.
int vlp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      void* dq_acc, const void* mode, const void* text_end,
                      const void* colkeep, int B, int L, int H, long long sb,
                      long long sl, long long dsb, long long dsl, int prefix,
                      float scale, unsigned long long seed,
                      unsigned int threshold, float keep_scale, int is_bf16,
                      void* stream) {
  const long long HD = (long long)H * D;
  return backward(q, k, v, dout, dq, dk, dv, dq_acc, mode, text_end, colkeep,
                  B, L, H, vlp::Strides{sb, D, sl}, vlp::Strides{dsb, D, dsl},
                  vlp::Strides{L * HD, D, HD}, prefix, scale,
                  vlp::Dropout{seed, threshold, keep_scale}, is_bf16, stream);
}

// The bhld layout: q/k/v [B, H, L, 64] with element strides sb (batch), sh
// (head) and sl (row); dout [B, H, L, 64] with strides dsb, dsh, dsl; the
// last dimension contiguous in all four.  dq/dk/dv: contiguous
// [B, H, L, 64].  Otherwise as vlp_attention_bwd.
int vlp_attention_bwd_bhld(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* dq_acc, const void* mode,
                           const void* text_end, const void* colkeep, int B,
                           int L, int H, long long sb, long long sh,
                           long long sl, long long dsb, long long dsh,
                           long long dsl, int prefix, float scale,
                           unsigned long long seed, unsigned int threshold,
                           float keep_scale, int is_bf16, void* stream) {
  const long long LD = (long long)L * D;
  return backward(q, k, v, dout, dq, dk, dv, dq_acc, mode, text_end, colkeep,
                  B, L, H, vlp::Strides{sb, sh, sl},
                  vlp::Strides{dsb, dsh, dsl}, vlp::Strides{H * LD, LD, D},
                  prefix, scale, vlp::Dropout{seed, threshold, keep_scale},
                  is_bf16, stream);
}

}  // extern "C"
