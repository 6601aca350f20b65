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
// Two bodies, chosen by dtype (never by a failure):
// * bf16, every main path: attention_bwd_mma, on the tensor cores
//   (mma.m16n8k16, bf16 operands, fp32 accumulation).  One block per
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

// The largest L the body of this dtype takes.
int max_len(int is_bf16) {
  if (is_bf16) return 8 * kMaxNT;
  int L = 1;
  while (smem_bytes_fp32(L + 1) <= (size_t)vlp::kMaxSmemBytes) ++L;
  return L;
}

template <bool kDrop>
int launch_any(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const int* mode,
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
  return launch_mma<kMaxNT, kDrop>(q, k, v, dout, dq, dk, dv, mode, text_end,
                                   colkeep, B, L, H, in, ds_in, os, prefix,
                                   scale, dp, stream);
}

int backward(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, const void* mode,
             const void* text_end, const void* colkeep, int B, int L, int H,
             vlp::Strides in, vlp::Strides ds_in, vlp::Strides os, int prefix,
             float scale, vlp::Dropout dp, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || L > max_len(is_bf16))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  if (dp.threshold == 0)  // rate 0: every element kept with scale 1
    return launch_any<false>(q, k, v, dout, dq, dk, dv, md, te, ck, B, L, H,
                             in, ds_in, os, prefix, scale, dp, is_bf16, s);
  return launch_any<true>(q, k, v, dout, dq, dk, dv, md, te, ck, B, L, H, in,
                          ds_in, os, prefix, scale, dp, is_bf16, s);
}

}  // namespace

extern "C" {

// The largest L whose tiles fit the body that is_bf16 selects: the bf16
// tensor-core body (1) or the fp32 body (0).
int vlp_attention_bwd_max_len(int is_bf16) { return max_len(is_bf16); }

// q/k/v: [B, L, H*64] with element strides sb (batch) and sl (row); dout:
// [B, L, H*64] with strides dsb, dsl; the last dimension contiguous in
// all four.  dq/dk/dv: contiguous [B, L, H*64].  seed/threshold/keep_scale
// are the forward's dropout (threshold 0 = no dropout).  is_bf16 selects
// the bf16 tensor-core body (1) or the fp32 body (0).  Returns
// cudaGetLastError() after the launch.
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
