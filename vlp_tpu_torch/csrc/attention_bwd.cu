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
// The body is chosen by dtype and length (never by a failure).  fp16
// (--true_fp16 training) runs the bf16 bodies below instantiated for
// __half: the same tiles, Philox bits and order of rounding, with P o keep
// and dS rounded to fp16 and mma.m16n8k16 taking .f16 operands at the bf16
// rate.  Nothing is clamped: a dS or gradient past fp16's 65504 becomes
// inf and a NaN stays NaN, which is how the loss scaler sees an overflow.
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
// * bf16, 144 < L <= the kernels' limit (vlp::attention_fwd_max_len(),
//   528): FlashAttention-2's backward with the same rounding and Philox
//   bits, in three kernels (the whole problem no longer fits a block).
//   Each has a grid of (example, head, 128 rows) blocks of 8 warps, each
//   warp owning 16 of the rows, and streams the other operand in 64-row
//   tiles through a double-buffered cp.async ring; an fp32 scratch that
//   the wrapper allocates (vlp_attention_bwd_scratch_floats) carries the
//   first kernel's results to the other two:
//   (a) attention_bwd_stats, per 128 query rows over the key tiles: S and
//       dP = dO V^T, the row max m, the sum l and rowsum(dP o keep o P),
//       the last two rescaled online when the max moves; it writes m, 1/l
//       and rowsum per row, and the keep bits (vlp::keep_frag, one bit per
//       element): Philox runs once, not in every kernel;
//   (b) attention_bwd_dkdv, per 128 keys (K and V staged) over the query
//       tiles: S^T, P^T from (m, 1/l), keep from the bits, dP^T and dS^T
//       in registers, then dV += (P o keep)^T dO and dK += dS^T Q straight
//       from those accumulators (an mma's C fragments are the next one's
//       A), dO and Q as ldmatrix.trans operands;
//   (c) attention_bwd_dq, per 128 query rows over the key tiles: S, P,
//       keep, dP and dS likewise, and dQ += dS K in registers, written
//       once, with no atomics.
//   Regions that the structural mask hides from rows that see a column of
//   their own (s2s rows past the prefix against later keys, bi rows
//   against keys past text_end) hold exact zeros of P and dS and are
//   skipped (masked_region), by all three kernels alike.  Every sum runs
//   in a fixed order: two calls give the same bits.
// * fp32, every L the bf16 bodies take (528): FlashAttention-2's backward
//   in split TF32 on the tensor cores (mma.cuh: each operand split into two
//   TF32 parts, three m16n8k8 products; ~2^-21 relative error per product,
//   an fp32 summation-order difference), which the card-vs-CPU fp32 gates
//   need.  The work of the bf16 tiled body (the same skipped regions and
//   Philox bits) in two kernels: attention_bwd_rows_f32 streams the key
//   tiles twice, first for the statistics and keep bits (the bf16 body's
//   (a)), then for dQ (its (c)), so Q and dO are staged once; then
//   attention_bwd_dkdv_f32 (its (b)).  fp32 arithmetic throughout: scores
//   in natural units as attention_plain adds them (so an all-masked row's
//   -10000 + s is exact where s is), P o keep and dS kept in fp32.  fp32
//   tiles are twice bf16's, so blocks own 64 rows (4 warps) and stream
//   32-row tiles (~72-76 KB of shared memory: three blocks per SM).  The
//   scratch holds each row's m, 1/l and rowsum and one keep word per row
//   and 32 keys (scratch_f32: 7.5 MB at B=16, L=512), no L x L matrix.
//   At B=16, L=512 the nine L x L x 64 products are 58 GFLOP, 174 GFLOP
//   of TF32 work (0.35 ms at 495 TFLOP/s) against ~0.03 ms of bytes.
//   Fragments are read with ldmatrix where the summed index runs along a
//   staged row (an 8 x 8 b16 matrix is an 8 x 4 fp32 one) and with 8-byte
//   loads where it runs across rows.
// What bounds it on an H100: at the training shape (B=64, L=128, H=12,
// D=64, bf16) one call reads q, k, v, dO and writes dq, dk, dv: ~88 MB,
// ~26 us at 3.35 TB/s; the five products are 8.1 GFLOP, ~8 us at 989
// TFLOP/s.  The bf16 body's block needs ~144 KB of shared memory at L=128
// (four [128][72] tiles, two [128][136]), so one block of 16 warps runs
// per SM, and it takes ~14 us per head at one block per SM (PERF.md):
// it is bound by the latency of its serial phases (stage, S, softmax, dP,
// dS, the three products, store) more than by bytes or operations.
// The tiled body at B=64, L=256, rate 0.1 has to move ~176 MB (~53 us at
// 3.35 TB/s) and does nine 256 x 256 x 64 products a head where five would
// do (~58 GFLOP, ~59 us at 989 TFLOP/s), plus ~13 M Philox calls.
// mma.sync takes its B operands from shared memory (4 clocks an
// ldmatrix.x4 at 128 bytes a clock), and the per-element softmax, mask and
// keep work competes with it for issue slots: these, not the tensor cores,
// bound it (PERF.md), so blocks own 128 rows (half the re-streaming of
// 64) and two blocks of 8 warps run per SM (at most 128 registers a
// thread).  The one-block-per-head design before it ran one block of 16
// warps per SM through three serial passes.
// Registers and spills:
// `-Xptxas -v` in the build log (chip_smoke.py prints it).  The wrapper
// rejects an L past the forward's limit (vlp_attention_bwd_max_len, the
// same in both dtypes).

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = vlp::kHeadDim;
using bf16 = __nv_bfloat16;  // the 16-bit element size below (fp16's too)

// ---- bf16 and fp16 (T): on the tensor cores

constexpr int kMaxNT = 18;  // n8 key tiles of a row: L <= 144
using vlp::kLog2e;

// Four [Lp][72] tiles, two [Lp][Lp+8] ones, the column bias of kNT * 8
// columns, and three rows of 16 floats per warp (Lp / 8 warps) through
// which the two warps of a row tile add up their halves.  MLA's (192, 128)
// (kDQ != 64): Q and K tiles of 192 columns, V and dO of 128, and dS in
// V's place once V is read (at Lp <= 128 a row of dS fits V's): 210,432
// bytes at L = 128.
template <int kDQ = D, int kDV = D>
size_t smem_bytes_mma(int Lp, int kNT) {
  const size_t ds = kDQ == D ? 2 : 1;   // [Lp][Lp+8] tiles of their own
  return sizeof(bf16) * (2 * size_t(Lp) * vlp::tile_stride<kDQ>() +
                         2 * size_t(Lp) * vlp::tile_stride<kDV>() +
                         ds * size_t(Lp) * (Lp + 8)) +
         sizeof(float) * (kNT * 8 + 3 * (Lp / 8) * 16);
}

// acc[n] (n < kN) = A(16 rows at r0) * B over the summed rows 0 .. Lp-1
// and B's columns c0 .. c0 + 8 kN - 1: A from an [Lp][LS] tile, read
// transposed (`trans`: dS^T, (P o keep)^T) or not (dS); B a [.][TSB] tile
// (K, Q, dO), read transposed.  The products of the backward's last phase.
template <int kN, typename T, int TSB>
__device__ __forceinline__ void mma_atb(float (&acc)[kN][4], const T* a,
                                        bool trans, const T* b, int r0,
                                        int c0, int Lp, int LS, int lane) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < Lp; k0 += 16) {
    uint32_t fa[4];
    if (trans)
      vlp::ldsm_x4_t(fa, a + (k0 + (lane & 7) + (lane >> 4) * 8) * LS + r0 +
                             ((lane >> 3) & 1) * 8);
    else
      vlp::ldsm_x4(fa, a + (r0 + (lane & 15)) * LS + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t fb[4];
      vlp::ldsm_x4_t(fb, b + (k0 + (lane & 15)) * TSB + c0 + np * 16 +
                             (lane >> 4) * 8);
      vlp::mma16<T>(acc[2 * np], fa, fb[0], fb[1]);
      vlp::mma16<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// MLA's last phase, tile r0 in half `half` of each gradient's columns: dQ
// = dS K * scale, dK = dS^T Q * scale (kDQ / 2 columns each), dV = (P o
// keep)^T dO (kDV / 2), one after another, each stored before the next.
template <typename T, int kNT, int kDQ, int kDV>
__device__ __forceinline__ void mla_products(
    const T* sq, const T* sk, const T* sdo, const T* spk, const T* sds,
    T* dq, T* dk, T* dv, int b, int h, int r0, int L, int Lp, int LS,
    int lane, int half, vlp::Strides os, vlp::Strides osv, float scale) {
  constexpr int TS = vlp::tile_stride<kDQ>();
  constexpr int TSV = vlp::tile_stride<kDV>();
  constexpr int kNq = kDQ / 16, kNv = kDV / 16;  // n8 tiles of a half
  const int dq0 = half * kDQ / 2, dv0 = half * kDV / 2;
  const long long qbase = b * os.b + h * os.h + dq0;
  {
    float acc[kNq][4];
    mma_atb<kNq, T, TS>(acc, sds, false, sk, r0, dq0, Lp, LS, lane);
    vlp::store_rows(dq + qbase, os.l, acc, r0, L, lane, scale);
  }
  {
    float acc[kNq][4];
    mma_atb<kNq, T, TS>(acc, sds, true, sq, r0, dq0, Lp, LS, lane);
    vlp::store_rows(dk + qbase, os.l, acc, r0, L, lane, scale);
  }
  {
    float acc[kNv][4];
    mma_atb<kNv, T, TSV>(acc, spk, true, sdo, r0, dv0, Lp, LS, lane);
    vlp::store_rows(dv + b * osv.b + h * osv.h + dv0, osv.l, acc, r0, L,
                    lane, 1.f);
  }
}

// Two warps per 16-row tile (Lp / 8 warps): warp w owns query rows
// 16 (w / 2) .. +15 and the key columns of half w % 2 for S, P, dP and dS,
// the pair adding up its row max, sum and rowsum through shared memory;
// after P o keep and dS are in shared memory it owns the 16 rows of dQ, dK
// and dV of tile w / 2 in d-columns 32 (w % 2) .. +31.  q and k have kDQ
// columns a head (strides `in`; dq and dk `os`), v, dO and dv kDV
// (`vin`, `ds_in`, `osv`); at MLA's (192, 128) a warp forms dQ, dK and dV
// of its half of the columns one after another (96 + 96 + 64 fp32 would
// not fit 128 registers at once).
template <typename T, int kNT, bool kDrop, int kDQ = D, int kDV = D>
__global__ void __launch_bounds__(kNT * 32, 1)
    attention_bwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const T* __restrict__ dout, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv,
                      const int* __restrict__ mode,
                      const int* __restrict__ text_end,
                      const float* __restrict__ colkeep, int L, int H,
                      vlp::Strides in, vlp::Strides vin, vlp::Strides ds_in,
                      vlp::Strides os, vlp::Strides osv, int prefix,
                      float scale, vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  constexpr int kH = kNT / 2;       // n8 tiles of a warp's half of a row
  constexpr bool kMla = kDQ != D;
  constexpr int TS = vlp::tile_stride<kDQ>();
  constexpr int TSV = vlp::tile_stride<kDV>();
  static_assert(!kMla || kNT * 8 + 8 <= TSV, "dS fits V's rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;    // blockDim.x == 4 * Lp
  const int LS = Lp + 8;            // row of an [Lp][Lp] bf16 tile
  const int nw = Lp / 8;
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + Lp * TS;
  T* sv = sk + Lp * TS;
  T* sdo = sv + Lp * TSV;
  T* spk = sdo + Lp * TSV;          // P o keep
  T* sds = kMla ? sv : spk + Lp * LS;  // dS (MLA: once V has been read)
  float* colbias =
      reinterpret_cast<float*>(spk + (kMla ? 1 : 2) * Lp * LS);  // [kNT*8]
  float* xmax = colbias + kNT * 8;  // [nw][16] each
  float* xsum = xmax + nw * 16;
  float* xrs = xsum + nw * 16;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  vlp::stage_rows<T, kDQ>(sq, q + in_base, in.l, L, Lp, align);
  vlp::stage_rows<T, kDQ>(sk, k + in_base, in.l, L, Lp, align);
  vlp::cp_async_commit();
  vlp::stage_rows<T, kDV>(sv, v + b * vin.b + h * vin.h, vin.l, L, Lp,
                          align);
  vlp::stage_rows<T, kDV>(sdo, dout + do_base, ds_in.l, L, Lp, align);
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
  vlp::mma_abt<kH, T, kDQ>(p, sq, sk, r0, c0, Lp, lane);
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
      T* row = spk + (r0 + g) * LS + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) =
          vlp::pack16<T>(p[n][0] * mult[0], p[n][1] * mult[1]);
      *reinterpret_cast<uint32_t*>(row + 8 * LS) =
          vlp::pack16<T>(p[n][2] * mult[2], p[n][3] * mult[3]);
    }
  }

  // ---- dP = dO V^T, its keep, rowsum(dP o keep o P) over the pair
  float dpk[kH][4];
  vlp::mma_abt<kH, T, kDV>(dpk, sdo, sv, r0, c0, Lp, lane);
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

  // ---- dS = P o (dP o keep - rowsum) to shared memory as bf16 (MLA: into
  // V's tile, which every warp has read before the exchange's barrier)
#pragma unroll
  for (int n = 0; n < kH; ++n) {
    if (c0 + n * 8 < Lp) {
      T* row = sds + (r0 + g) * LS + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) =
          vlp::pack16<T>(p[n][0] * (dpk[n][0] - rs[0]),
                         p[n][1] * (dpk[n][1] - rs[0]));
      *reinterpret_cast<uint32_t*>(row + 8 * LS) =
          vlp::pack16<T>(p[n][2] * (dpk[n][2] - rs[1]),
                         p[n][3] * (dpk[n][3] - rs[1]));
    }
  }
  __syncthreads();

  if constexpr (kMla) {
    mla_products<T, kNT, kDQ, kDV>(sq, sk, sdo, spk, sds, dq, dk, dv, b, h,
                                   r0, L, Lp, LS, lane, warp & 1, os, osv,
                                   scale);
    return;
  }
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
      vlp::mma16<T>(qa[2 * np], fa, fb[0], fb[1]);
      vlp::mma16<T>(qa[2 * np + 1], fa, fb[2], fb[3]);
      vlp::ldsm_x4_t(fb, sq + boff);
      vlp::mma16<T>(ka[2 * np], fs, fb[0], fb[1]);
      vlp::mma16<T>(ka[2 * np + 1], fs, fb[2], fb[3]);
      vlp::ldsm_x4_t(fb, sdo + boff);
      vlp::mma16<T>(va[2 * np], fp, fb[0], fb[1]);
      vlp::mma16<T>(va[2 * np + 1], fp, fb[2], fb[3]);
    }
  }
  const long long out_base = b * os.b + h * os.h + d0;
  vlp::store_rows(dq + out_base, os.l, qa, r0, L, lane, scale);
  vlp::store_rows(dk + out_base, os.l, ka, r0, L, lane, scale);
  vlp::store_rows(dv + out_base, os.l, va, r0, L, lane, 1.f);
}

// ---- bf16 and fp16, 144 < L <= the forward's limit: FlashAttention-2's
// backward in three kernels: blocks of 8 warps own 128 rows (or keys) and stream
// the other operand in 64-row tiles

constexpr int kOwn = 128;               // rows (keys) a block owns
constexpr int kOwnWarps = kOwn / 16;    // one warp per 16 of them
constexpr int kThreadsT = kOwnWarps * 32;
constexpr int kTile = 64;               // rows of a streamed tile
constexpr int kHalf = kTile / 2;        // key columns of one step
constexpr int kStep = 16;               // query columns of a dK/dV step
constexpr int kTS = vlp::kTileStride;
constexpr int kTileElems = kTile * kTS; // bf16 of one staged [64][72] tile
constexpr int kOwnElems = kOwn * kTS;
constexpr int kMinBlocksT = 2;          // blocks per SM (launch bounds)
using u64 = unsigned long long;
using vlp::first_kept;
using vlp::masked_region;
using vlp::quad_max;
using vlp::quad_sum;
using vlp::ring_next;

// Blocks along L (128 rows each) and 64-row tiles along L.
__host__ __device__ __forceinline__ int own_blocks(int L) {
  return (L + kOwn - 1) / kOwn;
}
__host__ __device__ __forceinline__ int long_tiles(int L) {
  return (L + kTile - 1) / kTile;
}
// The scratch of one (example, head), in floats: the row max m (in log2
// units), 1/l and rowsum(dP o keep o P) of each of the Lt = 128 *
// own_blocks(L) query rows ([3][Lt] fp32; 0, 0, 0 past L), then the keep
// bits ([64-key tile][Lt] u64: bit c of word (kt, i) keeps column
// 64 kt + c of row i).
__host__ __device__ __forceinline__ int long_scratch(int L) {
  return (3 + 2 * long_tiles(L)) * own_blocks(L) * kOwn;
}

// The statistics and dQ kernels: their 128 rows of Q and dO, a ring of
// two stages of one key tile of K and V and (for dQ) the keep words of
// the block's rows, and the column bias of every key.
size_t smem_bytes_rows(int L) {
  return sizeof(bf16) * (2 * kOwnElems + 4 * kTileElems) +
         sizeof(u64) * 2 * kOwn + sizeof(float) * long_tiles(L) * kTile;
}
// The dK/dV kernel: its 128 keys of K and V, and a ring of two stages of
// one query tile of Q, dO, their rows' statistics and the keep words of
// the block's two key tiles.
constexpr size_t kSmemBytesCols =
    sizeof(bf16) * (2 * kOwnElems + 4 * kTileElems) +
    sizeof(float) * 2 * 3 * kTile + sizeof(u64) * 2 * 2 * kTile;

// The tiled body keeps scores in log2 units (S * log2(e)), so that
// exp(S - m) is one ex2 of a difference: the masks are scaled alike.
using vlp::colbias2;
using vlp::ex2;
using vlp::mask_bias2;

// s = the masked, scaled scores in log2 units (scale2 = scale * log2(e)) of
// query rows r0 + g and r0 + g + 8 of the staged rows sa against the 4 n8
// tiles of key columns c0 .. c0 + 31 of sb (global column j0 = the tile's
// first key + c0, whose bias is colbias[0]); columns past L are -inf.
template <typename T>
__device__ __forceinline__ void half_scores(float (&s)[4][4], const T* sa,
                                            const T* sb,
                                            const float* colbias, int r0,
                                            int c0, int j0, int lane,
                                            const int (&lim)[2],
                                            float scale2) {
  vlp::mma_abt<4>(s, sa, sb, r0, c0, kTile, lane);
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float2 cb = *reinterpret_cast<const float2*>(colbias + n * 8 + t2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = fmaf(s[n][e], scale2,
                     mask_bias2(e & 1 ? cb.y : cb.x,
                                j0 + n * 8 + t2 + (e & 1), lim[e >> 1]));
  }
}

// The multiplier of bit `bit` of a 32-bit half of a keep word.
__device__ __forceinline__ float keep_bit(uint32_t word, int bit,
                                          float scale) {
  return (word >> bit) & 1u ? scale : 0.f;
}

// Stage rows [0, min(n, L - r)) of the n rows at row r of a head's [L][64]
// slice (src, row stride sl) into dst[n][kTS], zeros past L.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long sl, int r, int n, int L,
                                           int align) {
  vlp::stage_rows(dst, src + r * sl, sl, max(0, min(n, L - r)), n, align);
}

// n keep words (n * 8 bytes, 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage_bits(u64* dst, const u64* src, int n) {
  for (int c = threadIdx.x; c < n / 2; c += blockDim.x)
    vlp::cp_async<16>(dst + 2 * c, src + 2 * c);
}

// The shared set-up of the statistics and dQ kernels: block (example b,
// head h, rows q0 .. q0 + 127) stages its Q and dO rows and the column
// bias.
template <typename T>
struct RowsBlock {
  int b, h, q0, nk, Lt, first, md, te;
  long long in_base, do_base;
  T *sq, *sdo, *ring;
  u64* sbits;        // [2][128]
  float* colbias;
  float* stats;      // this head's scratch
  u64* bits;

  __device__ RowsBlock(unsigned char* smem, const T* q, const T* dout,
                       const float* colkeep, float* scratch,
                       const int* mode, const int* text_end, int L, int H,
                       vlp::Strides in, vlp::Strides ds_in, int align) {
    const int nb = own_blocks(L);
    nk = long_tiles(L);
    Lt = nb * kOwn;
    const int bh = blockIdx.x / nb;
    b = bh / H;
    h = bh % H;
    q0 = (blockIdx.x % nb) * kOwn;
    in_base = b * in.b + h * in.h;
    do_base = b * ds_in.b + h * ds_in.h;
    stats = scratch + (long long)bh * long_scratch(L);
    bits = reinterpret_cast<u64*>(stats + 3 * Lt);
    sq = reinterpret_cast<T*>(smem);
    sdo = sq + kOwnElems;
    ring = sdo + kOwnElems;
    sbits = reinterpret_cast<u64*>(ring + 4 * kTileElems);
    colbias = reinterpret_cast<float*>(sbits + 2 * kOwn);
    stage_tile(sq, q + in_base, in.l, q0, kOwn, L, align);
    stage_tile(sdo, dout + do_base, ds_in.l, q0, kOwn, L, align);
    vlp::cp_async_commit();
    const float* ck = colkeep + (long long)b * L;
    for (int j = threadIdx.x; j < nk * kTile; j += blockDim.x)
      colbias[j] = colbias2(ck, j, L);
    first = first_kept(ck, L);
    md = mode[b];
    te = text_end[b];
  }
  // key tile kt of K and V (and, with bits, the keep words of this block's
  // rows against kt) into ring stage kt % 2
  __device__ void stage_kv(const T* k, const T* v, vlp::Strides in,
                           int kt, int L, int align, bool with_bits) {
    T* dst = ring + (kt & 1) * 2 * kTileElems;
    stage_tile(dst, k + in_base, in.l, kt * kTile, kTile, L, align);
    stage_tile(dst + kTileElems, v + in_base, in.l, kt * kTile, kTile, L,
               align);
    if (with_bits)
      stage_bits(sbits + (kt & 1) * kOwn, bits + (long long)kt * Lt + q0,
                 kOwn);
    vlp::cp_async_commit();
  }
};

// (a) Grid (example, head, 128 query rows): each warp owns 16 rows and
// streams every key tile: the row max m, the sum l of exp(S - m) and
// rowsum(dP o keep o exp(S - m)), both rescaled by exp(m_old - m_new) when
// the running max moves.  Writes m, 1/l and rowsum(dP o keep o P) = that
// sum / l (0, 0, 0 for rows past L), and with dropout the keep bits of
// every 16 x 64 region it does not skip, drawn once here for all three
// kernels (the other two read bits only inside such regions).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreadsT, kMinBlocksT)
    attention_bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        float* __restrict__ scratch,
                        const int* __restrict__ mode,
                        const int* __restrict__ text_end,
                        const float* __restrict__ colkeep, int L, int H,
                        vlp::Strides in, vlp::Strides ds_in, int prefix,
                        float scale, vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsBlock<T> blk(smem_raw, q, dout, colkeep, scratch, mode, text_end, L,
                   H, in, ds_in, align);
  const int nk = blk.nk, b = blk.b, h = blk.h, Lt = blk.Lt;
  auto issue = [&](int i) { blk.stage_kv(k, v, in, i, L, align, false); };
  issue(0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16, row = blk.q0 + r0 + g;
  const bool live = blk.q0 + r0 < L;   // the same for the whole warp
  const int lim[2] = {vlp::row_limit(blk.md, blk.te, prefix, row),
                      vlp::row_limit(blk.md, blk.te, prefix, row + 8)};
  const float scale2 = scale * kLog2e;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
        num[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    ring_next(kt, nk, issue);
    const T* sk = blk.ring + (kt & 1) * 2 * kTileElems;
    const T* sv = sk + kTileElems;
    if (live && !masked_region(blk.md, blk.te, prefix, blk.first,
                               blk.q0 + r0, blk.q0 + r0 + 16, kt * kTile)) {
      uint32_t kw[2][2] = {};   // [row g, g + 8][key half]
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += kHalf) {
        const int j0 = kt * kTile + c0;
        if (j0 >= L) break;   // key 0 < L: the first half sets a finite max
        float s[4][4], dpk[4][4];
        half_scores(s, blk.sq, sk, blk.colbias + j0, r0, c0, j0, lane, lim,
                    scale2);
        vlp::mma_abt<4>(dpk, blk.sdo, sv, r0, c0, kTile, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float cm = -CUDART_INF_F;
#pragma unroll
          for (auto& tile : s)
            cm = fmaxf(cm, fmaxf(tile[2 * hh], tile[2 * hh + 1]));
          const float mn = fmaxf(m[hh], quad_max(cm));
          const float alpha = ex2(m[hh] - mn);
          m[hh] = mn;
          l[hh] *= alpha;
          num[hh] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float mult[4] = {1.f, 1.f, 1.f, 1.f};
          if (kDrop && j0 + n * 8 < L) {
            vlp::keep_frag(dp, b, h, row, j0 + n * 8, lane, mult);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              kw[e >> 1][c0 / kHalf] |= uint32_t(mult[e] != 0.f)
                                        << (n * 8 + 2 * t + (e & 1));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(s[n][e] - m[e >> 1]);
            l[e >> 1] += p;
            num[e >> 1] += dpk[n][e] * mult[e] * p;
          }
        }
      }
      if (kDrop) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          u64 w = kw[hh][0] | (u64)kw[hh][1] << 32;
          w |= __shfl_xor_sync(0xffffffffu, w, 1);
          w |= __shfl_xor_sync(0xffffffffu, w, 2);
          if (t == 0) blk.bits[(long long)kt * Lt + row + 8 * hh] = w;
        }
      }
    }
    __syncthreads();   // the next stage overwrites this one's K and V
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = quad_sum(l[hh]), nm = quad_sum(num[hh]);
    const int i = row + 8 * hh;
    if (t == 0) {
      const bool in = i < L;
      blk.stats[i] = in ? m[hh] : 0.f;
      blk.stats[Lt + i] = in ? 1.f / lt : 0.f;
      blk.stats[2 * Lt + i] = in ? nm / lt : 0.f;
    }
  }
}

// (b) Grid (example, head, 128 keys): K and V of the keys stay staged;
// each warp owns 16 of them and streams every query tile of Q, dO, their
// statistics and keep bits.  Per 16 queries it recomputes S^T and
// P^T = exp(S^T - m) / l, forms dP^T = V dO^T and dS^T, rounds P o keep
// and dS to T as attention_bwd_mma does, and adds
// dV += (P o keep)^T dO and dK += dS^T Q in registers, the transposed
// products straight from the accumulators (C fragments = A fragments).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreadsT, kMinBlocksT)
    attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const T* __restrict__ dout, T* __restrict__ dk,
                       T* __restrict__ dv,
                       const float* __restrict__ scratch,
                       const int* __restrict__ mode,
                       const int* __restrict__ text_end,
                       const float* __restrict__ colkeep, int L, int H,
                       vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                       int prefix, float scale, vlp::DropoutArg dp_arg,
                       int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = own_blocks(L), nq = long_tiles(L), Lt = nb * kOwn;
  const int bh = blockIdx.x / nb, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % nb) * kOwn;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  const float* st = scratch + (long long)bh * long_scratch(L);
  const u64* bits = reinterpret_cast<const u64*>(st + 3 * Lt);
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kOwnElems;
  T* ring = sv + kOwnElems;        // [2][Q, dO]
  float* sstat = reinterpret_cast<float*>(ring + 4 * kTileElems);  // [2][3][64]
  u64* sbits = reinterpret_cast<u64*>(sstat + 2 * 3 * kTile);  // [2][2][64]
  stage_tile(sk, k + in_base, in.l, k0, kOwn, L, align);
  stage_tile(sv, v + in_base, in.l, k0, kOwn, L, align);
  vlp::cp_async_commit();
  // the block's keys span 64-key tiles kt0 and kt0 + 1 (if < nq)
  const int kt0 = k0 / kTile;
  auto stage_q = [&](int qt) {
    T* dst = ring + (qt & 1) * 2 * kTileElems;
    stage_tile(dst, q + in_base, in.l, qt * kTile, kTile, L, align);
    stage_tile(dst + kTileElems, dout + do_base, ds_in.l, qt * kTile, kTile,
               L, align);
    // m, 1/l and rowsum of the tile's rows: 3 x 16 copies of 16 bytes
    for (int c = threadIdx.x; c < 3 * kTile / 4; c += blockDim.x)
      vlp::cp_async<16>(sstat + (qt & 1) * 3 * kTile + 4 * c,
                        st + (c / 16) * Lt + qt * kTile + (c % 16) * 4);
    if (kDrop)
      for (int x = 0; x < 2 && kt0 + x < nq; ++x)
        stage_bits(sbits + ((qt & 1) * 2 + x) * kTile,
                   bits + (long long)(kt0 + x) * Lt + qt * kTile, kTile);
    vlp::cp_async_commit();
  };
  stage_q(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = warp * 16;
  const bool live = k0 + kr0 < L;   // the same for the whole warp
  const int md = mode[b], te = text_end[b];
  const float* ck = colkeep + (long long)b * L;
  const int first = first_kept(ck, L);
  int key[2];
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + kr0 + g + 8 * hh;
    kbias[hh] = colbias2(ck, key[hh], L);
  }
  const float scale2 = scale * kLog2e;
  // this lane's keys are bits kbit and kbit + 8 of one 32-bit half of a
  // keep word of key tile kt0 + kr0 / 64
  const int kbit = (kr0 & 31) + g;
  float ka[8][4] = {}, va[8][4] = {};
  for (int qt = 0; qt < nq; ++qt) {
    ring_next(qt, nq, stage_q);
    const T* sq = ring + (qt & 1) * 2 * kTileElems;
    const T* sdo = sq + kTileElems;
    const float* sm = sstat + (qt & 1) * 3 * kTile;
    const uint32_t* sb =
        reinterpret_cast<const uint32_t*>(
            sbits + ((qt & 1) * 2 + kr0 / kTile) * kTile) +
        ((kr0 & (kTile - 1)) >> 5);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      const int i0 = qt * kTile + c0;
      if (!live || i0 >= L ||
          masked_region(md, te, prefix, first, i0, i0 + kStep, k0 + kr0))
        continue;
      float s[2][4], dpt[2][4];
      vlp::mma_abt<2>(s, sk, sq, kr0, c0, kTile, lane);     // S^T
      vlp::mma_abt<2>(dpt, sv, sdo, kr0, c0, kTile, lane);  // dP^T
      uint32_t fp[4], fs[4];   // P o keep and dS, as A fragments
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = c0 + n * 8 + 2 * t, i = qt * kTile + c;
        const int lim[2] = {vlp::row_limit(md, te, prefix, i),
                            vlp::row_limit(md, te, prefix, i + 1)};
        const float2 mx = *reinterpret_cast<const float2*>(sm + c);
        const float2 inv = *reinterpret_cast<const float2*>(sm + kTile + c);
        const float2 rs = *reinterpret_cast<const float2*>(sm + 2 * kTile + c);
        uint32_t kw[2] = {0, 0};
        if (kDrop) {
          kw[0] = sb[2 * c];
          kw[1] = sb[2 * c + 2];
        }
        float pk[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, qq = e & 1;
          const float mult =
              kDrop ? keep_bit(kw[qq], kbit + 8 * hh, dp.scale) : 1.f;
          const float x = fmaf(s[n][e], scale2,
                               mask_bias2(kbias[hh], key[hh], lim[qq]));
          const float p = ex2(x - (qq ? mx.y : mx.x)) * (qq ? inv.y : inv.x);
          pk[e] = p * mult;
          ds[e] = p * (dpt[n][e] * mult - (qq ? rs.y : rs.x));
        }
        fp[n * 2] = vlp::pack16<T>(pk[0], pk[1]);
        fp[n * 2 + 1] = vlp::pack16<T>(pk[2], pk[3]);
        fs[n * 2] = vlp::pack16<T>(ds[0], ds[1]);
        fs[n * 2 + 1] = vlp::pack16<T>(ds[2], ds[3]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (c0 + (lane & 15)) * kTS + np * 16 + (lane >> 4) * 8;
        uint32_t fb[4];
        vlp::ldsm_x4_t(fb, sdo + off);
        vlp::mma16<T>(va[2 * np], fp, fb[0], fb[1]);
        vlp::mma16<T>(va[2 * np + 1], fp, fb[2], fb[3]);
        vlp::ldsm_x4_t(fb, sq + off);
        vlp::mma16<T>(ka[2 * np], fs, fb[0], fb[1]);
        vlp::mma16<T>(ka[2 * np + 1], fs, fb[2], fb[3]);
      }
    }
    __syncthreads();   // the next stage overwrites this one's Q and dO
  }
  const long long out_base = b * os.b + h * os.h + k0 * os.l;
  vlp::store_rows(dk + out_base, os.l, ka, kr0, L - k0, lane, scale);
  vlp::store_rows(dv + out_base, os.l, va, kr0, L - k0, lane, 1.f);
}

// (c) Grid (example, head, 128 query rows): each warp owns 16 rows and
// streams every key tile (and the keep words of the block's rows): S, P
// from (m, 1/l), keep, dP and dS as in (b), and dQ += dS K in registers;
// dQ is written once.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreadsT, kMinBlocksT)
    attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float* __restrict__ scratch,
                     const int* __restrict__ mode,
                     const int* __restrict__ text_end,
                     const float* __restrict__ colkeep, int L, int H,
                     vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                     int prefix, float scale, vlp::DropoutArg dp_arg,
                     int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsBlock<T> blk(smem_raw, q, dout, colkeep, scratch, mode, text_end, L,
                   H, in, ds_in, align);
  const int nk = blk.nk, Lt = blk.Lt;
  auto issue = [&](int i) { blk.stage_kv(k, v, in, i, L, align, kDrop); };
  issue(0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16, row = blk.q0 + r0 + g;
  const bool live = blk.q0 + r0 < L;   // the same for the whole warp
  const int lim[2] = {vlp::row_limit(blk.md, blk.te, prefix, row),
                      vlp::row_limit(blk.md, blk.te, prefix, row + 8)};
  const float* st = blk.stats;
  const float m[2] = {st[row], st[row + 8]};
  const float inv[2] = {st[Lt + row], st[Lt + row + 8]};
  const float rs[2] = {st[2 * Lt + row], st[2 * Lt + row + 8]};
  const float scale2 = scale * kLog2e;
  float qa[8][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    ring_next(kt, nk, issue);
    const T* sk = blk.ring + (kt & 1) * 2 * kTileElems;
    const T* sv = sk + kTileElems;
    const uint32_t* sb =
        reinterpret_cast<const uint32_t*>(blk.sbits + (kt & 1) * kOwn);
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kHalf) {
      const int j0 = kt * kTile + c0;
      if (!live || j0 >= L ||
          masked_region(blk.md, blk.te, prefix, blk.first, blk.q0 + r0,
                        blk.q0 + r0 + 16, j0))
        continue;
      float s[4][4], dpk[4][4];
      half_scores(s, blk.sq, sk, blk.colbias + j0, r0, c0, j0, lane, lim,
                  scale2);
      vlp::mma_abt<4>(dpk, blk.sdo, sv, r0, c0, kTile, lane);
      // rows g, g + 8: the keep bits of this half's columns from 2t on
      uint32_t kw[2] = {0, 0};
      if (kDrop) {
        kw[0] = sb[2 * (r0 + g) + c0 / kHalf] >> (2 * t);
        kw[1] = sb[2 * (r0 + g + 8) + c0 / kHalf] >> (2 * t);
      }
      uint32_t fa[2][4];   // dS, as the A fragments of two k-steps
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mult =
              kDrop ? keep_bit(kw[e >> 1], n * 8 + (e & 1), dp.scale) : 1.f;
          const float p = ex2(s[n][e] - m[e >> 1]) * inv[e >> 1];
          ds[e] = p * (dpk[n][e] * mult - rs[e >> 1]);
        }
        fa[n >> 1][(n & 1) * 2] = vlp::pack16<T>(ds[0], ds[1]);
        fa[n >> 1][(n & 1) * 2 + 1] = vlp::pack16<T>(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t fb[4];
          vlp::ldsm_x4_t(fb, sk + (c0 + 16 * kk + (lane & 15)) * kTS +
                                 np * 16 + (lane >> 4) * 8);
          vlp::mma16<T>(qa[2 * np], fa[kk], fb[0], fb[1]);
          vlp::mma16<T>(qa[2 * np + 1], fa[kk], fb[2], fb[3]);
        }
    }
    __syncthreads();   // the next stage overwrites this one's K and V
  }
  const long long out_base = blk.b * os.b + blk.h * os.h + blk.q0 * os.l;
  vlp::store_rows(dq + out_base, os.l, qa, r0, L - blk.q0, lane, scale);
}

// ---- fp32: FlashAttention-2's backward in split TF32 on the tensor cores,
// every L the bf16 bodies take, in two kernels over (example, head, 64
// rows) blocks of 4 warps that stream the other operand in 32-row tiles

constexpr int kOwnF = 64;                  // rows (keys) a block owns
constexpr int kWarpsF = kOwnF / 16;        // one warp per 16 of them
constexpr int kTileF = 32;                 // rows of a streamed tile
constexpr int kFS = vlp::kF32Stride;
constexpr int kOwnElemsF = kOwnF * kFS;    // floats of one staged own tile
constexpr int kTileElemsF = kTileF * kFS;  // and of one streamed tile

__host__ __device__ __forceinline__ int own_blocks_f32(int L) {
  return (L + kOwnF - 1) / kOwnF;
}
__host__ __device__ __forceinline__ int tiles_f32(int L) {
  return (L + kTileF - 1) / kTileF;
}
// The scratch of one (example, head), in floats: the row max m, 1/l and
// rowsum(dP o keep o P) of each of the Lt = 64 * own_blocks_f32(L) query
// rows ([3][Lt] fp32; 0, 0, 0 past L), then the keep bits ([32-key
// tile][Lt] u32: bit c of word (kt, i) keeps column 32 kt + c of row i).
__host__ __device__ __forceinline__ int scratch_f32(int L) {
  return (3 + tiles_f32(L)) * own_blocks_f32(L) * kOwnF;
}

// The rows kernel: its 64 rows of Q and dO, a ring of two stages of one key
// tile of K and V, the column bias of every key and the keep words of its
// rows against every key tile.
size_t smem_bytes_rows_f32(int L) {
  return sizeof(float) * (2 * kOwnElemsF + 4 * kTileElemsF +
                          size_t(tiles_f32(L)) * kTileF) +
         sizeof(uint32_t) * size_t(tiles_f32(L)) * kOwnF;
}
// The dK/dV kernel: its 64 keys of K and V, and a ring of two stages of
// one query tile of Q, dO, their rows' statistics and the keep words of
// the block's two key tiles.
constexpr size_t kSmemBytesColsF =
    sizeof(float) * (2 * kOwnElemsF + 4 * kTileElemsF + 2 * 3 * kTileF) +
    sizeof(uint32_t) * 2 * 2 * kTileF;

// s = the masked, scaled scores (natural units, as attention_plain adds
// them) of rows g, g + 8 of a 16 x 32 accumulator whose column 8n + 2t
// (+1) is key j0 + 8n + 2t (+1); colbias starts at key j0.
__device__ __forceinline__ void mask_scores_f32(float (&s)[4][4],
                                                const float* colbias, int j0,
                                                int lane, const int (&lim)[2],
                                                float scale) {
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + t2 + (e & 1);
      s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale),
                          vlp::mask_bias(colbias[c], j0 + c, lim[e >> 1]));
    }
}

// (a) Grid (example, head, 64 query rows), Q and dO of the rows staged;
// each warp owns 16 rows and streams every 32-key tile of K and V twice,
// through one ring.  Pass 1: S and dP = dO V^T, the row max m, the sum l
// of exp(S - m) and rowsum(dP o keep o exp(S - m)), both rescaled by
// exp(m_old - m_new) when the running max moves; with dropout, the keep
// bits of every 16 x 32 region it does not skip (Philox runs once, here),
// kept in shared memory and written out.  It writes m, 1/l and
// rowsum(dP o keep o P) = that sum / l (0, 0, 0 for rows past L) for (b).
// Pass 2: S, P from (m, 1/l), keep from the bits, dP and dS, and
// dQ += dS K in registers; dQ is written once.
template <bool kDrop>
__global__ void __launch_bounds__(kWarpsF * 32, 3)
    attention_bwd_rows_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           float* __restrict__ dq, float* __restrict__ scratch,
                           const int* __restrict__ mode,
                           const int* __restrict__ text_end,
                           const float* __restrict__ colkeep, int L, int H,
                           vlp::Strides in, vlp::Strides ds_in,
                           vlp::Strides os, int prefix, float scale,
                           vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) float smem_f[];
  const int nb = own_blocks_f32(L), nk = tiles_f32(L), Lt = nb * kOwnF;
  const int bh = blockIdx.x / nb, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % nb) * kOwnF;
  const long long in_base = b * in.b + h * in.h;
  float* stats = scratch + (long long)bh * scratch_f32(L);
  uint32_t* bits = reinterpret_cast<uint32_t*>(stats + 3 * Lt);
  float* sq = smem_f;
  float* sdo = sq + kOwnElemsF;
  float* ring = sdo + kOwnElemsF;             // [2][K, V][32][kF32Stride]
  float* colbias = ring + 4 * kTileElemsF;    // [nk * 32]
  uint32_t* sbits =
      reinterpret_cast<uint32_t*>(colbias + nk * kTileF);   // [nk][64]
  vlp::stage_rows_f32(sq, q + in_base + q0 * in.l, in.l, L - q0, kOwnF,
                      align);
  vlp::stage_rows_f32(sdo, dout + b * ds_in.b + h * ds_in.h + q0 * ds_in.l,
                      ds_in.l, L - q0, kOwnF, align);
  vlp::cp_async_commit();
  // step it < 2 nk stages key tile it % nk into ring stage it % 2
  auto issue = [&](int it) {
    float* dst = ring + (it & 1) * 2 * kTileElemsF;
    const int j0 = (it % nk) * kTileF;
    vlp::stage_rows_f32(dst, k + in_base + j0 * in.l, in.l, L - j0, kTileF,
                        align);
    vlp::stage_rows_f32(dst + kTileElemsF, v + in_base + j0 * in.l, in.l,
                        L - j0, kTileF, align);
    vlp::cp_async_commit();
  };
  issue(0);
  const float* ck = colkeep + (long long)b * L;
  for (int j = threadIdx.x; j < nk * kTileF; j += blockDim.x)
    colbias[j] = j >= L ? -CUDART_INF_F : ck[j] > 0.5f ? 0.f : vlp::kNegInf;
  const int first = vlp::first_kept(ck, L);
  const int md = mode[b], te = text_end[b];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16, row = q0 + r0 + g;
  const bool live = q0 + r0 < L;   // the same for the whole warp
  const int lim[2] = {vlp::row_limit(md, te, prefix, row),
                      vlp::row_limit(md, te, prefix, row + 8)};
  // whether the warp computes key tile kt (the same in both passes)
  auto visible = [&](int kt) {
    return live && !vlp::masked_region(md, te, prefix, first, q0 + r0,
                                       q0 + r0 + 16, kt * kTileF);
  };

  // ---- pass 1: the statistics and the keep bits
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
        num[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    vlp::ring_next(kt, 2 * nk, issue);
    const float* sk = ring + (kt & 1) * 2 * kTileElemsF;
    const float* sv = sk + kTileElemsF;
    const int j0 = kt * kTileF;
    if (visible(kt)) {
      float s[4][4], dpk[4][4];
      vlp::mma_abt_f32<4>(s, sq, sk, r0, 0, lane);
      vlp::mma_abt_f32<4>(dpk, sdo, sv, r0, 0, lane);
      mask_scores_f32(s, colbias + j0, j0, lane, lim, scale);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float cm = -CUDART_INF_F;
#pragma unroll
        for (auto& tile : s)
          cm = fmaxf(cm, fmaxf(tile[2 * hh], tile[2 * hh + 1]));
        const float mn = fmaxf(m[hh], vlp::quad_max(cm));
        const float alpha = __expf(m[hh] - mn);
        m[hh] = mn;
        l[hh] *= alpha;
        num[hh] *= alpha;
      }
      uint32_t kw[2] = {0u, 0u};   // rows g, g + 8
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float mult[4] = {1.f, 1.f, 1.f, 1.f};
        if (kDrop && j0 + 8 * n < L) {
          vlp::keep_frag(dp, b, h, row, j0 + 8 * n, lane, mult);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kw[e >> 1] |= uint32_t(mult[e] != 0.f)
                          << (8 * n + 2 * t + (e & 1));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          num[e >> 1] += dpk[n][e] * mult[e] * p;
        }
      }
      if (kDrop) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t w = kw[hh];
          w |= __shfl_xor_sync(0xffffffffu, w, 1);
          w |= __shfl_xor_sync(0xffffffffu, w, 2);
          if (t == 0) {
            sbits[kt * kOwnF + r0 + g + 8 * hh] = w;
            bits[(long long)kt * Lt + row + 8 * hh] = w;
          }
        }
      }
    }
    __syncthreads();   // the next stage overwrites this one's K and V
  }
  float inv[2], rs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = vlp::quad_sum(l[hh]), nm = vlp::quad_sum(num[hh]);
    const bool in = row + 8 * hh < L;
    inv[hh] = in ? 1.f / lt : 0.f;
    rs[hh] = in ? nm / lt : 0.f;
    if (!in) m[hh] = 0.f;
    if (t == 0) {
      stats[row + 8 * hh] = m[hh];
      stats[Lt + row + 8 * hh] = inv[hh];
      stats[2 * Lt + row + 8 * hh] = rs[hh];
    }
  }

  // ---- pass 2: dQ
  float qa[D / 8][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    vlp::ring_next(nk + kt, 2 * nk, issue);
    const float* sk = ring + ((nk + kt) & 1) * 2 * kTileElemsF;
    const float* sv = sk + kTileElemsF;
    const int j0 = kt * kTileF;
    if (visible(kt)) {
      float s[4][4], dpk[4][4];
      vlp::mma_abt_f32<4>(s, sq, sk, r0, 0, lane);
      vlp::mma_abt_f32<4>(dpk, sdo, sv, r0, 0, lane);
      mask_scores_f32(s, colbias + j0, j0, lane, lim, scale);
      // rows g, g + 8: the keep bits of the tile's columns from 2t on
      uint32_t kw[2] = {0u, 0u};
      if (kDrop) {
        kw[0] = sbits[kt * kOwnF + r0 + g] >> (2 * t);
        kw[1] = sbits[kt * kOwnF + r0 + g + 8] >> (2 * t);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mult =
              kDrop ? ((kw[e >> 1] >> (8 * n + (e & 1))) & 1u ? dp.scale : 0.f)
                    : 1.f;
          const float p = __expf(s[n][e] - m[e >> 1]) * inv[e >> 1];
          ds[e] = p * (dpk[n][e] * mult - rs[e >> 1]);
        }
        vlp::mma_at_f32(qa, vlp::frag_from_acc(ds), sk, 8 * n, lane);
      }
    }
    __syncthreads();   // the next stage overwrites this one's K and V
  }
  vlp::store_rows_f32(dq + b * os.b + h * os.h + q0 * os.l, os.l, qa, r0,
                      L - q0, lane, scale);
}

// (b) Grid (example, head, 64 keys): K and V of the keys stay staged; each
// warp owns 16 of them and streams every 32-query tile of Q, dO, their
// statistics and keep bits.  Per query tile it recomputes S^T and
// P^T = exp(S^T - m) / l, forms dP^T = V dO^T and dS^T, and adds
// dV += (P o keep)^T dO and dK += dS^T Q in registers, the transposed
// products straight from the accumulators (mma.cuh's k permutation).
// A tile (32 queries) that (a) skipped for one of its 16-row halves has
// no keep bits there, but P is exactly 0 there, so the multiplier does
// not matter.
template <bool kDrop>
__global__ void __launch_bounds__(kWarpsF * 32, 3)
    attention_bwd_dkdv_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           float* __restrict__ dk, float* __restrict__ dv,
                           const float* __restrict__ scratch,
                           const int* __restrict__ mode,
                           const int* __restrict__ text_end,
                           const float* __restrict__ colkeep, int L, int H,
                           vlp::Strides in, vlp::Strides ds_in,
                           vlp::Strides os, int prefix, float scale,
                           vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) float smem_f[];
  const int nb = own_blocks_f32(L), nq = tiles_f32(L), Lt = nb * kOwnF;
  const int bh = blockIdx.x / nb, b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % nb) * kOwnF;
  const long long in_base = b * in.b + h * in.h;
  const long long do_base = b * ds_in.b + h * ds_in.h;
  const float* st = scratch + (long long)bh * scratch_f32(L);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(st + 3 * Lt);
  float* sk = smem_f;
  float* sv = sk + kOwnElemsF;
  float* ring = sv + kOwnElemsF;               // [2][Q, dO]
  float* sstat = ring + 4 * kTileElemsF;       // [2][3][32]
  uint32_t* sbits =
      reinterpret_cast<uint32_t*>(sstat + 2 * 3 * kTileF);   // [2][2][32]
  vlp::stage_rows_f32(sk, k + in_base + k0 * in.l, in.l, L - k0, kOwnF, align);
  vlp::stage_rows_f32(sv, v + in_base + k0 * in.l, in.l, L - k0, kOwnF, align);
  vlp::cp_async_commit();
  // the block's keys span 32-key tiles kt0 and kt0 + 1 (if < nq)
  const int kt0 = k0 / kTileF;
  auto stage_q = [&](int qt) {
    float* dst = ring + (qt & 1) * 2 * kTileElemsF;
    vlp::stage_rows_f32(dst, q + in_base + (long long)qt * kTileF * in.l,
                        in.l, L - qt * kTileF, kTileF, align);
    vlp::stage_rows_f32(dst + kTileElemsF,
                        dout + do_base + (long long)qt * kTileF * ds_in.l,
                        ds_in.l, L - qt * kTileF, kTileF, align);
    // m, 1/l and rowsum of the tile's rows: 3 x 8 copies of 16 bytes
    for (int c = threadIdx.x; c < 3 * kTileF / 4; c += blockDim.x)
      vlp::cp_async<16>(sstat + (qt & 1) * 3 * kTileF + 4 * c,
                        st + (c / 8) * Lt + qt * kTileF + (c % 8) * 4);
    if (kDrop)
      for (int c = threadIdx.x; c < 2 * kTileF / 4; c += blockDim.x) {
        const int x = c / (kTileF / 4);
        if (kt0 + x < nq)
          vlp::cp_async<16>(sbits + ((qt & 1) * 2 + x) * kTileF +
                                4 * (c % (kTileF / 4)),
                            bits + (long long)(kt0 + x) * Lt + qt * kTileF +
                                4 * (c % (kTileF / 4)));
      }
    vlp::cp_async_commit();
  };
  stage_q(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = warp * 16;
  const bool live = k0 + kr0 < L;   // the same for the whole warp
  const int md = mode[b], te = text_end[b];
  const float* ck = colkeep + (long long)b * L;
  const int first = vlp::first_kept(ck, L);
  int key[2];
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + kr0 + g + 8 * hh;
    kbias[hh] = key[hh] >= L ? -CUDART_INF_F
                : ck[key[hh]] > 0.5f ? 0.f : vlp::kNegInf;
  }
  // this lane's keys are bits kbit and kbit + 8 of word kr0 / 32 of the
  // block's two key tiles
  const int kbit = (kr0 & 31) + g;
  float ka[D / 8][4] = {}, va[D / 8][4] = {};
  for (int qt = 0; qt < nq; ++qt) {
    vlp::ring_next(qt, nq, stage_q);
    const float* sq = ring + (qt & 1) * 2 * kTileElemsF;
    const float* sdo = sq + kTileElemsF;
    const float* sm = sstat + (qt & 1) * 3 * kTileF;
    const uint32_t* sb = sbits + ((qt & 1) * 2 + kr0 / kTileF) * kTileF;
    const int i0 = qt * kTileF;
    if (live && !vlp::masked_region(md, te, prefix, first, i0, i0 + kTileF,
                                    k0 + kr0)) {
      float s[4][4], dpt[4][4];
      vlp::mma_abt_f32<4>(s, sk, sq, kr0, 0, lane);     // S^T
      vlp::mma_abt_f32<4>(dpt, sv, sdo, kr0, 0, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 8 * n + 2 * t, i = i0 + c;
        const int lim[2] = {vlp::row_limit(md, te, prefix, i),
                            vlp::row_limit(md, te, prefix, i + 1)};
        float pk[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, qq = e & 1;
          const float mult =
              kDrop ? ((sb[c + qq] >> (kbit + 8 * hh)) & 1u ? dp.scale : 0.f)
                    : 1.f;
          const float x =
              __fadd_rn(__fmul_rn(s[n][e], scale),
                        vlp::mask_bias(kbias[hh], key[hh], lim[qq]));
          const float p = __expf(x - sm[c + qq]) * sm[kTileF + c + qq];
          pk[e] = p * mult;
          ds[e] = p * (dpt[n][e] * mult - sm[2 * kTileF + c + qq]);
        }
        vlp::mma_at_f32(va, vlp::frag_from_acc(pk), sdo, 8 * n, lane);
        vlp::mma_at_f32(ka, vlp::frag_from_acc(ds), sq, 8 * n, lane);
      }
    }
    __syncthreads();   // the next stage overwrites this one's Q and dO
  }
  const long long out_base = b * os.b + h * os.h + k0 * os.l;
  vlp::store_rows_f32(dk + out_base, os.l, ka, kr0, L - k0, lane, scale);
  vlp::store_rows_f32(dv + out_base, os.l, va, kr0, L - k0, lane, 1.f);
}

// The fp32 body, every L: two launches on one stream; the scratch
// (B * H * scratch_f32(L) floats) carries the row statistics and keep bits
// from the first to the second.
template <bool kDrop>
int launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* scratch, const int* mode,
                const int* text_end, const float* colkeep, int B, int L,
                int H, vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                int prefix, float scale, vlp::DropoutArg dp,
                cudaStream_t stream) {
  const size_t smem_rows = smem_bytes_rows_f32(L);
  if (smem_rows > (size_t)vlp::kMaxSmemBytes || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 4ull * in.b, 4ull * in.h, 4ull * in.l,
       4ull * ds_in.b, 4ull * ds_in.h, 4ull * ds_in.l});
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attention_bwd_rows_f32<kDrop>, attr,
                                  (int)smem_rows)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_bwd_dkdv_f32<kDrop>, attr,
                                  (int)kSmemBytesColsF)) != cudaSuccess)
    return (int)err;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* dof = static_cast<const float*>(dout);
  const int blocks = B * H * own_blocks_f32(L);
  attention_bwd_rows_f32<kDrop><<<blocks, kWarpsF * 32, smem_rows, stream>>>(
      qf, kf, vf, dof, static_cast<float*>(dq), scratch, mode, text_end,
      colkeep, L, H, in, ds_in, os, prefix, scale, dp, align);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attention_bwd_dkdv_f32<kDrop>
      <<<blocks, kWarpsF * 32, kSmemBytesColsF, stream>>>(
          qf, kf, vf, dof, static_cast<float*>(dk), static_cast<float*>(dv),
          scratch, mode, text_end, colkeep, L, H, in, ds_in, os, prefix,
          scale, dp, align);
  return (int)cudaGetLastError();
}

template <typename T, int kNT, bool kDrop>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
               int prefix, float scale, vlp::DropoutArg dp,
               cudaStream_t stream) {
  const int Lp = (L + 15) & ~15;
  const size_t smem = smem_bytes_mma(Lp, kNT);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 2ull * in.b, 2ull * in.h, 2ull * in.l,
       2ull * ds_in.b, 2ull * ds_in.h, 2ull * ds_in.l});
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_mma<T, kNT, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_mma<T, kNT, kDrop><<<B * H, 4 * Lp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      mode, text_end, colkeep, L, H, in, in, ds_in, os, os, prefix, scale,
      dp, align);
  return (int)cudaGetLastError();
}

// MLA's (192, 128): bf16, rate 0, L <= 128, one block a head; q/k at
// strides `in`, v at `vin`, dO at `ds_in`, dq/dk at `os`, dv at `osv`.
int launch_mla(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides vin, vlp::Strides ds_in,
               vlp::Strides os, vlp::Strides osv, int prefix, float scale,
               cudaStream_t stream) {
  constexpr int kDQ = vlp::kMlaQkDim, kDV = vlp::kMlaVDim, kNT = 16;
  if (B <= 0 || L <= 0 || H <= 0 || L > 8 * kNT)
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 15) & ~15;
  const size_t smem = smem_bytes_mma<kDQ, kDV>(Lp, kNT);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 2ull * in.b, 2ull * in.h, 2ull * in.l,
       2ull * vin.b, 2ull * vin.h, 2ull * vin.l, 2ull * ds_in.b,
       2ull * ds_in.h, 2ull * ds_in.l});
  auto kernel = attention_bwd_mma<bf16, kNT, false, kDQ, kDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, 4 * Lp, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      mode, text_end, colkeep, L, H, in, vin, ds_in, os, osv, prefix, scale,
      vlp::DropoutArg{nullptr, 0, 1.f}, align);
  return (int)cudaGetLastError();
}

// The tiled body, for 8 * kMaxNT < L: three launches on one stream; the
// scratch (B * H * long_scratch(L) floats) carries the row statistics and
// keep bits from the first to the other two.
template <typename T, bool kDrop>
int launch_long(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* scratch, const int* mode,
                const int* text_end, const float* colkeep, int B, int L,
                int H, vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
                int prefix, float scale, vlp::DropoutArg dp,
                cudaStream_t stream) {
  const size_t smem_rows = smem_bytes_rows(L);
  if (smem_rows > (size_t)vlp::kMaxSmemBytes || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       (unsigned long long)dout, 2ull * in.b, 2ull * in.h, 2ull * in.l,
       2ull * ds_in.b, 2ull * ds_in.h, 2ull * ds_in.l});
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attention_bwd_stats<T, kDrop>, attr,
                                  (int)smem_rows)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_bwd_dkdv<T, kDrop>, attr,
                                  (int)kSmemBytesCols)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_bwd_dq<T, kDrop>, attr,
                                  (int)smem_rows)) != cudaSuccess)
    return (int)err;
  const auto* qb = static_cast<const T*>(q);
  const auto* kb = static_cast<const T*>(k);
  const auto* vb = static_cast<const T*>(v);
  const auto* dob = static_cast<const T*>(dout);
  const int blocks = B * H * own_blocks(L);
  attention_bwd_stats<T, kDrop><<<blocks, kThreadsT, smem_rows, stream>>>(
      qb, kb, vb, dob, scratch, mode, text_end, colkeep, L, H, in, ds_in,
      prefix, scale, dp, align);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attention_bwd_dkdv<T, kDrop><<<blocks, kThreadsT, kSmemBytesCols, stream>>>(
      qb, kb, vb, dob, static_cast<T*>(dk), static_cast<T*>(dv),
      scratch, mode, text_end, colkeep, L, H, in, ds_in, os, prefix, scale,
      dp, align);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attention_bwd_dq<T, kDrop><<<blocks, kThreadsT, smem_rows, stream>>>(
      qb, kb, vb, dob, static_cast<T*>(dq), scratch, mode, text_end,
      colkeep, L, H, in, ds_in, os, prefix, scale, dp, align);
  return (int)cudaGetLastError();
}

// fp32 scratch (floats per example and head) the body for L needs: the
// row statistics and keep bits of the tiled bodies (long_scratch in bf16
// and fp16, scratch_f32 in fp32).
int scratch_floats(int L, int dtype) {
  if (dtype == vlp::kFloat32) return scratch_f32(L);
  return L > 8 * kMaxNT ? long_scratch(L) : 0;
}

// 16-bit T: the whole problem in one block up to 8 * kMaxNT, 64 x 64 tiles
// beyond.
template <typename T, bool kDrop>
int launch_16(const void* q, const void* k, const void* v, const void* dout,
              void* dq, void* dk, void* dv, float* scratch, const int* mode,
              const int* text_end, const float* colkeep, int B, int L, int H,
              vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
              int prefix, float scale, vlp::DropoutArg dp,
              cudaStream_t stream) {
  if (L <= 128)
    return launch_mma<T, 16, kDrop>(q, k, v, dout, dq, dk, dv, mode, text_end,
                                    colkeep, B, L, H, in, ds_in, os, prefix,
                                    scale, dp, stream);
  if (L <= 8 * kMaxNT)
    return launch_mma<T, kMaxNT, kDrop>(q, k, v, dout, dq, dk, dv, mode,
                                        text_end, colkeep, B, L, H, in, ds_in,
                                        os, prefix, scale, dp, stream);
  return launch_long<T, kDrop>(q, k, v, dout, dq, dk, dv, scratch, mode,
                               text_end, colkeep, B, L, H, in, ds_in, os,
                               prefix, scale, dp, stream);
}

// bf16 and fp16: launch_16; fp32: the split-TF32 tiled body for every L.
template <bool kDrop>
int launch_any(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* scratch, const int* mode,
               const int* text_end, const float* colkeep, int B, int L, int H,
               vlp::Strides in, vlp::Strides ds_in, vlp::Strides os,
               int prefix, float scale, vlp::DropoutArg dp, int dtype,
               cudaStream_t stream) {
  switch (dtype) {
    case vlp::kBFloat16:
      return launch_16<bf16, kDrop>(q, k, v, dout, dq, dk, dv, scratch, mode,
                                    text_end, colkeep, B, L, H, in, ds_in, os,
                                    prefix, scale, dp, stream);
    case vlp::kFloat16:
      return launch_16<__half, kDrop>(q, k, v, dout, dq, dk, dv, scratch,
                                      mode, text_end, colkeep, B, L, H, in,
                                      ds_in, os, prefix, scale, dp, stream);
    case vlp::kFloat32:
      return launch_fp32<kDrop>(q, k, v, dout, dq, dk, dv, scratch, mode,
                                text_end, colkeep, B, L, H, in, ds_in, os,
                                prefix, scale, dp, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int backward(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, void* scratch, const void* mode,
             const void* text_end, const void* colkeep, int B, int L, int H,
             vlp::Strides in, vlp::Strides ds_in, vlp::Strides os, int prefix,
             float scale, vlp::DropoutArg dp, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || L > vlp::attention_fwd_max_len())
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto acc = static_cast<float*>(scratch);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  if (dp.threshold == 0)  // rate 0: every element kept with scale 1
    return launch_any<false>(q, k, v, dout, dq, dk, dv, acc, md, te, ck, B, L,
                             H, in, ds_in, os, prefix, scale, dp, dtype, s);
  return launch_any<true>(q, k, v, dout, dq, dk, dv, acc, md, te, ck, B, L, H,
                          in, ds_in, os, prefix, scale, dp, dtype, s);
}

}  // namespace

extern "C" {

// The largest L the backward takes, in every dtype: the forward's limit.
int vlp_attention_bwd_max_len() { return vlp::attention_fwd_max_len(); }

// The fp32 scratch, in floats per (example, head), that a backward at L
// needs in scratch (0: none; scratch may then be null).
int vlp_attention_bwd_scratch_floats(int L, int dtype) {
  return scratch_floats(L, dtype);
}

// q/k/v: [B, L, H*64] with element strides sb (batch) and sl (row); dout:
// [B, L, H*64] with strides dsb, dsl; the last dimension contiguous in
// all four.  dq/dk/dv: contiguous [B, L, H*64]; scratch: fp32 scratch of
// B * H * vlp_attention_bwd_scratch_floats(L, dtype) floats.
// seed/threshold/keep_scale are the forward's dropout, seed a pointer to
// its 64-bit seed in device memory (threshold 0 = no dropout; seed may then
// be null).  dtype (vlp::DType) selects the 16-bit tensor-core bodies in
// bf16 (1) or fp16 (2), or the fp32 body (0).  Returns cudaGetLastError()
// after the launch.
int vlp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, void* dq, void* dk, void* dv,
                      void* scratch, const void* mode, const void* text_end,
                      const void* colkeep, int B, int L, int H, long long sb,
                      long long sl, long long dsb, long long dsl, int prefix,
                      float scale, const void* seed,
                      unsigned int threshold, float keep_scale, int dtype,
                      void* stream) {
  const long long HD = (long long)H * D;
  return backward(q, k, v, dout, dq, dk, dv, scratch, mode, text_end, colkeep,
                  B, L, H, vlp::Strides{sb, D, sl}, vlp::Strides{dsb, D, dsl},
                  vlp::Strides{L * HD, D, HD}, prefix, scale,
                  vlp::dropout_arg(seed, threshold, keep_scale), dtype, stream);
}

// MLA (Kimi-VL's attention): q/k [B, L, H*192] with element strides sb,
// sl; v [B, L, H*128] with strides vsb, vsl; dout [B, L, H*128] with
// strides dsb, dsl; the last dimension contiguous in all four.  dq/dk:
// contiguous [B, L, H*192]; dv: contiguous [B, L, H*128].  bf16, no
// dropout, L <= 128; anything else returns cudaErrorInvalidValue.
int vlp_attention_bwd_mla(const void* q, const void* k, const void* v,
                          const void* dout, void* dq, void* dk, void* dv,
                          const void* mode, const void* text_end,
                          const void* colkeep, int B, int L, int H,
                          long long sb, long long sl, long long vsb,
                          long long vsl, long long dsb, long long dsl,
                          int prefix, float scale, void* stream) {
  constexpr long long DQ = vlp::kMlaQkDim, DV = vlp::kMlaVDim;
  return launch_mla(q, k, v, dout, dq, dk, dv, static_cast<const int*>(mode),
                    static_cast<const int*>(text_end),
                    static_cast<const float*>(colkeep), B, L, H,
                    vlp::Strides{sb, DQ, sl}, vlp::Strides{vsb, DV, vsl},
                    vlp::Strides{dsb, DV, dsl},
                    vlp::Strides{(long long)L * H * DQ, DQ, H * DQ},
                    vlp::Strides{(long long)L * H * DV, DV, H * DV}, prefix,
                    scale, static_cast<cudaStream_t>(stream));
}

// The bhld layout: q/k/v [B, H, L, 64] with element strides sb (batch), sh
// (head) and sl (row); dout [B, H, L, 64] with strides dsb, dsh, dsl; the
// last dimension contiguous in all four.  dq/dk/dv: contiguous
// [B, H, L, 64].  Otherwise as vlp_attention_bwd.
int vlp_attention_bwd_bhld(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* scratch, const void* mode,
                           const void* text_end, const void* colkeep, int B,
                           int L, int H, long long sb, long long sh,
                           long long sl, long long dsb, long long dsh,
                           long long dsl, int prefix, float scale,
                           const void* seed, unsigned int threshold,
                           float keep_scale, int dtype, void* stream) {
  const long long LD = (long long)L * D;
  return backward(q, k, v, dout, dq, dk, dv, scratch, mode, text_end, colkeep,
                  B, L, H, vlp::Strides{sb, sh, sl},
                  vlp::Strides{dsb, dsh, dsl}, vlp::Strides{H * LD, LD, D},
                  prefix, scale, vlp::dropout_arg(seed, threshold, keep_scale),
                  dtype, stream);
}

}  // extern "C"
