// Fused KV-cached decode-step attention (one generation step of one layer).
//
// Replaces the TPU kernel vlp_tpu/ops/decode_attention.py:_kernel (:104),
// all three branches: K3 (beam-local generated cache, greedy decode), K4
// (has_anc, :143-153: the ancestry bias of the fused beam reorder) and K5
// (drop_rate > 0, :159-200: attention-prob dropout in the SCST sampled
// rollout, K == 1).  K5 multiplies the softmax probabilities by the Philox
// keep/scale multipliers of common.cuh (counter (column/4, row, head,
// example) under one seed per decode step and layer, the column running
// over the joint (prompt | generated) axis) before the cast to the
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
//   3. one softmax over (prompt | generated), P cast to the activation
//      dtype, and the context in fp32.
//
// What bounds it on an H100: at beam-5 serving (B=100, K=5, S=2, P=102,
// G=24, H=12, D=64, bf16) one call reads the prompt K/V once per example
// (100*102*768 * 2 B * 2 = 31 MB), the visible generated K/V (at most
// gen_len + 2 = 20 slots of each of the five beams at the last step:
// 31 MB) and the ancestry bias, and writes ~0.6 MB: 9-21 us at 3.35 TB/s,
// against ~0.2 GFLOP.  At the SCST rollout (K5: B=64, K=1) the prompt K/V
// is 20 MB and the generated K/V at most 4 MB, ~7.5 us.  fp32 doubles the
// bytes (K4 137 MB at gen_len 18: 41 us) beside ~0.6 GFLOP (9 us of the
// CUDA cores' FMAs).  A memory- and latency-bound kernel: what counts is
// how many bytes are in flight per SM and how short the serial phases of a
// block are.
//
// Two bodies, chosen by dtype (never by a failure):
// * bf16, every main path: decode_attention_mma, on the tensor cores.  One
//   block per (example, head), one warp per 32 key columns while four warps
//   cover them (K3 and K5 at P=102, K4's early steps: 6 blocks share an
//   SM), 64 beyond (K4's late steps: fewer registers a block).  It stages
//   with 16-byte cp.async, into unpadded rows of 64 bf16 whose 16-byte
//   chunks are XOR-swizzled by the row (conflict-free ldmatrix, no padding),
//   the query rows and the joint K tile -- the prompt, then each beam's
//   visible slots only, min(G, gen_len + S) of them, so nothing later in
//   the cache is read -- in one copy group and V in the next, K4's
//   ancestry bias of the staged columns (4-byte cp.async, by the original
//   (beam, slot)), then, while those land, the S new tokens' K/V through
//   registers into the HBM cache and their staged rows, zeros in the
//   padded rows, and each generated column's (beam, slot), so that the
//   masking needs no division.  S = Q K^T by mma.m16n8k16 over m16 tiles of
//   the K*S query rows (one tile for beam 5's 10 rows and greedy's 2); each
//   warp masks its columns (padding, and another beam's columns in K3, are
//   excluded: -inf), takes its row max and its sum relative to it, and one
//   barrier combines them over the warps in a fixed order.  P is normalized
//   in fp32, times K5's keep (vlp::keep_frag at the joint column), rounded
//   to bf16 and reused from the accumulator registers as the A operand of
//   P V; the warps' fp32 partial contexts are added in shared memory (in
//   K's place when one m-tile holds every row) and rounded once.
// * fp32: decode_attention_f32, on the CUDA cores (fp32 FMAs: the step is
//   bound by bytes and latency, its FLOP a quarter of the bytes' time, and
//   the card-vs-CPU fp32 beam traces want fp32 arithmetic).  It stages like
//   the bf16 body -- the query rows, then the prompt and each beam's visible
//   slots only, K in one 16-byte cp.async group and V in the next, K4's
//   bias of the staged columns by cp.async too, the new tokens through
//   registers into the HBM cache and their staged rows while the copies
//   land -- so that its shared memory follows the visible columns (two or
//   three blocks share an SM at beam 5 and greedy).  One warp per 32 joint
//   columns, a lane owning one: each K element is read from shared memory
//   once, for every query row of the pass (2, 10 or 16 rows, a template
//   each, so that no row is guarded; rows past K*S run on zero queries and
//   are not stored), the rows broadcast; K's 16-byte chunks
//   are XOR-swizzled by the row, so that the 8 lanes of a quarter-warp hit
//   8 distinct bank groups.  A lane knows its column's (beam, slot) from
//   one division, so the mask needs none per row.  Each warp keeps
//   exp(s - its row max) and its sum; after one barrier (which also sees V
//   landed) lane r combines row r's maxima and sums over the warps in a
//   fixed order and hands each lane the warp's factor exp(max_w - max) /
//   total: P in fp32, times K5's keep (the four lanes of a counter block
//   draw four rows' words at once and exchange them: one Philox call per
//   four columns of a row).  P V: a lane owns two output dims of every row
//   over its warp's columns (P broadcast from shared memory); the warps'
//   partial contexts are added in a fixed order in shared memory.  With one
//   pass of rows, a warp's P and partial context take its own K rows, read
//   by then.  A step too large for one pass (none of the recipes': K*S >
//   16, or columns near the 227 KB limit) runs passes of 2 rows over the
//   staged K/V, each pass staging its own query rows and its beams' bias;
//   that fits every step of at most 417 joint columns.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = 64;

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *static_cast<const uint4*>(p);
}

// ---- bf16: on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaMaxWarps = 16;
constexpr int kNarrowWarps = 4;  // up to 4 warps: 6 blocks share an SM
constexpr int kCtxStride = D + 8;  // fp32 row of a warp's partial context:
// the float2 stores of a half-warp fall on 32 distinct banks
using vlp::kLog2e;

// Element offset of 16-byte chunk c (0..7) of row r in an unpadded
// [rows][64] bf16 tile whose chunks are XOR-swizzled by the row: the 8
// rows an ldmatrix reads, and the 8 chunks of a row, fall on distinct bank
// groups, with no padding.
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Shared-memory layout of decode_attention_mma, computed alike on the host
// (launch size) and in the kernel.
struct MmaLayout {
  int nv;     // staged (visible) generated slots of a beam: min(G, gen_len + S)
  int ncols;  // joint columns: the prompt, then each beam's nv slots
  int np;     // ncols rounded up to 16: staged K and V rows
  int nw;     // warps, one per kCols key columns
  int ks;     // query rows K * S
  int rows;   // query rows an m-tile holds: min(16, ks)
  int gcols;  // generated columns: K * nv
  int sk, sv, sbias, scol, sx, sctx, bytes;  // byte offsets, total
};

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

__host__ __device__ __forceinline__ MmaLayout mma_layout(int K, int S, int P,
                                                         int G, int gen_len,
                                                         bool anc,
                                                         int kCols) {
  MmaLayout l;
  l.nv = gen_len < G - S ? gen_len + S : G;
  l.ncols = P + K * l.nv;
  l.np = round16(l.ncols);
  l.nw = (l.np + kCols - 1) / kCols;
  l.ks = K * S;
  l.rows = l.ks < 16 ? l.ks : 16;
  l.gcols = K * l.nv;
  const int tile = l.np * D * 2;
  const int ctx = l.nw * l.rows * kCtxStride * 4;
  l.sk = round16(l.ks) * D * 2;
  l.sv = l.sk + tile;
  l.sbias = l.sv + tile;
  l.scol = l.sbias + (anc ? K * l.gcols * 4 : 0);
  l.sx = round16(l.scol + l.gcols * 4);
  const int end = round16(l.sx + 2 * l.nw * 16 * 4);
  // one m-tile: the partial contexts take K's place once the scores are in
  const bool alias = l.ks <= 16 && ctx <= tile;
  l.sctx = alias ? l.sk : end;
  l.bytes = alias ? end : end + ctx;
  return l;
}

__device__ __forceinline__ void st16(void* p, const uint4& v) {
  *static_cast<uint4*>(p) = v;
}

// acc[n] = Q(rows r0 .. r0+15) K(rows c0 + 8n ..)^T for n < kNT (even), K
// rows below np only, on swizzled tiles.
template <int kNT>
__device__ __forceinline__ void scores(float (&acc)[kNT][4], const bf16* sq,
                                       const bf16* sk, int r0, int c0,
                                       int np, int lane) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    vlp::ldsm_x4(fa, sq + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int pr = 0; pr < kNT / 2; ++pr) {
      const int n0 = c0 + pr * 16;
      if (n0 >= np) continue;
      uint32_t fb[4];
      vlp::ldsm_x4(fb, sk + swz(n0 + (lane & 7) + (lane >> 4) * 8,
                                2 * kk + ((lane >> 3) & 1)));
      vlp::mma_bf16(acc[2 * pr], fa, fb[0], fb[1]);
      vlp::mma_bf16(acc[2 * pr + 1], fa, fb[2], fb[3]);
    }
  }
}

// One warp per kCols = 8 * kNT key columns of the joint (prompt | generated)
// axis, every warp on every m-tile of query rows; see the file comment.
// At most kMaxW warps: kNarrowWarps lets six blocks share an SM.
template <bool kHasAnc, bool kDrop, int kNT, int kMaxW>
__global__ void __launch_bounds__(kMaxW * 32, kMaxW == kNarrowWarps ? 6 : 1)
    decode_attention_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ pk,
                         const bf16* __restrict__ pv, bf16* __restrict__ gk,
                         bf16* __restrict__ gv,
                         const float* __restrict__ beam_bias,
                         bf16* __restrict__ out, int K, int S, int P, int G,
                         int H, long long psb, int gen_len, float scale,
                         vlp::Dropout dp) {
  static_assert(!(kHasAnc && kDrop), "dropout is for sampling (K == 1)");
  constexpr int kCols = 8 * kNT;
  constexpr int E = 8;         // bf16 per 16-byte chunk
  constexpr int CPR = D / E;   // chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaLayout lay = mma_layout(K, S, P, G, gen_len, kHasAnc, kCols);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);           // [ks16][64]
  bf16* sk = reinterpret_cast<bf16*>(smem_raw + lay.sk);  // [np][64]
  bf16* sv = reinterpret_cast<bf16*>(smem_raw + lay.sv);  // [np][64]
  float* sbias = reinterpret_cast<float*>(smem_raw + lay.sbias);  // [K][gcols]
  int* scol = reinterpret_cast<int*>(smem_raw + lay.scol);  // [gcols]
  float* xmax = reinterpret_cast<float*>(smem_raw + lay.sx);      // [nw][16]
  float* xsum = xmax + lay.nw * 16;                                // [nw][16]
  float* ctx = reinterpret_cast<float*>(smem_raw + lay.sctx);  // [nw][rows][]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HD = H * D;
  const int hc = h * D;
  const int nv = lay.nv;
  const long long row0 = (long long)b * K;  // the example's first beam row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- staging, copies first: the query rows (example b's are the
  // contiguous rows b*K*S ..), then the prompt and each beam's committed
  // slots, K in one copy group and V in the next
  for (int c = threadIdx.x; c < lay.ks * CPR; c += blockDim.x)
    vlp::cp_async<16>(sq + swz(c / CPR, c % CPR),
                      q + (row0 * S + c / CPR) * HD + hc + (c % CPR) * E);
  const int committed = gen_len < G ? gen_len : G;
  auto stage_cache = [&](bf16* dst, const bf16* prompt, const bf16* cache) {
    for (int c = threadIdx.x; c < P * CPR; c += blockDim.x)
      vlp::cp_async<16>(dst + swz(c / CPR, c % CPR),
                        prompt + b * psb + (long long)(c / CPR) * HD + hc +
                            (c % CPR) * E);
    for (int kk = 0; kk < K; ++kk)
      for (int c = threadIdx.x; c < committed * CPR; c += blockDim.x)
        vlp::cp_async<16>(dst + swz(P + kk * nv + c / CPR, c % CPR),
                          cache + ((row0 + kk) * G + c / CPR) * HD + hc +
                              (c % CPR) * E);
    vlp::cp_async_commit();
  };
  // K4: the ancestry bias of the staged columns, by the original (beam,
  // slot), in K's copy group: one warp per (query beam, key beam), one
  // lane per slot
  if constexpr (kHasAnc)
    for (int pr = warp; pr < K * K; pr += lay.nw)
      for (int j = lane; j < nv; j += 32)
        vlp::cp_async<4>(sbias + (pr / K) * lay.gcols + (pr % K) * nv + j,
                         beam_bias + (row0 + pr / K) * K * G +
                             (pr % K) * G + j);
  stage_cache(sk, pk, gk);
  stage_cache(sv, pv, gv);
  // while those land: the S new tokens' K/V, from k/v into their cache
  // slots (in place) and into their staged rows (slots >= G are dropped)
  for (int c = threadIdx.x; c < lay.ks * CPR; c += blockDim.x) {
    const int r = c / CPR, e = c % CPR;
    const int kk = r / S, j = gen_len + r % S;
    if (j >= G) continue;
    const long long src = ((row0 + kk) * S + r % S) * HD + hc + e * E;
    const long long dst = ((row0 + kk) * G + j) * HD + hc + e * E;
    const uint4 kx = ld16(k + src), vx = ld16(v + src);
    st16(gk + dst, kx);
    st16(gv + dst, vx);
    st16(sk + swz(P + kk * nv + j, e), kx);
    st16(sv + swz(P + kk * nv + j, e), vx);
  }
  // zeros in the padded query and key rows (an excluded column must not
  // meet a stale NaN in P V)
  for (int c = threadIdx.x; c < (round16(lay.ks) - lay.ks) * CPR;
       c += blockDim.x)
    st16(sq + (lay.ks + c / CPR) * D + (c % CPR) * E, make_uint4(0, 0, 0, 0));
  for (int c = threadIdx.x; c < (lay.np - lay.ncols) * CPR;
       c += blockDim.x) {
    const int off = (lay.ncols + c / CPR) * D + (c % CPR) * E;
    st16(sk + off, make_uint4(0, 0, 0, 0));
    st16(sv + off, make_uint4(0, 0, 0, 0));
  }
  // each generated column's (beam, slot), so that the scores need no
  // division
  for (int x = threadIdx.x; x < lay.gcols; x += blockDim.x)
    scol[x] = (x / nv) << 16 | x % nv;
  vlp::cp_async_wait<1>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * kCols;
  for (int r0 = 0; r0 < lay.ks; r0 += 16) {
    // ---- S = Q K^T, masked, in registers: this warp's columns of rows
    // r0 + g and r0 + g + 8
    float p[kNT][4];
    scores<kNT>(p, sq, sk, r0, c0, lay.np, lane);
    int beam[2], last[2];  // a row's beam and its last visible slot
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = min(r0 + g + 8 * hh, lay.ks - 1);  // padded rows: any
      beam[hh] = r / S;
      last[hh] = gen_len + r % S;
    }
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + n * 8 + 2 * t + (e & 1), hh = e >> 1;
        float bias = 0.f;  // prompt columns: always visible
        bool excluded = c >= lay.ncols;  // padding
        if (!excluded && c >= P) {
          const int col = scol[c - P];
          bias = (col & 0xffff) <= last[hh] ? 0.f : vlp::kNegInf;
          if constexpr (kHasAnc)
            bias = __fadd_rn(bias, sbias[beam[hh] * lay.gcols + c - P]);
          else
            excluded = col >> 16 != beam[hh];  // K3: its own beam only
        }
        p[n][e] = excluded ? -CUDART_INF_F
                           : __fadd_rn(__fmul_rn(p[n][e], scale), bias);
        m[hh] = fmaxf(m[hh], p[n][e]);
      }
    // ---- one softmax over (prompt | generated): each warp's row max and
    // its sum relative to it, combined over the warps in a fixed order
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], o));
      // a warp whose columns are all excluded holds p = 0 and sum 0
      const float mw = m[hh] == -CUDART_INF_F ? 0.f : m[hh];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          p[n][e] = exp2f((p[n][e] - mw) * kLog2e);
          sum[hh] += p[n][e];
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], o);
    }
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        xmax[warp * 16 + g + 8 * hh] = m[hh];
        xsum[warp * 16 + g + 8 * hh] = sum[hh];
      }
    }
    vlp::cp_async_wait<0>();  // V, visible after the barrier
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -CUDART_INF_F;
      for (int w = 0; w < lay.nw; ++w)
        mx = fmaxf(mx, xmax[w * 16 + g + 8 * hh]);
      float total = 0.f;
      for (int w = 0; w < lay.nw; ++w)
        total += xsum[w * 16 + g + 8 * hh] *
                 exp2f((xmax[w * 16 + g + 8 * hh] - mx) * kLog2e);
      // this warp's exp(s - mw) to exp(s - mx) / total
      const float f = exp2f((m[hh] - mx) * kLog2e) / total;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        p[n][2 * hh] *= f;
        p[n][2 * hh + 1] *= f;
      }
    }
    // K5: times the keep multipliers of the joint column (K == 1, so a
    // row's counter row is its query row)
    if constexpr (kDrop)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        if (c0 + n * 8 < lay.ncols) {
          float mult[4];
          vlp::keep_frag(dp, b, h, r0 + g, c0 + n * 8, lane, mult);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[n][e] *= mult[e];
        }

    // ---- this warp's share of the context: bf16(P) V over its columns
    float o[D / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const int k0 = c0 + kk * 16;
      if (k0 >= lay.np) continue;
      const uint32_t a[4] = {
          vlp::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          vlp::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          vlp::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          vlp::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        vlp::ldsm_x4_t(bv, sv + swz(k0 + (lane & 15), 2 * np + (lane >> 4)));
        vlp::mma_bf16(o[2 * np], a, bv[0], bv[1]);
        vlp::mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    const int nrow = min(16, lay.ks - r0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = g + 8 * hh;
      if (rr >= nrow) continue;
      float* crow = ctx + (warp * lay.rows + rr) * kCtxStride + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(crow + n * 8) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
    __syncthreads();
    // ---- the warps' contexts added in fp32 in a fixed order, rounded once
    for (int i = threadIdx.x; i < nrow * (D / 2); i += blockDim.x) {
      const int rr = i / (D / 2), d = (i % (D / 2)) * 2;
      float x = 0.f, y = 0.f;
      for (int w = 0; w < lay.nw; ++w) {
        const float2 c2 = *reinterpret_cast<const float2*>(
            ctx + (w * lay.rows + rr) * kCtxStride + d);
        x += c2.x;
        y += c2.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(
          out + (row0 * S + r0 + rr) * HD + hc + d) =
          __floats2bfloat162_rn(x, y);
    }
    // the next m-tile rewrites xmax, xsum and ctx
    if (r0 + 16 < lay.ks) __syncthreads();
  }
}

template <bool kHasAnc, bool kDrop>
int launch_mma(const void* q, const void* k, const void* v, const void* pk,
               const void* pv, void* gk, void* gv, const float* beam_bias,
               void* out, int B, int K, int S, int P, int G, int H,
               long long psb, int gen_len, float scale, vlp::Dropout dp,
               cudaStream_t stream) {
  // 32 columns a warp while four warps cover the columns (K3, K5 and K4's
  // first steps: six blocks share an SM); 64 beyond (fewer registers a
  // block than 32-column warps, the shared memory being the same)
  MmaLayout lay = mma_layout(K, S, P, G, gen_len, kHasAnc, 32);
  const bool wide = lay.nw > kNarrowWarps;
  if (wide) lay = mma_layout(K, S, P, G, gen_len, kHasAnc, 64);
  if (lay.nw > kMmaMaxWarps || lay.bytes > vlp::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = wide ? decode_attention_mma<kHasAnc, kDrop, 8, kMmaMaxWarps>
                     : decode_attention_mma<kHasAnc, kDrop, 4, kNarrowWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, lay.nw * 32, lay.bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv), static_cast<bf16*>(gk),
      static_cast<bf16*>(gv), beam_bias, static_cast<bf16*>(out), K, S, P, G,
      H, psb, gen_len, scale, dp);
  return (int)cudaGetLastError();
}

// ---- fp32: on the CUDA cores

constexpr int kF32Rows = 16;      // query rows a pass holds at most
constexpr int kF32MaxWarps = 16;  // one per 32 joint columns

// The rows a pass computes for `r` query rows: one of the bodies' row
// counts, 2 (greedy K3 and K5, S = 2), 10 (beam 5) or 16.
__host__ __device__ constexpr int f32_pass_rows(int r) {
  return r <= 2 ? 2 : r <= 10 ? 10 : kF32Rows;
}

// Shared-memory layout of decode_attention_f32 at `rows` query rows a
// pass, computed alike on the host (launch size) and in the kernel.
struct F32Layout {
  int nv;      // staged (visible) slots of a beam: min(G, gen_len + S)
  int gcols;   // generated columns: K * nv
  int ncols;   // joint columns: the prompt, then each beam's nv slots
  int nw;      // warps, one per 32 columns
  int ks;      // query rows K * S
  int nb;      // K4: beams whose bias rows a pass stages (those of its rows)
  bool alias;  // one pass: a warp's P and partial context in its own K rows
  int sk, sv, sbias, sx, sscr, bytes;  // byte offsets, total
};

__host__ __device__ __forceinline__ F32Layout f32_layout(int K, int S, int P,
                                                         int G, int gen_len,
                                                         bool anc,
                                                         int rows) {
  F32Layout l;
  l.nv = gen_len < G - S ? gen_len + S : G;
  l.gcols = K * l.nv;
  l.ncols = P + l.gcols;
  l.nw = (l.ncols + 31) / 32;
  l.ks = K * S;
  l.alias = rows >= l.ks;
  // rows r0 .. r0 + rows - 1 belong to at most (rows - 1) / S + 2 beams
  const int span = (rows - 1) / S + 2;
  l.nb = l.alias || span > K ? K : span;
  // staged K rows; aliased, the last warp's scratch may reach past them
  const int tail = 32 * (l.nw - 1) + rows;
  const int krows = l.alias && tail > l.ncols ? tail : l.ncols;
  l.sk = rows * D * 4;  // after the pass's query rows
  l.sv = l.sk + krows * D * 4;
  l.sbias = l.sv + l.ncols * D * 4;
  l.sx = round16(l.sbias + (anc ? l.nb * l.gcols * 4 : 0));
  l.sscr = l.sx + 2 * l.nw * kF32Rows * 4;
  l.bytes = l.sscr + (l.alias ? 0 : l.nw * rows * D * 4);
  return l;
}

// Query rows a pass takes: all K*S in one pass if that layout fits a block
// (every recipe's step), else passes of 2 rows; 0 if neither fits.  At 2
// rows a pass a block needs at most 512 ncols + 640 nw + 12 ncols + 512
// bytes, so every step of at most 417 joint columns fits.
int f32_rows(int K, int S, int P, int G, int gen_len, bool anc) {
  auto fits = [&](int rows) {
    const F32Layout l = f32_layout(K, S, P, G, gen_len, anc, rows);
    return l.nw <= kF32MaxWarps && l.bytes <= vlp::kMaxSmemBytes;
  };
  const int ks = K * S;
  if (ks <= kF32Rows && fits(f32_pass_rows(ks))) return f32_pass_rows(ks);
  return fits(2) ? 2 : 0;
}

// One warp per 32 columns of the joint (prompt | generated) axis, a lane
// per column, each pass over kRows query rows (rows past K*S are computed on
// zero queries and not stored), one pass unless kPasses (whose restaging
// would cost the one-pass bodies registers); see the file comment.
template <bool kHasAnc, bool kDrop, int kRows, bool kPasses>
__global__ void __launch_bounds__(kF32MaxWarps * 32)
    decode_attention_f32(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ pk,
                         const float* __restrict__ pv, float* __restrict__ gk,
                         float* __restrict__ gv,
                         const float* __restrict__ beam_bias,
                         float* __restrict__ out, int K, int S, int P, int G,
                         int H, long long psb, int gen_len, float scale,
                         vlp::Dropout dp) {
  static_assert(!(kHasAnc && kDrop), "dropout is for sampling (K == 1)");
  constexpr int E = 4;         // floats per 16-byte chunk
  constexpr int CPR = D / E;   // chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const F32Layout lay = f32_layout(K, S, P, G, gen_len, kHasAnc, kRows);
  float* sq = reinterpret_cast<float*>(smem_raw);            // [kRows][64]
  float* sk = reinterpret_cast<float*>(smem_raw + lay.sk);   // [][64] swizzled
  float* sv = reinterpret_cast<float*>(smem_raw + lay.sv);   // [ncols][64]
  float* sbias = reinterpret_cast<float*>(smem_raw + lay.sbias);  // [nb][gcols]
  float* xmax = reinterpret_cast<float*>(smem_raw + lay.sx);  // [nw][16]
  float* xsum = xmax + lay.nw * kF32Rows;                      // [nw][16]
  // warp w's probabilities [kRows][32], then in their place its partial
  // context [kRows][64]
  auto scratch = [&](int w) {
    return lay.alias ? sk + w * 32 * D
                     : reinterpret_cast<float*>(smem_raw + lay.sscr) +
                           w * kRows * D;
  };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int HD = H * D;
  const int hc = h * D;
  const int nv = lay.nv;
  const long long row0 = (long long)b * K;  // the example's first beam row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a thread copies chunk e0 of rows r, r + rstep, ... (blockDim.x is a
  // multiple of 32): no division per copy
  const int e0 = threadIdx.x % CPR, rstep = blockDim.x / CPR;

  // a pass's query rows r0 .. r0 + kRows - 1 (example b's are the
  // contiguous rows b*K*S ..), zeros past K*S, and K4's ancestry bias of
  // the staged columns for the beams of those rows, by the original (beam,
  // slot): one warp per (query beam, key beam), one lane per slot
  auto stage_pass = [&](int r0) {
    for (int r = threadIdx.x / CPR; r < kRows; r += rstep) {
      if (r0 + r < lay.ks)
        vlp::cp_async<16>(sq + r * D + e0 * E,
                          q + (row0 * S + r0 + r) * HD + hc + e0 * E);
      else
        st16(sq + r * D + e0 * E, make_uint4(0, 0, 0, 0));
    }
    if constexpr (kHasAnc) {
      const int kb = r0 / S, nb = min(lay.nb, K - kb);
      for (int pr = warp; pr < nb * K; pr += lay.nw)
        for (int j = lane; j < nv; j += 32)
          vlp::cp_async<4>(sbias + (pr / K) * lay.gcols + (pr % K) * nv + j,
                           beam_bias + (row0 + kb + pr / K) * K * G +
                               (pr % K) * G + j);
    }
  };

  // ---- staging, copies first: the first pass's query rows and bias, then
  // the prompt and each beam's committed slots, K (16-byte chunks
  // XOR-swizzled by the row) in one copy group and V in the next
  stage_pass(0);
  const int committed = gen_len < G ? gen_len : G;
  auto stage_cache = [&](float* dst, bool swizzled, const float* prompt,
                         const float* cache) {
    auto at = [&](int r) {
      return dst + r * D + (swizzled ? e0 ^ (r & 7) : e0) * E;
    };
    const float* src = prompt + b * psb + hc + e0 * E;
    for (int r = threadIdx.x / CPR; r < P; r += rstep)
      vlp::cp_async<16>(at(r), src + (long long)r * HD);
    for (int kk = 0; kk < K; ++kk) {
      const float* src = cache + (row0 + kk) * G * HD + hc + e0 * E;
      for (int j = threadIdx.x / CPR; j < committed; j += rstep)
        vlp::cp_async<16>(at(P + kk * nv + j), src + (long long)j * HD);
    }
    vlp::cp_async_commit();
  };
  stage_cache(sk, true, pk, gk);
  stage_cache(sv, false, pv, gv);
  // while those land: the S new tokens' K/V, from k/v into their cache
  // slots (in place) and into their staged rows (slots >= G are dropped)
  for (int r = threadIdx.x / CPR; r < lay.ks; r += rstep) {
    const int kk = r / S, j = gen_len + r % S;
    if (j >= G) continue;
    const long long src = ((row0 + kk) * S + r % S) * HD + hc + e0 * E;
    const long long dst = ((row0 + kk) * G + j) * HD + hc + e0 * E;
    const uint4 kx = ld16(k + src), vx = ld16(v + src);
    st16(gk + dst, kx);
    st16(gv + dst, vx);
    const int sr = P + kk * nv + j;
    st16(sk + sr * D + (e0 ^ (sr & 7)) * E, kx);
    st16(sv + sr * D + e0 * E, vx);
  }
  vlp::cp_async_wait<1>();
  __syncthreads();

  // this lane's column: its (beam, slot) once, by one division; a lane
  // past the columns reads the last staged row and is excluded
  const int c = warp * 32 + lane;
  const bool valid = c < lay.ncols;
  const bool gen = valid && c >= P;
  const int beam = gen ? (c - P) / nv : 0;
  const int slot = gen ? c - P - beam * nv : 0;
  const int kr = valid ? c : lay.ncols - 1;
  const float* krow = sk + kr * D;
  const int ncw = min(32, lay.ncols - warp * 32);  // this warp's columns
  float* scr = scratch(warp);

  for (int r0 = 0; r0 < lay.ks; r0 += kRows) {
    if constexpr (kPasses)
      if (r0 > 0) {  // the pass's query rows and bias
        stage_pass(r0);
        vlp::cp_async_commit();
        vlp::cp_async_wait<0>();
        __syncthreads();
      }
    // ---- the lane's column's scores against the pass's rows: each K
    // element read once, the q rows broadcast, d in order
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int e = 0; e < CPR; ++e) {
      const float4 kx =
          *reinterpret_cast<const float4*>(krow + (e ^ (kr & 7)) * E);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qx =
            *reinterpret_cast<const float4*>(sq + r * D + e * E);
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }
    // ---- masked (padding, and another beam's columns in K3, are
    // excluded: -inf); this warp's row max, exp(s - max) and its sum
    // row r0 + r: beam kk, new token ss (rows past K*S keep the last's)
    const int kb = r0 / S;  // the pass's first beam: bias row 0
    int kk = kb, ss = r0 - kk * S;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float bias = 0.f;  // prompt columns: always visible
      bool excluded = !valid;
      if (gen) {
        bias = slot <= gen_len + ss ? 0.f : vlp::kNegInf;
        if constexpr (kHasAnc)
          bias = __fadd_rn(bias, sbias[(kk - kb) * lay.gcols + c - P]);
        else
          excluded = beam != kk;  // K3: its own beam only
      }
      const float x = excluded ? -CUDART_INF_F
                               : __fadd_rn(__fmul_rn(s[r], scale), bias);
      const float m = vlp::warp_max(x);
      // a warp whose columns are all excluded holds 0s, sum 0
      s[r] = expf(x - (m == -CUDART_INF_F ? 0.f : m));
      const float l = vlp::warp_sum(s[r]);
      if (lane == 0) {
        xmax[warp * kF32Rows + r] = m;
        xsum[warp * kF32Rows + r] = l;
      }
      if (r0 + r + 1 < lay.ks && ++ss == S) {
        ss = 0;
        ++kk;
      }
    }
    vlp::cp_async_wait<0>();  // V, visible after the barrier
    __syncthreads();
    // ---- one softmax over (prompt | generated): lane r combines row r's
    // maxima and sums over the warps in a fixed order, and hands each
    // lane this warp's factor exp(max_w - max) / total; P in fp32
    float f = 0.f;
    if (lane < kRows) {
      float mx = -CUDART_INF_F;
      for (int w = 0; w < lay.nw; ++w)
        mx = fmaxf(mx, xmax[w * kF32Rows + lane]);
      float total = 0.f;
      for (int w = 0; w < lay.nw; ++w)
        total += xsum[w * kF32Rows + lane] *
                 expf(xmax[w * kF32Rows + lane] - mx);
      f = expf(xmax[warp * kF32Rows + lane] - mx) / total;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] *= __shfl_sync(0xffffffffu, f, r);
    // K5 (K == 1: pass row r is query row r0 + r): the four lanes of a
    // counter block (columns 4i..4i+3) draw four rows at once, lane i' row
    // r0 + g + i', and pass the words round the quad so that each lane
    // gets its column's word (c % 4) of every row: one Philox call per four
    // columns of a row, keep_scale4's bits
    if constexpr (kDrop) {
      const int i = lane & 3;
#pragma unroll
      for (int g = 0; g < kRows; g += 4) {
        const uint4 w = vlp::philox4x32_10(
            make_uint4((unsigned)(c >> 2), (unsigned)(r0 + g + i),
                       (unsigned)h, (unsigned)b),
            dp.seed);
        unsigned got[4];  // got[t]: word i of row g + (i - t) % 4
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int sel = (i + t) & 3;
          const unsigned x = sel == 0   ? w.x
                             : sel == 1 ? w.y
                             : sel == 2 ? w.z
                                        : w.w;
          got[t] = __shfl_sync(0xffffffffu, x, (lane & ~3) | ((i - t) & 3));
        }
#pragma unroll
        for (int rr = 0; rr < 4 && g + rr < kRows; ++rr) {
          const int t = (i - rr) & 3;
          const unsigned x = t == 0   ? got[0]
                             : t == 1 ? got[1]
                             : t == 2 ? got[2]
                                      : got[3];
          s[g + rr] *= x >= dp.threshold ? dp.scale : 0.f;
        }
      }
    }

    // ---- this warp's share of the context: a lane owns output dims
    // 2*lane, 2*lane+1 of every row, over the warp's columns in order
#pragma unroll
    for (int r = 0; r < kRows; ++r) scr[r * 32 + lane] = s[r];
    __syncwarp();
    float cx[kRows], cy[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) cx[r] = cy[r] = 0.f;
    const float* vcol = sv + warp * 32 * D + 2 * lane;
    int j = 0;
    for (; j + 4 <= ncw; j += 4) {
      float2 vv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        vv[t] = *reinterpret_cast<const float2*>(vcol + (j + t) * D);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(scr + r * 32 + j);
        cx[r] = fmaf(p4.x, vv[0].x, cx[r]);
        cy[r] = fmaf(p4.x, vv[0].y, cy[r]);
        cx[r] = fmaf(p4.y, vv[1].x, cx[r]);
        cy[r] = fmaf(p4.y, vv[1].y, cy[r]);
        cx[r] = fmaf(p4.z, vv[2].x, cx[r]);
        cy[r] = fmaf(p4.z, vv[2].y, cy[r]);
        cx[r] = fmaf(p4.w, vv[3].x, cx[r]);
        cy[r] = fmaf(p4.w, vv[3].y, cy[r]);
      }
    }
    for (; j < ncw; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(vcol + j * D);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = scr[r * 32 + j];
        cx[r] = fmaf(p, vv.x, cx[r]);
        cy[r] = fmaf(p, vv.y, cy[r]);
      }
    }
    __syncwarp();  // P read: the partial context takes its place
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float2*>(scr + r * D + 2 * lane) =
          make_float2(cx[r], cy[r]);
    __syncthreads();
    // ---- the warps' contexts added in fp32 in a fixed order, the pass's
    // rows below K*S stored
    const int nr = min(kRows, lay.ks - r0);
    for (int i = threadIdx.x; i < nr * (D / 2); i += blockDim.x) {
      const int rr = i / (D / 2), d = (i % (D / 2)) * 2;
      float x = 0.f, y = 0.f;
      for (int w = 0; w < lay.nw; ++w) {
        const float2 c2 =
            *reinterpret_cast<const float2*>(scratch(w) + rr * D + d);
        x += c2.x;
        y += c2.y;
      }
      *reinterpret_cast<float2*>(out + (row0 * S + r0 + rr) * HD + hc + d) =
          make_float2(x, y);
    }
    // the next pass rewrites xmax, xsum and the scratch
    if (kPasses && r0 + kRows < lay.ks) __syncthreads();
  }
}

using F32Kernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*,
                           const float*, float*, int, int, int, int, int,
                           long long, int, float, vlp::Dropout);

// The body for `rows` (from f32_rows) query rows a pass of K*S.
template <bool kHasAnc, bool kDrop>
F32Kernel f32_kernel(int rows, int ks) {
  return rows < ks      ? decode_attention_f32<kHasAnc, kDrop, 2, true>
         : rows == 2  ? decode_attention_f32<kHasAnc, kDrop, 2, false>
         : rows == 10 ? decode_attention_f32<kHasAnc, kDrop, 10, false>
                      : decode_attention_f32<kHasAnc, kDrop, kF32Rows, false>;
}

template <bool kHasAnc, bool kDrop>
int launch_f32(const void* q, const void* k, const void* v, const void* pk,
               const void* pv, void* gk, void* gv, const float* beam_bias,
               void* out, int B, int K, int S, int P, int G, int H,
               long long psb, int gen_len, float scale, vlp::Dropout dp,
               cudaStream_t stream) {
  const int rows = f32_rows(K, S, P, G, gen_len, kHasAnc);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const F32Layout lay = f32_layout(K, S, P, G, gen_len, kHasAnc, rows);
  const F32Kernel kernel = f32_kernel<kHasAnc, kDrop>(rows, K * S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, lay.nw * 32, lay.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(pk),
      static_cast<const float*>(pv), static_cast<float*>(gk),
      static_cast<float*>(gv), beam_bias, static_cast<float*>(out), K, S, P,
      G, H, psb, gen_len, scale, dp);
  return (int)cudaGetLastError();
}

// Blocks of the fp32 body one SM holds at once at this shape (the
// occupancy calculator's count), or a negative cudaError.
template <bool kHasAnc, bool kDrop>
int f32_blocks_per_sm(int K, int S, int P, int G, int gen_len) {
  const int rows = f32_rows(K, S, P, G, gen_len, kHasAnc);
  if (rows == 0) return -(int)cudaErrorInvalidValue;
  const F32Layout lay = f32_layout(K, S, P, G, gen_len, kHasAnc, rows);
  const F32Kernel kernel = f32_kernel<kHasAnc, kDrop>(rows, K * S);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        lay.nw * 32,
                                                        lay.bytes);
  return err == cudaSuccess ? n : -(int)err;
}

// ---- launch: bf16 the tensor-core body, fp32 the CUDA-core one

template <bool kHasAnc, bool kDrop, typename... Args>
int launch(int is_bf16, Args... args) {
  return is_bf16 ? launch_mma<kHasAnc, kDrop>(args...)
                 : launch_f32<kHasAnc, kDrop>(args...);
}

// dp.threshold == 0 (no dropout) selects K3 or K4; otherwise K5, which the
// entry point only reaches with K == 1 and no beam bias
int dispatch(int is_bf16, const void* q, const void* k, const void* v,
             const void* pk, const void* pv, void* gk, void* gv,
             const float* beam_bias, void* out, int B, int K, int S, int P,
             int G, int H, long long psb, int gen_len, float scale,
             vlp::Dropout dp, cudaStream_t stream) {
  if (dp.threshold)
    return launch<false, true>(is_bf16, q, k, v, pk, pv, gk, gv, nullptr, out,
                               B, K, S, P, G, H, psb, gen_len, scale, dp,
                               stream);
  if (beam_bias)
    return launch<true, false>(is_bf16, q, k, v, pk, pv, gk, gv, beam_bias,
                               out, B, K, S, P, G, H, psb, gen_len, scale, dp,
                               stream);
  return launch<false, false>(is_bf16, q, k, v, pk, pv, gk, gv, nullptr, out,
                              B, K, S, P, G, H, psb, gen_len, scale, dp,
                              stream);
}

}  // namespace

extern "C" {

// q/k/v/out: contiguous [B*K, S, H*64]; pk/pv: [B, P, H*64] with batch
// stride psb (elements) and contiguous rows; gk/gv: contiguous
// [B*K, G, H*64], updated in place; beam_bias: contiguous fp32 [B*K, K*G]
// or null (K3).  Every pointer and psb times the element size must be 16-byte
// aligned.
// Returns cudaGetLastError() after the launch.
int vlp_decode_attention(const void* q, const void* k, const void* v,
                         const void* pk, const void* pv, void* gk, void* gv,
                         const void* beam_bias, void* out, int B, int K,
                         int S, int P, int G, int H, long long psb,
                         int gen_len, float scale, int is_bf16,
                         void* stream) {
  if (B <= 0 || K <= 0 || S <= 0 || P <= 0 || G <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(is_bf16, q, k, v, pk, pv, gk, gv,
                  static_cast<const float*>(beam_bias), out, B, K, S, P, G, H,
                  psb, gen_len, scale, vlp::Dropout{0, 0, 1.f},
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
  return dispatch(is_bf16, q, k, v, pk, pv, gk, gv, nullptr, out, B, 1, S, P,
                  G, H, psb, gen_len, scale,
                  vlp::Dropout{seed, threshold, keep_scale},
                  static_cast<cudaStream_t>(stream));
}

// Blocks of the fp32 body (K3; K4 with anc; K5 with drop, K == 1) that one
// SM holds at once for a step of this shape; negative if it refuses it.
int vlp_decode_attention_f32_blocks_per_sm(int K, int S, int P, int G,
                                           int gen_len, int anc, int drop) {
  if (K <= 0 || S <= 0 || P <= 0 || G <= 0 || gen_len < 0 || (anc && drop))
    return -(int)cudaErrorInvalidValue;
  if (drop) return f32_blocks_per_sm<false, true>(1, S, P, G, gen_len);
  return anc ? f32_blocks_per_sm<true, false>(K, S, P, G, gen_len)
             : f32_blocks_per_sm<false, false>(K, S, P, G, gen_len);
}

}  // extern "C"
