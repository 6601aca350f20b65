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
// is 20 MB and the generated K/V at most 4 MB, ~7.5 us.  A memory- and
// latency-bound kernel: what counts is how many bytes are in flight per SM
// and how short the serial phases of a block are.
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
// * fp32: decode_attention_kernel, the first version on the CUDA cores
//   (fp32 FMAs), which the card-vs-CPU fp32 beam traces need: the block
//   copies its head's prompt and all K*G generated rows into shared memory
//   with 16-byte loads, and one warp serves each query row, lane c owning
//   columns c, c+32, ... of the joint row and output dims 2*lane,
//   2*lane+1.  K rows are padded by two elements so that the 32 lanes
//   reading 32 different rows hit distinct banks.  In K5 a lane draws its
//   own columns' multipliers (one Philox call per column).

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = 64;
constexpr int kWarps = 8;
constexpr int kRowStride = D + 2;  // padded K rows (elements)

size_t smem_bytes(int P, int K, int G) {
  const size_t cols = size_t(P) + size_t(K) * G;
  return sizeof(float) * (kWarps * D + kWarps * cols + cols * kRowStride +
                          cols * D);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
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

template <bool kHasAnc, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ pk,
    const float* __restrict__ pv, float* __restrict__ gk,
    float* __restrict__ gv, const float* __restrict__ beam_bias,
    float* __restrict__ out, int K, int S, int P, int G, int H, long long psb,
    int gen_len, float scale, vlp::Dropout dp) {
  static_assert(!(kHasAnc && kDrop), "dropout is for sampling (K == 1)");
  constexpr int E = 4;        // floats per 16-byte chunk
  constexpr int CPR = D / E;  // chunks per head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KG = K * G;
  const int cols = P + KG;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kWarps][D]
  float* ps = qs + kWarps * D;                     // [kWarps][P + K*G]
  float* pks = ps + kWarps * cols;                 // [P][kRowStride]
  float* pvs = pks + P * kRowStride;               // [P][D]
  float* gks = pvs + P * D;          // [K*G][kRowStride], rows beam-major
  float* gvs = gks + KG * kRowStride;  // [K*G][D]

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
      const float* kr;
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
      pw[c] = p;
    }
    __syncwarp();

    const int d0 = 2 * lane;
    const float* gv_rows = gvs + (kHasAnc ? 0 : kk * G * D);
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

// ---- bf16: on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaMaxWarps = 16;
constexpr int kNarrowWarps = 4;  // up to 4 warps: 6 blocks share an SM
constexpr int kCtxStride = D + 8;  // fp32 row of a warp's partial context:
// the float2 stores of a half-warp fall on 32 distinct banks
constexpr float kLog2e = 1.4426950408889634f;

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

// ---- launch: bf16 the tensor-core body, fp32 the first version

template <bool kHasAnc, bool kDrop>
int launch_fp32(const void* q, const void* k, const void* v, const void* pk,
                const void* pv, void* gk, void* gv, const float* beam_bias,
                void* out, int B, int K, int S, int P, int G, int H,
                long long psb, int gen_len, float scale, vlp::Dropout dp,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(P, K, G);
  if (smem > (size_t)vlp::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<kHasAnc, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<kHasAnc, kDrop><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(pk),
      static_cast<const float*>(pv), static_cast<float*>(gk),
      static_cast<float*>(gv), beam_bias, static_cast<float*>(out), K, S, P,
      G, H, psb, gen_len, scale, dp);
  return (int)cudaGetLastError();
}

template <bool kHasAnc, bool kDrop, typename... Args>
int launch(int is_bf16, Args... args) {
  return is_bf16 ? launch_mma<kHasAnc, kDrop>(args...)
                 : launch_fp32<kHasAnc, kDrop>(args...);
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

}  // extern "C"
