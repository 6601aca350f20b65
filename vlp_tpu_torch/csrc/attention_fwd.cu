// Fused structurally-masked attention forward, in both layouts of the JAX
// package's attention_pallas: [B, L, H*D] ("blhd") and [B, H, L, D]
// ("bhld").
//
// Replaces the TPU kernels vlp_tpu/ops/attention.py:_fwd_kernel_blhd (:117)
// and _fwd_kernel (:95, the bhld layout), both branches of each.  Per
// (example, head): S = Q K^T * (1/sqrt(D)) in fp32 plus the additive -10000
// mask built on the fly from (mode, text_end, colkeep, prefix)
// (attention.py:_mask_bias), fp32 softmax, then -- in the dropout branch
// (training, attention.py:110 and :148) -- P times the Philox keep/scale
// multipliers of common.cuh, P cast to the input dtype, then P V
// accumulated in fp32.  The backward kernel (attention_bwd.cu) regenerates
// the same multipliers from the same seed.  In blhd, Q/K/V are read
// straight off the projections (heads are column slices of the row), so no
// head transpose exists; in bhld each head is its own L x D block.  Each
// body addresses its operands only through vlp::Strides, so it serves both
// layouts, and the output layout is the input's.
//
// The body is chosen by dtype and length (never by a failure):
// * bf16 (every main path) and fp16 (--true_fp16 training): templates over
//   T on the tensor cores (mma.m16n8k16 with bf16 or fp16 operands at the
//   same rate; fp16 is the bf16 body instantiated for __half, with P and
//   the output rounded to fp16, where a value past 65504 becomes inf and a
//   NaN stays NaN, as the loss scaler needs).  Tiles are staged with
//   16-byte cp.async (narrower copies when a base pointer or stride is not
//   16-byte aligned) into rows padded to 72 elements, so ldmatrix reads are
//   conflict-free.  Each warp owns 16 query rows: S = Q K^T by
//   mma.m16n8k16 (fp32 out) into registers, the mask and the softmax in
//   registers (quad shuffles for the row max and sum), the keep
//   multipliers drawn per lane pair (vlp::keep_frag, the bits of
//   keep_scale4), P rounded to T and reused as the A operand of P V with
//   no trip through shared memory (ldmatrix.trans gives V's fragments).
//   The order of the rounding is the TPU kernel's: P normalized in fp32,
//   times keep, then cast; no online rescaling of an unnormalized P.
//   Padded columns of a ragged L are excluded (not given -10000), padded
//   rows are never stored.
//   - L <= 128, attention_fwd_mma: one block per (example, head) stages
//     the head's Q, K and V once (K in the first copy group, V in the
//     second, so S is computed while V lands); a warp holds its rows'
//     whole key row (64 fp32 a thread).
//   - 128 < L <= 528, attention_fwd_rows: a block owns 128 query rows of
//     one head (8 warps), its Q staged once and held as A fragments in
//     registers, and streams 64-key tiles through a two-stage cp.async
//     ring (one barrier a tile) twice: pass 1 reads K and keeps each
//     row's running max and sum in fp32 (rescaled when the max moves:
//     exact, nothing is rounded to T); pass 2 reads K and V, recomputes
//     S, forms P = exp(S - m) / l, keep and rounding, and accumulates
//     P V.  Scores are kept in log2
//     units (one ex2 per exponential, as the tiled backward).  Key tiles
//     that the structural mask hides from all 128 rows (masked_region) are
//     not staged; a warp skips those hidden from its 16 rows, and the
//     Philox draws of 8-key slices hidden from them.  Shared memory is
//     57,600 bytes at every L (Q, the ring, the column bias of 528 keys).
// * fp32: attention_fwd_fp32, on the tensor cores in split TF32 (mma.cuh:
//   each operand split into two TF32 parts, three m16n8k8 products; ~2^-21
//   relative error per product, an fp32 summation-order difference), which
//   the card-vs-CPU fp32 gates need.  One body for every L the 16-bit
//   bodies take (528).  A block owns 64 query rows, 4 warps of 16, each
//   warp's Q split into fragments in registers; K and V stream in 64-key tiles
//   through a double-buffered cp.async ring (rows padded to 68 floats, so
//   the fragment reads are conflict-free), 32 keys a step: S, the mask and
//   scale as attention_plain adds them, an online softmax in registers
//   (quad shuffles for the row max; the sum and P V rescaled when the max
//   moves), the keep multipliers from vlp::keep_frag, and P handed to P V
//   in registers through a permutation of the summed key index.  Steps
//   that the structural mask hides from all 16 rows (vlp::masked_region)
//   hold exact zeros of P and are skipped.  At B=16, L=512 it does 38.7
//   GFLOP of TF32 work (12.9 of fp32): 0.08 ms at 495 TFLOP/s, against
//   ~100 MB of bytes (0.03 ms).  It reaches a third of that (PERF.md):
//   every warp loads and splits each operand it reads, and the count of
//   shared-memory loads moved it where the split's arithmetic did not.
//
// What bounds it on an H100: at the VQA eval shape (B=256, L=128, H=12,
// D=64, bf16) one call reads q, k, v and writes out, ~201 MB (60 us at
// 3.35 TB/s), against 12.9 GFLOP (13 us at 989 TFLOP/s); at the decode
// prefill (B=100, L=103) ~63 MB (19 us); at the training shape (B=64,
// L=128) ~50 MB (15 us), plus L/4 Philox draws per row in the dropout
// branch.  So the L <= 128 body would be bound by bytes once its products
// run on the tensor cores and each tile is staged once with 16-byte
// copies; two blocks (2 x 56 KB of shared memory at L=128, at most 128
// registers a thread by the launch bounds) share an SM so that one
// block's loads overlap the other's math.  It reaches about half the HBM
// rate (PERF.md): a block's phases (stage, S, softmax, P V, store) run in
// turn, and 16 warps per SM do not hide all of their latency; the Philox
// draws (10 rounds of 32-bit multiplies per 4 columns) add ~40% in the
// dropout branch.  Past L = 128 the bytes stay linear in L (~0.06 ms at
// B=64, L=528) while the work grows with L^2: three L x L x 64 products
// (S twice, P V; up to 82 GFLOP at B=64, L=528: ~0.08 ms at 989
// TFLOP/s, ~0.2 ms at mma.sync's practical rate), two exponentials per
// visible entry and, in the dropout branch, one Philox4x32-10 per 4 of
// them (53.5 M at B=64, L=528; 10 rounds of four 32-bit multiplies on
// the half-rate integer pipe), so the long body should be bound by the
// issue of its per-entry instructions and products, not by bytes.  Blocks
// of 128 rows halve the re-reads of K and V from L2 against 64; two
// blocks of 8 warps (128 registers a thread by the launch bounds) run per
// SM (vlp_attention_fwd_blocks_per_sm; chip_smoke.py prints it).  It
// reaches none of those rates (PERF.md): each tile's phases (wait,
// barrier, S, softmax, P V) leave every pipe at a small share, and deeper
// rings, 4-warp blocks and 32-row warps timed no better.  Registers and
// spills: `-Xptxas -v` in the build log (chip_smoke.py prints it).
//
// Layout (bf16): L <= 128, grid = B*H, ceil(L/16) warps per block; past
// it, grid = (B*H, ceil(L/128)), 8 warps per block.  D is 64 (VLP's head)
// in every body and both layouts.
//
// MLA (Kimi-VL's and DeepSeek-V3's attention in its expanded training
// form): q and k of 192 columns a head (128 without position, 64 under
// RoPE) beside v of 128.  attention_fwd_mma is a template over (D_qk, D_v)
// and also instantiated at (192, 128): bf16, rate 0, blhd, L <= 128, its
// own entry point (vlp_attention_fwd_mla) with q/k strides apart from v's.
// Q, K and V of a head take 137,728 bytes of shared memory at L = 128 (one
// block an SM, so up to 255 registers a thread: S and O are 64 floats
// each); the (64, 64) instantiation is the code above, unchanged.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int D = vlp::kHeadDim;
using bf16 = __nv_bfloat16;  // the 16-bit element size below (fp16's too)

// ---- fp32: split TF32 on the tensor cores

constexpr int kF32Warps = 4;                 // 16 query rows each
constexpr int kF32Rows = 16 * kF32Warps;     // query rows a block owns
constexpr int kF32Tile = 64;                 // keys of a streamed tile
constexpr int kF32Half = 32;                 // keys of one step
constexpr int kF32TileElems = kF32Tile * vlp::kF32Stride;

__host__ __device__ int f32_tiles(int L) {
  return (L + kF32Tile - 1) / kF32Tile;
}

// A ring of two stages of one key tile of K and V, and the column bias of
// every key.  Q waits in stage 1's K slot until its fragments are loaded.
size_t smem_bytes_fp32(int L) {
  return sizeof(float) * (4 * size_t(kF32TileElems) + f32_tiles(L) * kF32Tile);
}

// Grid (example x head, 64 query rows): each warp owns 16 rows, their Q
// split into TF32 fragments in registers, and streams 64-key tiles of K
// and V, 32 keys a step: S = Q K^T (split TF32), the mask and scale, an
// online softmax in registers (quad shuffles for the row max; the running
// sum and P V rescaled when the max moves), the keep multipliers
// (vlp::keep_frag), then O += (P o keep) V with P handed over in registers
// (mma.cuh's k permutation); O / sum at the end.  Steps that the
// structural mask hides from the warp's rows (vlp::masked_region) hold
// exact zeros of P and are skipped.
template <bool kDrop>
__global__ void __launch_bounds__(kF32Warps * 32, 3)
    attention_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       const int* __restrict__ mode,
                       const int* __restrict__ text_end,
                       const float* __restrict__ colkeep, int L, int H,
                       vlp::Strides in, vlp::Strides os, int prefix,
                       float scale, vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) float smem_f[];
  float* ring = smem_f;                        // [2][K, V][64][kF32Stride]
  float* colbias = ring + 4 * kF32TileElems;   // [f32_tiles(L) * 64]
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kF32Rows;
  const int nk = f32_tiles(L);
  const long long in_base = b * in.b + h * in.h;
  float* sq = ring + 2 * kF32TileElems;
  vlp::stage_rows_f32(sq, q + in_base + q0 * in.l, in.l, L - q0, kF32Rows,
                      align);
  vlp::cp_async_commit();
  auto issue = [&](int kt) {
    float* dst = ring + (kt & 1) * 2 * kF32TileElems;
    const long long off = in_base + (long long)kt * kF32Tile * in.l;
    vlp::stage_rows_f32(dst, k + off, in.l, L - kt * kF32Tile, kF32Tile,
                        align);
    vlp::stage_rows_f32(dst + kF32TileElems, v + off, in.l,
                        L - kt * kF32Tile, kF32Tile, align);
    vlp::cp_async_commit();
  };
  issue(0);
  const float* ck = colkeep + (long long)b * L;
  for (int j = threadIdx.x; j < nk * kF32Tile; j += blockDim.x)
    colbias[j] = j >= L ? -CUDART_INF_F : ck[j] > 0.5f ? 0.f : vlp::kNegInf;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16, row = q0 + r0 + (lane >> 2);
  const int md = mode[b], te = text_end[b];
  const int first = vlp::first_kept(ck, L);
  const bool live = q0 + r0 < L;   // the same for the whole warp
  const int lim[2] = {vlp::row_limit(md, te, prefix, row),
                      vlp::row_limit(md, te, prefix, row + 8)};
  vlp::cp_async_wait<1>();   // Q
  __syncthreads();
  vlp::SplitFrag<4> fq[D / 8];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    fq[kk] = vlp::lds_a_f32(sq, r0, 8 * kk, lane);
  __syncthreads();   // stage 1 is free for key tile 1

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float o[D / 8][4] = {};
  const int j_lane = 2 * (lane & 3);
  for (int kt = 0; kt < nk; ++kt) {
    vlp::ring_next(kt, nk, issue);
    const float* sk = ring + (kt & 1) * 2 * kF32TileElems;
    const float* sv = sk + kF32TileElems;
    for (int c0 = 0; live && c0 < kF32Tile; c0 += kF32Half) {
      const int j0 = kt * kF32Tile + c0;
      // past L, or hidden from every row of the warp (and so is every
      // later key: masked_region is monotone)
      if (j0 >= L || vlp::masked_region(md, te, prefix, first, q0 + r0,
                                        q0 + r0 + 16, j0))
        break;
      float s[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          vlp::SplitFrag<2> fb[2];
          vlp::lds_b2_f32(fb, sk, c0 + 8 * n, 8 * kk, lane);
          vlp::mma_3xtf32(s[n], fq[kk], fb[0]);
          vlp::mma_3xtf32(s[n + 1], fq[kk], fb[1]);
        }
      // the masked, scaled scores (as attention_plain adds them); columns
      // past L are -inf and take no share of the softmax
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * n + j_lane + (e & 1);
          s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale),
                              vlp::mask_bias(colbias[j], j, lim[e >> 1]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float cm = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          cm = fmaxf(cm, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
        const float mn = fmaxf(m[hh], vlp::quad_max(cm));
        const float alpha = __expf(m[hh] - mn);   // 0 on the first step
        m[hh] = mn;
        l[hh] *= alpha;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[i][2 * hh] *= alpha;
          o[i][2 * hh + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        if (kDrop && j0 + 8 * n < L) {
          float mult[4];
          vlp::keep_frag(dp, b, h, row, j0 + 8 * n, lane, mult);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] *= mult[e];
        }
        vlp::mma_at_f32(o, vlp::frag_from_acc(p), sv, c0 + 8 * n, lane);
      }
    }
    __syncthreads();   // the next stage overwrites this one's K and V
  }
  if (!live) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / vlp::quad_sum(l[hh]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][2 * hh] *= inv;
      o[i][2 * hh + 1] *= inv;
    }
  }
  vlp::store_rows_f32(out + b * os.b + h * os.h + q0 * os.l, os.l, o, r0,
                      L - q0, lane, 1.f);
}

// ---- bf16 and fp16, L <= 128: on the tensor cores, a head a block

constexpr int kMaxWarps = 8;
constexpr int kChunk = 128;          // key columns a warp holds in registers
constexpr int kNT = kChunk / 8;      // n8 tiles of a chunk
using vlp::kLog2e;

// Q, K and V of the head and the column bias of kChunk keys.
template <int kDQ = D, int kDV = D>
size_t smem_bytes_mma(int Lp) {
  return size_t(Lp) *
             (2 * vlp::tile_stride<kDQ>() + vlp::tile_stride<kDV>()) *
             sizeof(bf16) +
         size_t(kChunk) * sizeof(float);
}

template <typename T>
struct FwdTiles {
  const T* q;  // [Lp][kTileStride] each, in shared memory
  const T* k;
  const T* v;
  const float* colbias;  // vlp::mask_bias's column bias, -inf past L
};

// s = the masked, scaled scores of query rows r0..r0+15 against key columns
// 0..127: a lane holds columns 8n + 2t (+1) of rows r0 + g
// (limit lim[0]) and r0 + g + 8 (lim[1]).  Columns past L are -inf, so
// they take no part in the max and sum.
template <typename T, int kDQ = D>
__device__ __forceinline__ void scores(float (&s)[kNT][4],
                                       const FwdTiles<T>& t,
                                       int r0, int Lp, int lane,
                                       const int (&lim)[2], float scale) {
  vlp::mma_abt<kNT, T, kDQ>(s, t.q, t.k, r0, 0, Lp, lane);
  const int j0 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 cb =
        *reinterpret_cast<const float2*>(t.colbias + j0 + n * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + n * 8 + (e & 1);
      const float bias = vlp::mask_bias(e & 1 ? cb.y : cb.x, j, lim[e >> 1]);
      s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), bias);
    }
  }
}

// The row max (h = 0: row g, 1: row g + 8) of s, over the quad.
__device__ __forceinline__ void row_max(const float (&s)[kNT][4],
                                        float (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      x = fmaxf(x, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    m[h] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  }
}

// s = exp(s - m) in place; returns the row sums over the quad.
__device__ __forceinline__ void exp_rows(float (&s)[kNT][4],
                                         const float (&m)[2],
                                         float (&sum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[n][e] = exp2f((s[n][e] - m[h]) * kLog2e);
        x += s[n][e];
      }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    sum[h] = x + __shfl_xor_sync(0xffffffffu, x, 2);
  }
}

// o += T(p o keep) V over key columns 0..127, p the normalized
// probabilities in s's layout.
template <typename T, bool kDrop, int kDV = D>
__device__ __forceinline__ void pv(float (&o)[kDV / 8][4], float (&p)[kNT][4],
                                   const FwdTiles<T>& t, int L, int Lp,
                                   int lane, int b, int h, int i0,
                                   const vlp::Dropout& dp) {
  if constexpr (kDrop) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n * 8 < L) {
        float mult[4];
        vlp::keep_frag(dp, b, h, i0, n * 8, lane, mult);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] *= mult[e];
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const int k0 = kk * 16;
    if (k0 >= Lp) continue;
    const uint32_t a[4] = {
        vlp::pack16<T>(p[2 * kk][0], p[2 * kk][1]),
        vlp::pack16<T>(p[2 * kk][2], p[2 * kk][3]),
        vlp::pack16<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        vlp::pack16<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < kDV / 16; ++np) {
      uint32_t bv[4];
      vlp::ldsm_x4_t(bv, t.v + (k0 + (lane & 15)) * vlp::tile_stride<kDV>() +
                             np * 16 + (lane >> 4) * 8);
      vlp::mma16<T>(o[2 * np], a, bv[0], bv[1]);
      vlp::mma16<T>(o[2 * np + 1], a, bv[2], bv[3]);
    }
  }
}

// L <= 128: one block per (example, head), one warp per 16-row tile, the
// whole key row in registers.  T: __nv_bfloat16 or __half; q and k of kDQ
// columns a head at strides `in`, v and out of kDV at `vin` and `os` (two
// blocks an SM at (64, 64), one at MLA's (192, 128)).
template <typename T, bool kDrop, int kDQ = D, int kDV = D>
__global__ void __launch_bounds__(kMaxWarps * 32, kDQ == D ? 2 : 1)
    attention_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const int* __restrict__ mode,
                      const int* __restrict__ text_end,
                      const float* __restrict__ colkeep, int L, int H,
                      vlp::Strides in, vlp::Strides vin, vlp::Strides os,
                      int prefix, float scale, vlp::DropoutArg dp_arg,
                      int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = (L + 15) & ~15;
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + Lp * vlp::tile_stride<kDQ>();
  T* sv = sk + Lp * vlp::tile_stride<kDQ>();
  float* colbias =
      reinterpret_cast<float*>(sv + Lp * vlp::tile_stride<kDV>());

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long in_base = b * in.b + h * in.h;
  vlp::stage_rows<T, kDQ>(sq, q + in_base, in.l, L, Lp, align);
  vlp::stage_rows<T, kDQ>(sk, k + in_base, in.l, L, Lp, align);
  vlp::cp_async_commit();
  vlp::stage_rows<T, kDV>(sv, v + b * vin.b + h * vin.h, vin.l, L, Lp,
                          align);
  vlp::cp_async_commit();
  for (int j = threadIdx.x; j < kChunk; j += blockDim.x)
    colbias[j] = j >= L ? -CUDART_INF_F
                 : colkeep[(long long)b * L + j] > 0.5f ? 0.f
                                                        : vlp::kNegInf;

  const FwdTiles<T> t{sq, sk, sv, colbias};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int md = mode[b], te = text_end[b];
  float s[kNT][4], m[2], sum[2];
  // S while V is still arriving
  vlp::cp_async_wait<1>();
  __syncthreads();
  const int r0 = warp * 16;
  const int lim[2] = {vlp::row_limit(md, te, prefix, r0 + g),
                      vlp::row_limit(md, te, prefix, r0 + g + 8)};
  scores<T, kDQ>(s, t, r0, Lp, lane, lim, scale);
  row_max(s, m);
  exp_rows(s, m, sum);
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= inv[e >> 1];
  vlp::cp_async_wait<0>();
  __syncthreads();
  float o[kDV / 8][4] = {};
  pv<T, kDrop, kDV>(o, s, t, L, Lp, lane, b, h, r0 + g, dp);
  vlp::store_rows(out + b * os.b + h * os.h, os.l, o, r0, L, lane, 1.f);
}

// ---- bf16 and fp16, L > 128: query-row blocks over streamed key tiles

constexpr int kRowWarps = 8;                // 16 query rows each
constexpr int kRows = 16 * kRowWarps;       // query rows a block owns
constexpr int kKeyTile = 64;                // keys of a streamed tile
constexpr int kKN = kKeyTile / 8;           // n8 tiles of a key tile
constexpr int kKeyElems = kKeyTile * vlp::kTileStride;
// the column bias covers every key of the longest L, so that the shared
// memory is the same at every L
constexpr int kBiasCols =
    (vlp::attention_fwd_max_len() + kKeyTile - 1) / kKeyTile * kKeyTile;
constexpr int kStages = 2;                  // key tiles in the ring
// Q's rows, the ring (K and V of a key tile a stage), and the column
// bias: 57,600 bytes at two stages
constexpr size_t kSmemBytesRows =
    sizeof(bf16) * (kRows + 2 * kStages * kKeyTile) * vlp::kTileStride +
    sizeof(float) * kBiasCols;

// s = the masked, scaled scores in log2 units (scale2 = scale * log2(e)) of
// a warp's 16 query rows (Q's A fragments fq) against the 64 keys of a
// staged tile sk whose first key is j0 (bias: the column bias from j0 on):
// a lane holds keys j0 + 8n + 2t (+1) of rows g (limit lim[0]) and g + 8
// (lim[1]).  Keys past L are -inf, so they take no part in the max and sum.
template <typename T>
__device__ __forceinline__ void tile_scores(float (&s)[kKN][4],
                                            const uint32_t (&fq)[D / 16][4],
                                            const T* sk, const float* bias,
                                            int j0, int lane,
                                            const int (&lim)[2],
                                            float scale2) {
#pragma unroll
  for (int n = 0; n < kKN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kKN / 2; ++np) {
      uint32_t fb[4];
      vlp::ldsm_x4(fb, sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                vlp::kTileStride +
                            kk * 16 + ((lane >> 3) & 1) * 8);
      vlp::mma16<T>(s[2 * np], fq[kk], fb[0], fb[1]);
      vlp::mma16<T>(s[2 * np + 1], fq[kk], fb[2], fb[3]);
    }
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kKN; ++n) {
    const float2 cb = *reinterpret_cast<const float2*>(bias + n * 8 + t2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = e & 1 ? cb.y : cb.x;
      s[n][e] = fmaf(s[n][e], scale2,
                     vlp::mask_bias2(c, j0 + n * 8 + t2 + (e & 1),
                                     lim[e >> 1]));
    }
  }
}

// Grid (example x head, 128 query rows), 8 warps of 16 rows, each warp's Q
// in A fragments in registers.  The key tiles that masked_region leaves
// visible to any of the block's rows are a prefix 0 .. nvis - 1 (it is
// monotone in the key); they stream through a kStages-deep cp.async ring
// (kStages - 1 tiles in flight, one barrier a tile) twice, K alone, then K
// and V:
//   pass 1: S per tile, the running row max m and sum l of exp(S - m) in
//     fp32, l rescaled when m moves (exact: nothing is rounded to T);
//   pass 2: S again, P = exp(S - m) / l in fp32, times the Philox keep
//     multipliers (vlp::keep_frag, the bits of keep_scale4), rounded to T
//     and handed to O += P V in registers (C fragments = A fragments).
// That is the TPU kernel's order of rounding: P normalized in fp32, times
// keep, then cast.  A warp skips each tile that masked_region hides from
// its own 16 rows (P is an exact 0 there), and in pass 2 the Philox draws
// of each 8-key slice hidden from them.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
    attention_fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int* __restrict__ mode,
                       const int* __restrict__ text_end,
                       const float* __restrict__ colkeep, int L, int H,
                       vlp::Strides in, vlp::Strides os, int prefix,
                       float scale, vlp::DropoutArg dp_arg, int align) {
  const vlp::Dropout dp = dp_arg.load();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);      // [128][kTileStride]
  T* ring = sq + kRows * vlp::kTileStride;  // [kStages][K, V][64][kTileStride]
  float* colbias = reinterpret_cast<float*>(ring + 2 * kStages * kKeyElems);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kRows;
  const long long in_base = b * in.b + h * in.h;
  const int md = mode[b], te = text_end[b];
  const float* ck = colkeep + (long long)b * L;
  const int first = vlp::first_kept(ck, L);
  const int nk = (L + kKeyTile - 1) / kKeyTile;
  int nvis = 1;   // key 0 is visible to every row
  while (nvis < nk && !vlp::masked_region(md, te, prefix, first, q0,
                                          q0 + kRows, nvis * kKeyTile))
    ++nvis;
  vlp::stage_rows(sq, q + in_base + q0 * in.l, in.l, min(kRows, L - q0),
                  kRows, align);
  vlp::cp_async_commit();
  // ring step i (stage i % kStages): key tile i (K) for i < nvis, then
  // tile i - nvis (K and V); past the last step an empty copy group, so
  // that every step waits for the same count of groups
  auto stage = [&](int i) { return ring + i % kStages * 2 * kKeyElems; };
  auto issue = [&](int i) {
    if (i < 2 * nvis) {
      const int kt = i < nvis ? i : i - nvis;
      const long long off = in_base + (long long)kt * kKeyTile * in.l;
      const int rows = min(kKeyTile, L - kt * kKeyTile);
      vlp::stage_rows(stage(i), k + off, in.l, rows, kKeyTile, align);
      if (i >= nvis)
        vlp::stage_rows(stage(i) + kKeyElems, v + off, in.l, rows, kKeyTile,
                        align);
    }
    vlp::cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int j = threadIdx.x; j < nvis * kKeyTile; j += blockDim.x)
    colbias[j] = vlp::colbias2(ck, j, L);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + warp * 16, row = r0 + (lane >> 2);
  const bool live = r0 < L;   // the same for the whole warp
  const int lim[2] = {vlp::row_limit(md, te, prefix, row),
                      vlp::row_limit(md, te, prefix, row + 8)};
  const float scale2 = scale * kLog2e;
  // the warp's rows see key j (or a later one) iff j < jend: masked_region
  // is monotone in the key, so its 8-key slices that are not hidden from
  // every row are a prefix (kept as one bound, not as the mask's terms)
  int jend = 0;
  while (live && jend < L &&
         !vlp::masked_region(md, te, prefix, first, r0, r0 + 16, jend))
    jend += 8;
  // step i's tile is in: wait for it, then refill the stage that step
  // i - 1 read (every warp is past it at the barrier)
  auto next = [&](int i) {
    vlp::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
  };
  vlp::cp_async_wait<kStages - 1>();   // Q
  __syncthreads();
  uint32_t fq[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    vlp::ldsm_x4(fq[kk], sq + (warp * 16 + (lane & 15)) * vlp::kTileStride +
                             kk * 16 + (lane >> 4) * 8);

  // pass 1: the row max and sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int i = 0; i < nvis; ++i) {
    next(i);
    const int j0 = i * kKeyTile;
    if (j0 < jend) {
      float s[kKN][4];
      tile_scores(s, fq, stage(i), colbias + j0, j0, lane, lim, scale2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < kKN; ++n)
          x = fmaxf(x, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
        const float mn = fmaxf(m[hh], vlp::quad_max(x));
        l[hh] *= vlp::ex2(m[hh] - mn);   // 0 on the first tile
        m[hh] = mn;
      }
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += vlp::ex2(s[n][e] - m[e >> 1]);
    }
  }
  const float inv[2] = {1.f / vlp::quad_sum(l[0]), 1.f / vlp::quad_sum(l[1])};

  // pass 2: S again, P, keep, rounding and P V
  float o[D / 8][4] = {};
  for (int i = nvis; i < 2 * nvis; ++i) {
    next(i);
    const int j0 = (i - nvis) * kKeyTile;
    const T* sk = stage(i);
    const T* sv = sk + kKeyElems;
    if (j0 < jend) {
      float p[kKN][4];
      tile_scores(p, fq, sk, colbias + j0, j0, lane, lim, scale2);
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = vlp::ex2(p[n][e] - m[e >> 1]) * inv[e >> 1];
        if (kDrop && j0 + n * 8 < jend) {
          float mult[4];
          vlp::keep_frag(dp, b, h, row, j0 + n * 8, lane, mult);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[n][e] *= mult[e];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKN / 2; ++kk) {
        const uint32_t a[4] = {vlp::pack16<T>(p[2 * kk][0], p[2 * kk][1]),
                               vlp::pack16<T>(p[2 * kk][2], p[2 * kk][3]),
                               vlp::pack16<T>(p[2 * kk + 1][0],
                                              p[2 * kk + 1][1]),
                               vlp::pack16<T>(p[2 * kk + 1][2],
                                              p[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bv[4];
          vlp::ldsm_x4_t(bv, sv + (kk * 16 + (lane & 15)) * vlp::kTileStride +
                                 np * 16 + (lane >> 4) * 8);
          vlp::mma16<T>(o[2 * np], a, bv[0], bv[1]);
          vlp::mma16<T>(o[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  if (live)
    vlp::store_rows(out + b * os.b + h * os.h + q0 * os.l, os.l, o,
                    warp * 16, L - q0, lane, 1.f);
}

template <bool kDrop>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                const int* mode, const int* text_end, const float* colkeep,
                int B, int L, int H, vlp::Strides in, vlp::Strides os,
                int prefix, float scale, vlp::DropoutArg dp,
                cudaStream_t stream) {
  if (L > vlp::attention_fwd_max_len()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes_fp32(L);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       4ull * in.b, 4ull * in.h, 4ull * in.l});
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_fp32<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (L + kF32Rows - 1) / kF32Rows);
  attention_fwd_fp32<kDrop><<<grid, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), mode, text_end,
      colkeep, L, H, in, os, prefix, scale, dp, align);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* mode, const int* text_end, const float* colkeep,
               int B, int L, int H, vlp::Strides in, vlp::Strides os,
               int prefix, float scale, vlp::DropoutArg dp,
               cudaStream_t stream) {
  if (L > vlp::attention_fwd_max_len()) return (int)cudaErrorInvalidValue;
  const int Lp = (L + 15) & ~15;
  const bool rows = Lp > kChunk;
  const size_t smem = rows ? kSmemBytesRows : smem_bytes_mma(Lp);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       2ull * in.b, 2ull * in.h, 2ull * in.l});
  const void* kernel =
      rows ? reinterpret_cast<const void*>(attention_fwd_rows<T, kDrop>)
           : reinterpret_cast<const void*>(attention_fwd_mma<T, kDrop>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, rows ? (L + kRows - 1) / kRows : 1);
  if (rows) {
    attention_fwd_rows<T, kDrop><<<grid, kRowWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), mode, text_end,
        colkeep, L, H, in, os, prefix, scale, dp, align);
  } else {
    attention_fwd_mma<T, kDrop><<<grid, Lp / 16 * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), mode, text_end,
        colkeep, L, H, in, in, os, prefix, scale, dp, align);
  }
  return (int)cudaGetLastError();
}

// MLA's (192, 128): bf16, rate 0, L <= 128, one block a head; q/k at
// strides `in`, v at `vin`, out at `os`.
int launch_mla(const void* q, const void* k, const void* v, void* out,
               const int* mode, const int* text_end, const float* colkeep,
               int B, int L, int H, vlp::Strides in, vlp::Strides vin,
               vlp::Strides os, int prefix, float scale,
               cudaStream_t stream) {
  constexpr int kDQ = vlp::kMlaQkDim, kDV = vlp::kMlaVDim;
  if (B <= 0 || L <= 0 || H <= 0 || L > kChunk)
    return (int)cudaErrorInvalidValue;
  const int Lp = (L + 15) & ~15;
  const size_t smem = smem_bytes_mma<kDQ, kDV>(Lp);
  const int align = vlp::common_alignment(
      {(unsigned long long)q, (unsigned long long)k, (unsigned long long)v,
       2ull * in.b, 2ull * in.h, 2ull * in.l, 2ull * vin.b, 2ull * vin.h,
       2ull * vin.l});
  auto kernel = attention_fwd_mma<bf16, false, kDQ, kDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, Lp / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), mode, text_end,
      colkeep, L, H, in, vin, os, prefix, scale,
      vlp::DropoutArg{nullptr, 0, 1.f}, align);
  return (int)cudaGetLastError();
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// bf16 body that length L runs, branch kDrop; -cudaError on a failure.
template <bool kDrop>
int blocks_per_sm(int L) {
  const int Lp = (L + 15) & ~15;
  const bool rows = Lp > kChunk;
  const size_t smem = rows ? kSmemBytesRows : smem_bytes_mma(Lp);
  const void* kernel =
      rows ? reinterpret_cast<const void*>(attention_fwd_rows<bf16, kDrop>)
           : reinterpret_cast<const void*>(attention_fwd_mma<bf16, kDrop>);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, rows ? kRowWarps * 32 : Lp / 16 * 32, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <bool kDrop>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const void* mode, const void* text_end, const void* colkeep,
             int B, int L, int H, vlp::Strides in, vlp::Strides os,
             int prefix, float scale, vlp::DropoutArg dp, int dtype,
             void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto md = static_cast<const int*>(mode);
  auto te = static_cast<const int*>(text_end);
  auto ck = static_cast<const float*>(colkeep);
  switch (dtype) {
    case vlp::kBFloat16:
      return launch_mma<bf16, kDrop>(q, k, v, out, md, te, ck, B, L, H, in,
                                     os, prefix, scale, dp, s);
    case vlp::kFloat16:
      return launch_mma<__half, kDrop>(q, k, v, out, md, te, ck, B, L, H, in,
                                       os, prefix, scale, dp, s);
    case vlp::kFloat32:
      return launch_fp32<kDrop>(q, k, v, out, md, te, ck, B, L, H, in, os,
                                prefix, scale, dp, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Both branches behind one entry: threshold 0 (rate 0) keeps every element
// with scale 1, which is the deterministic kernel.
int forward(const void* q, const void* k, const void* v, void* out,
            const void* mode, const void* text_end, const void* colkeep,
            int B, int L, int H, vlp::Strides in, vlp::Strides os, int prefix,
            float scale, vlp::DropoutArg dp, int dtype, void* stream) {
  if (dp.threshold == 0)
    return dispatch<false>(q, k, v, out, mode, text_end, colkeep, B, L, H, in,
                           os, prefix, scale, vlp::DropoutArg{nullptr, 0, 1.f},
                           dtype, stream);
  return dispatch<true>(q, k, v, out, mode, text_end, colkeep, B, L, H, in,
                        os, prefix, scale, dp, dtype, stream);
}

// blhd: q/k/v rows of H*D columns at strides (sb, sl); out contiguous
vlp::Strides blhd_in(long long sb, long long sl) { return {sb, D, sl}; }
vlp::Strides blhd_out(int L, int H) {
  return {(long long)L * H * D, D, (long long)H * D};
}
// bhld: out contiguous [B, H, L, D]
vlp::Strides bhld_out(int L, int H) {
  return {(long long)H * L * D, (long long)L * D, D};
}

}  // namespace

extern "C" {

// Both branches: q/k/v [B, L, H*64] with element strides sb (batch) and sl
// (row), the last dimension contiguous; out: contiguous [B, L, H*64].
// Attention-prob dropout is keyed on the 64-bit seed that seed points to
// in device memory (vlp::DropoutArg; threshold = uint32(rate * 2^32),
// keep_scale = 1 / (1 - rate)); threshold 0 is the deterministic kernel,
// and seed may then be null.  dtype (vlp::DType) selects the 16-bit
// tensor-core body in bf16 (1) or fp16 (2), or the fp32 body (0).  Returns
// cudaGetLastError() after the launch.
int vlp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      const void* mode, const void* text_end,
                      const void* colkeep, int B, int L, int H, long long sb,
                      long long sl, int prefix, float scale,
                      const void* seed, unsigned int threshold,
                      float keep_scale, int dtype, void* stream) {
  return forward(q, k, v, out, mode, text_end, colkeep, B, L, H,
                 blhd_in(sb, sl), blhd_out(L, H), prefix, scale,
                 vlp::dropout_arg(seed, threshold, keep_scale), dtype, stream);
}

// The bhld layout, both branches: q/k/v [B, H, L, 64] with element strides
// sb (batch), sh (head) and sl (row), the last dimension contiguous; out:
// contiguous [B, H, L, 64].  Otherwise as vlp_attention_fwd (the same
// multipliers for the same seed).
int vlp_attention_fwd_bhld(const void* q, const void* k, const void* v,
                           void* out, const void* mode, const void* text_end,
                           const void* colkeep, int B, int L, int H,
                           long long sb, long long sh, long long sl,
                           int prefix, float scale, const void* seed,
                           unsigned int threshold, float keep_scale,
                           int dtype, void* stream) {
  return forward(q, k, v, out, mode, text_end, colkeep, B, L, H,
                 vlp::Strides{sb, sh, sl}, bhld_out(L, H), prefix, scale,
                 vlp::dropout_arg(seed, threshold, keep_scale), dtype, stream);
}

// MLA (Kimi-VL's attention): q/k [B, L, H*192] with element strides sb,
// sl; v [B, L, H*128] with strides vsb, vsl; the last dimension contiguous
// in all three; out: contiguous [B, L, H*128].  bf16, no dropout, L <= 128;
// anything else returns cudaErrorInvalidValue.  Returns cudaGetLastError()
// after the launch.
int vlp_attention_fwd_mla(const void* q, const void* k, const void* v,
                          void* out, const void* mode, const void* text_end,
                          const void* colkeep, int B, int L, int H,
                          long long sb, long long sl, long long vsb,
                          long long vsl, int prefix, float scale,
                          void* stream) {
  constexpr long long DQ = vlp::kMlaQkDim, DV = vlp::kMlaVDim;
  return launch_mla(q, k, v, out, static_cast<const int*>(mode),
                    static_cast<const int*>(text_end),
                    static_cast<const float*>(colkeep), B, L, H,
                    vlp::Strides{sb, DQ, sl}, vlp::Strides{vsb, DV, vsl},
                    vlp::Strides{(long long)L * H * DV, DV, H * DV}, prefix,
                    scale, static_cast<cudaStream_t>(stream));
}

// Blocks per SM of the bf16 body that length L runs (drop: the dropout
// branch), from cudaOccupancyMaxActiveBlocksPerMultiprocessor; -cudaError
// on a failure.
int vlp_attention_fwd_blocks_per_sm(int L, int drop) {
  if (L <= 0 || L > vlp::attention_fwd_max_len())
    return -(int)cudaErrorInvalidValue;
  return drop ? blocks_per_sm<true>(L) : blocks_per_sm<false>(L);
}

}  // extern "C"
