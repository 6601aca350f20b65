// K6: the attention-dropout multipliers that the decode kernel's dropout
// branch (K5, decode_attention.cu) applied during an SCST sampled rollout,
// written out for the teacher-forced replay.
//
// Replaces the TPU kernel vlp_tpu/ops/decode_attention.py:_regen_kernel
// (:237), called from decode_dropout_scales (:247, :279).  out is fp32
// [N, H, S, P+G] with N = W*B rows n = t*B + b (decode step t, example b):
// element (n, h, s, c) is 0 or 1/(1-rate), from Philox under seeds[t] with
// the counter (c/4, s, h, b) -- K5's draw of query row s, column c of the
// joint (prompt | generated) axis in step t.  One seed per decode step (of
// one layer) keys the draws; the example is in the counter, so the TPU
// kernel's per-example 31-bit seeds and its 128-lane padding have no
// counterpart here.  The W seeds travel in the kernel's parameters, so a
// call copies nothing to the device first.
//
// What bounds it: the output, 4*N*H*S*(P+G) bytes (14.7 MB a layer at the
// SCST shape W=19, B=64, H=12, S=2, P+G=126: ~4.4 us at 3.35 TB/s), and
// N*H*S*ceil((P+G)/4) Philox calls (~0.93 M there, ~40 integer multiplies
// each: ~2.5-3 us of the SMs' multiply rate), so the stores and the
// arithmetic have to overlap.  A row of 126 floats is only 8-byte aligned,
// so a lane that writes its own block of four columns covers 512 bytes with
// a warp's store to write 128.  Instead a persistent grid (whole waves,
// from the occupancy) splits the rows into one contiguous range per block,
// cut at multiples of `unit` rows (unit * cols floats is a whole number of
// 16-byte words).  The block walks its range in segments of kSegRows
// rows, each starting 16-byte aligned: each warp draws kRowsPerWarp rows'
// multipliers (independent Philox chains, so that their latencies
// overlap) into a shared-memory buffer, then the block writes the segment
// as one contiguous run of 16-byte stores, neighbouring lanes on
// neighbouring addresses, and draws the next segment into the other
// buffer while those drain.  A warp's row indices (s, h, b, t) advance by
// mixed-radix addition: no division per row.

#include "common.cuh"

namespace {

constexpr int kMaxSteps = 128;  // decode steps of one call (W = T - 1)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;  // rows a warp draws at once
constexpr int kSegRows = kWarps * kRowsPerWarp;  // rows of a segment

struct Seeds {
  unsigned long long s[kMaxSteps];
};

// Row ((t*B + b)*H + h)*S + s of the output as its digits.
struct RowIdx {
  int s, h, b, t;
};

// (32-bit divisions, once per thread: a 64-bit one costs more than the
// rest of a thread's work.)
__host__ __device__ __forceinline__ RowIdx split(int row, int S, int H,
                                                 int B) {
  RowIdx x;
  x.s = row % S;
  row /= S;
  x.h = row % H;
  row /= H;
  x.b = row % B;
  x.t = row / B;
  return x;
}

// x += d, digit by digit with carries (every digit of x and d below its
// radix).
__device__ __forceinline__ void advance(RowIdx& x, const RowIdx& d, int S,
                                        int H, int B) {
  x.s += d.s;
  int c = x.s >= S;
  x.s -= c ? S : 0;
  x.h += d.h + c;
  c = x.h >= H;
  x.h -= c ? H : 0;
  x.b += d.b + c;
  c = x.b >= B;
  x.b -= c ? B : 0;
  x.t += d.t + c;
}

__global__ void __launch_bounds__(kThreads)
    decode_dropout_kernel(float* __restrict__ out, const Seeds seeds, int B,
                          int H, int S, int cols, int rows, int unit,
                          int per_block, int extra, RowIdx step,
                          unsigned int threshold, float scale) {
  extern __shared__ __align__(16) float seg[];  // [2][kSegRows][cols]
  // this block's units: per_block of them, one more for the first `extra`
  const int blk = blockIdx.x;
  const int u_begin = blk * per_block + min(blk, extra);
  const int r_begin = min(rows, u_begin * unit);
  const int r_end = min(rows, (u_begin + per_block + (blk < extra)) * unit);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nblk = (cols + 3) / 4;
  // warp w draws rows w + kWarps * rr of each segment, kRowsPerWarp
  // independent Philox chains a lane
  RowIdx x[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
    x[rr] = split(r_begin + warp + kWarps * rr, S, H, B);
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kSegRows, buf ^= 1) {
    float* sg = seg + buf * kSegRows * cols;
    for (int c = lane; c < nblk; c += 32) {
      float mult[kRowsPerWarp][4];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        // rows past r_end draw too (their step index clamped) and are not
        // stored: the chains stay branch-free
        const vlp::Dropout dp{seeds.s[min(x[rr].t, kMaxSteps - 1)],
                              threshold, scale};
        vlp::keep_scale4(dp, x[rr].b, x[rr].h, x[rr].s, c, mult[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (r0 + warp + kWarps * rr >= r_end) continue;
        float* row = sg + (warp + kWarps * rr) * cols;
        // word w at column 4c + w; the four stores rotated by c / 8, so
        // that each falls in 32 distinct banks
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int w = (k + (c >> 3)) & 3;
          const float m = w == 0   ? mult[rr][0]
                          : w == 1 ? mult[rr][1]
                          : w == 2 ? mult[rr][2]
                                   : mult[rr][3];
          if (4 * c + w < cols) row[4 * c + w] = m;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) advance(x[rr], step, S, H, B);
    __syncthreads();   // also: the other buffer's stores were issued
    // rows r0 .. r0 + kSegRows - 1 are contiguous in out, starting 16-byte
    // aligned; a tail of n % 4 floats exists only at the end of out
    const int n = min(kSegRows, r_end - r0) * cols;
    float* dst = out + (long long)r0 * cols;
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(sg)[i];
    for (int i = (n & ~3) + threadIdx.x; i < n; i += kThreads) dst[i] = sg[i];
  }
}

}  // namespace

extern "C" {

// out: contiguous fp32 [W*B, H, S, cols] (cols = P + G), 16-byte aligned;
// seeds: W 64-bit seeds in host memory, one per decode step, W <= 128.
// Returns cudaGetLastError().
int vlp_decode_dropout_scales(void* out, const void* seeds, int W, int B,
                              int H, int S, int cols, unsigned int threshold,
                              float keep_scale, void* stream) {
  const long long rows = (long long)W * B * H * S;
  const size_t smem = sizeof(float) * 2 * kSegRows * (size_t)cols;
  if (W <= 0 || W > kMaxSteps || B <= 0 || H <= 0 || S <= 0 || cols <= 0 ||
      threshold == 0 || rows >= (1LL << 31) - 4 ||
      smem > (size_t)vlp::kMaxSmemBytes ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Seeds sd{};
  const auto* src = static_cast<const unsigned long long*>(seeds);
  for (int t = 0; t < W; ++t) sd.s[t] = src[t];
  cudaError_t err = cudaFuncSetAttribute(
      decode_dropout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_dropout_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  // unit rows of cols floats fill whole 16-byte words
  const int unit = cols % 4 == 0 ? 1 : cols % 2 == 0 ? 2 : 4;
  const int units = (int)((rows + unit - 1) / unit);
  const long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(grid < units ? grid : units);
  decode_dropout_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), sd, B, H, S, cols, (int)rows, unit,
      units / blocks, units % blocks, split(kSegRows, S, H, B), threshold,
      keep_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
