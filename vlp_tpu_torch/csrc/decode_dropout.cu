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
// N*H*S*ceil((P+G)/4) Philox calls.  A block serves kRows rows of the
// output; in each, lane c draws counter c and writes its (up to) four
// columns, so neighbouring lanes write neighbouring columns and the index
// arithmetic is one 32-bit division chain per row.

#include "common.cuh"

namespace {

constexpr int kMaxSteps = 128;  // decode steps of one call (W = T - 1)
constexpr int kRows = 8;        // output rows per block

struct Seeds {
  unsigned long long s[kMaxSteps];
};

__global__ void __launch_bounds__(32 * kRows)
    decode_dropout_kernel(float* __restrict__ out, const Seeds seeds, int B,
                          int H, int S, int cols, int rows,
                          unsigned int threshold, float scale) {
  const int row = blockIdx.x * kRows + threadIdx.y;  // ((t*B + b)*H + h)*S + s
  if (row >= rows) return;
  const int s = row % S;
  const int h = (row / S) % H;
  const int n = row / (S * H);
  const vlp::Dropout dp{seeds.s[n / B], threshold, scale};
  float* o = out + (long long)row * cols;
  for (int c = threadIdx.x; 4 * c < cols; c += 32) {
    float mult[4];
    vlp::keep_scale4(dp, n % B, h, s, c, mult);
    for (int w = 0; w < 4 && 4 * c + w < cols; ++w) o[4 * c + w] = mult[w];
  }
}

}  // namespace

extern "C" {

// out: contiguous fp32 [W*B, H, S, cols] (cols = P + G); seeds: W 64-bit
// seeds in host memory, one per decode step, W <= 128.  Returns
// cudaGetLastError().
int vlp_decode_dropout_scales(void* out, const void* seeds, int W, int B,
                              int H, int S, int cols, unsigned int threshold,
                              float keep_scale, void* stream) {
  const long long rows = (long long)W * B * H * S;
  if (W <= 0 || W > kMaxSteps || B <= 0 || H <= 0 || S <= 0 || cols <= 0 ||
      threshold == 0 || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Seeds sd{};
  const auto* src = static_cast<const unsigned long long*>(seeds);
  for (int t = 0; t < W; ++t) sd.s[t] = src[t];
  const dim3 block(32, kRows);
  const int blocks = (int)((rows + kRows - 1) / kRows);
  decode_dropout_kernel<<<blocks, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), sd, B, H, S, cols, (int)rows, threshold,
      keep_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
