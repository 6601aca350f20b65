// The attention-dropout multipliers, written out: [B, H, L, L] fp32, 0 or
// 1/(1-rate), from the same Philox draws that the forward and backward
// attention kernels make (common.cuh keep_scale4).
//
// Counterpart of the debug kernel mask_kernel in tests/test_tpu_dropout.py
// (:50), which dumps the TPU kernel's keep/scale mask.  It exists so that a
// check on the card can hold the kernels' bits against the plain version
// (vlp_tpu_torch/ops/philox.py) bit for bit; no training path calls it.
//
// What bounds it: the output, 4*B*H*L*L bytes (50 MB at B=64, H=12,
// L=128: ~15 us at 3.35 TB/s), and B*H*L*L/4 Philox calls (3.1 M there,
// ~20 integer multiplies each), which have to overlap the stores.  A 2-D
// grid: blockIdx.x is an (example, head, block of kRowsPerBlock rows),
// whose indices the block takes from one 32-bit division, and blockIdx.y a
// block of 128 columns.  Lane j of a warp owns the counter block 4j..4j+3
// of its 128 columns, and each thread draws kChains rows (warp w rows w,
// w + kWarps, ...) as independent Philox chains, so that their latencies
// overlap, before it stores them.  Where L % 4 == 0 a row is 16-byte
// aligned (out is) and a counter's four words are one 16-byte store, a
// warp's store covering 512 contiguous bytes; otherwise the words go one at
// a time.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kChains = 4;                         // rows a thread draws
constexpr int kRowsPerBlock = kWarps * kChains;    // rows of a block
constexpr int kColsPerBlock = 4 * 32;              // columns of a block

template <bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
    dropout_mask_kernel(float* __restrict__ out, int H, int L,
                        int row_blocks, vlp::DropoutArg dp_arg) {
  const vlp::Dropout dp = dp_arg.load();
  const int bh = blockIdx.x / row_blocks;  // b * H + h
  const int i0 = (blockIdx.x - bh * row_blocks) * kRowsPerBlock +
                 threadIdx.x / 32;
  const int h = bh % H, b = bh / H;
  const int jblk = blockIdx.y * 32 + threadIdx.x % 32;  // columns 4 jblk ..
  if (4 * jblk >= L) return;
  uint4 w[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c)  // rows past L draw too, unstored
    w[c] = vlp::philox4x32_10(
        make_uint4((unsigned)jblk, (unsigned)(i0 + kWarps * c), (unsigned)h,
                   (unsigned)b),
        dp.seed);
  float* base = out + (long long)bh * L * L + 4 * jblk;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const int i = i0 + kWarps * c;
    if (i >= L) break;
    const float m[4] = {w[c].x >= dp.threshold ? dp.scale : 0.f,
                        w[c].y >= dp.threshold ? dp.scale : 0.f,
                        w[c].z >= dp.threshold ? dp.scale : 0.f,
                        w[c].w >= dp.threshold ? dp.scale : 0.f};
    float* o = base + (long long)i * L;
    if constexpr (kAligned) {
      *reinterpret_cast<float4*>(o) = make_float4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * jblk + t < L) o[t] = m[t];
    }
  }
}

}  // namespace

extern "C" {

// out: contiguous fp32 [B, H, L, L]; seed points to the 64-bit seed in
// device memory, as the attention kernels take it (vlp::DropoutArg).
// Returns cudaGetLastError().
int vlp_dropout_mask(void* out, int B, int H, int L, const void* seed,
                     unsigned int threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int row_blocks = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long grid_x = (long long)B * H * row_blocks;
  const int grid_y = (L + kColsPerBlock - 1) / kColsPerBlock;
  if (grid_x >= (1LL << 31) || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const vlp::DropoutArg dp = vlp::dropout_arg(seed, threshold, keep_scale);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L % 4 == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0)
    dropout_mask_kernel<true><<<grid, kWarps * 32, 0, s>>>(o, H, L,
                                                           row_blocks, dp);
  else
    dropout_mask_kernel<false><<<grid, kWarps * 32, 0, s>>>(o, H, L,
                                                            row_blocks, dp);
  return (int)cudaGetLastError();
}

}  // extern "C"
