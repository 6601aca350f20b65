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
// L=128, ~15 us at 3.35 TB/s).  One thread per Philox counter writes its
// four columns, neighbouring threads neighbouring columns.

#include "common.cuh"

namespace {

__global__ void dropout_mask_kernel(float* __restrict__ out, int B, int H,
                                    int L, vlp::Dropout dp) {
  const int nblk = (L + 3) / 4;
  const long long n = (long long)B * H * L * nblk;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % nblk);
    const long long row = idx / nblk;  // (b * H + h) * L + i
    const int i = (int)(row % L);
    const int h = (int)((row / L) % H);
    const int b = (int)(row / ((long long)L * H));
    float mult[4];
    vlp::keep_scale4(dp, b, h, i, c, mult);
    float* o = out + row * L + 4 * c;
    for (int w = 0; w < 4 && 4 * c + w < L; ++w) o[w] = mult[w];
  }
}

}  // namespace

extern "C" {

// out: contiguous fp32 [B, H, L, L].  Returns cudaGetLastError().
int vlp_dropout_mask(void* out, int B, int H, int L, unsigned long long seed,
                     unsigned int threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * L * ((L + 3) / 4);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 16 ? want : 65535 * 16);
  dropout_mask_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), B, H, L,
      vlp::Dropout{seed, threshold, keep_scale});
  return (int)cudaGetLastError();
}

}  // extern "C"
