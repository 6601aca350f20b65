// BertAdam's update over every parameter of a model in two launches: the
// CUDA form of vlp_tpu_torch/optim.py BertAdam._update (the reference's
// optimization.py:33-182), which stays beside it as the plain version.
//
// It replaces no TPU kernel: the JAX package leaves BertAdam to XLA, which
// fuses the update's elementwise work by itself (vlp_tpu/optim.py).  Eager
// PyTorch does not, and spends ~24 launches on each of a model's ~210
// parameter tensors, which is why this kernel was added.
//
// What bounds it: device bytes.  A tensor's clip norm has to be complete
// before any of its elements is updated, and the largest gradient, the word
// table (28,996 x 768 fp32, 89 MB), does not fit the 50 MB L2, so the norm
// pass cannot be fused into the update: the least traffic is one read of g
// for the norms, then a read of g, p, m and v and a write of p, m and v.
// That is 32 bytes an element (36 with fine-tune anchors): 3.71 GB (1.11 ms
// at 3.35 TB/s) for the 115.9 M parameters of VLP's captioning model and
// 3.90 GB (1.16 ms) for the 121.9 M of its VQA model.  The launches are
// the other cost: two, for any number of tensors.
//
// The design:
// * A plan built on the host (optim.py FusedPlan): the parameters cut into
//   chunks of `chunk` elements (a tensor's last may be shorter), a map from
//   chunk to tensor, and a table of tensors (the pointers of p, its
//   gradient, m, v and the optional anchor, its first chunk, its length,
//   its decay flag), uploaded only when a pointer changes.  A null
//   gradient reads as zero.  The device holds 4 + 8 bytes a chunk and 64 a
//   tensor: ~106 KB for VLP's parameters at 16,384-element chunks.
// * Pass 1 (bert_adam_norms_kernel): a block per chunk sums the squares of
//   its gradient in fp64 with a fixed element-to-thread mapping and a fixed
//   reduction tree; the last block of a tensor to finish (an integer
//   ticket) sums that tensor's partials in chunk order.  No float atomics:
//   the sums do not depend on the schedule, so runs agree bit for bit.
//   Between the two passes the caller may sum-all-reduce a leading slice of
//   the squared norms (tensor-parallel shards).
// * Pass 2 (bert_adam_update_kernel): persistent blocks walk the chunk
//   table with 16-byte vectors (a scalar tail where a tensor's length is
//   not a multiple of 4, scalars where a pointer is not 16-byte aligned).
//   The clip scale, the learning rate and the optional overflow flag are
//   read from device memory, so nothing is read on the host and the launch
//   can be captured in a CUDA graph.  Where the flag is false nothing is
//   written and the step count stays; otherwise it advances by one.
// * The arithmetic is _update's, op for op, with the _rn intrinsics (never
//   contracted to FMAs): an element of a tensor that is not clipped gets the
//   plain update's bits; a clipped one differs only through its norm, whose
//   sum is taken in another order (and in fp64).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One row of the tensor table: 8 int64 columns (optim.py TABLE_COLUMNS).
struct TensorRow {
  float* p;
  const float* g;       // null: no gradient, read as zero
  float* m;
  float* v;
  const float* a;       // null: decay toward zero (no fine-tune anchor)
  long long chunk_begin;   // its first chunk
  long long numel;
  long long decay;      // 1 where weight decay applies
};
static_assert(sizeof(TensorRow) == 64, "the tensor table has 8 columns");

// Chunk c of the tensor of row `row`: its first element and its length.
struct Chunk {
  long long start;
  int len;
};

__device__ __forceinline__ Chunk chunk_of(const TensorRow& row, int c,
                                          int chunk) {
  const long long start = (long long)(c - row.chunk_begin) * chunk;
  const long long left = row.numel - start;
  return {start, (int)(left < chunk ? left : chunk)};
}

struct Hyper {
  float b1, c1, b2, c2, eps;   // B1, 1 - B1, B2, 1 - B2, EPS as fp32
  float max_norm, clip_eps;    // MAX_GRAD_NORM, CLIP_EPS
  float weight_decay;
  int decay_on;                // _update's weight_decay > 0
};

__device__ __forceinline__ bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// The block's sum of x in a fixed tree; thread 0 gets it.
__device__ __forceinline__ double block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // red is free (a previous call has read it)
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

__device__ __forceinline__ double sq(float x) {
  return (double)x * (double)x;   // exact in fp64
}

__global__ void __launch_bounds__(kThreads)
    bert_adam_norms_kernel(const TensorRow* __restrict__ rows,
                           const int* __restrict__ owner, int chunk,
                           double* __restrict__ partials,
                           unsigned int* __restrict__ tickets,
                           float* __restrict__ sumsq) {
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  const int t = owner[blockIdx.x];
  const TensorRow row = rows[t];
  const Chunk ck = chunk_of(row, blockIdx.x, chunk);
  const int n_chunks = (int)((row.numel + chunk - 1) / chunk);
  double acc = 0.0;
  if (row.g != nullptr) {
    const float* g = row.g + ck.start;
    const int n = ck.len;
    int i = threadIdx.x;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (; i < n / 4; i += kThreads) {
        const float4 x = g4[i];
        acc += sq(x.x);
        acc += sq(x.y);
        acc += sq(x.z);
        acc += sq(x.w);
      }
      i = n / 4 * 4 + threadIdx.x;
    }
    for (; i < n; i += kThreads) acc += sq(g[i]);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();   // the partial is visible before the ticket
    last = atomicAdd(&tickets[t], 1u) == (unsigned int)(n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the tensor's last block: its partials in chunk order (read past L1)
  double s = 0.0;
  for (int k = threadIdx.x; k < n_chunks; k += kThreads)
    s += __ldcg(partials + row.chunk_begin + k);
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    sumsq[t] = __double2float_rn(s);
    tickets[t] = 0;   // ready for the next launch
  }
}

// One element of _update: p, m and v in place.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const float* a, float anchor,
                                     float scale, float wd, float neg_lr,
                                     const Hyper& h) {
  g = __fmul_rn(g, scale);                                   // the clip
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), h.eps));
  if (h.decay_on) {
    const float base = a == nullptr ? p
                                    : __fsub_rn(__fmul_rn(p, 2.0f), anchor);
    u = __fadd_rn(u, __fmul_rn(base, wd));
  }
  p = __fadd_rn(p, __fmul_rn(neg_lr, u));
}

__global__ void __launch_bounds__(kThreads)
    bert_adam_update_kernel(const TensorRow* __restrict__ rows,
                            const int* __restrict__ owner, int n_chunks,
                            int chunk, const float* __restrict__ sumsq,
                            const float* __restrict__ lr,
                            const unsigned char* __restrict__ finite,
                            long long* __restrict__ step_count, Hyper h) {
  const bool go = finite == nullptr || *finite != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && go) *step_count += 1;
  if (!go) return;
  const float neg_lr = -*lr;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = owner[c];
    const TensorRow row = rows[t];
    const Chunk ck = chunk_of(row, c, chunk);
    // _clip: scale = MAX_GRAD_NORM * (1 / (norm + 1e-6)) where norm > 1
    const float norm = __fsqrt_rn(sumsq[t]);
    const float scale =
        norm > h.max_norm
            ? __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(norm, h.clip_eps)),
                        h.max_norm)
            : 1.0f;
    const float wd = row.decay ? h.weight_decay : 0.0f;
    float* p = row.p + ck.start;
    float* m = row.m + ck.start;
    float* v = row.v + ck.start;
    const float* g = row.g == nullptr ? nullptr : row.g + ck.start;
    const float* a = row.a == nullptr ? nullptr : row.a + ck.start;
    const int n = ck.len;
    int i = threadIdx.x;
    if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g) &&
        aligned16(a)) {
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (; i < n / 4; i += kThreads) {
        float4 pp = p4[i], mm = m4[i], vv = v4[i];
        const float4 gg = g == nullptr
                              ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : reinterpret_cast<const float4*>(g)[i];
        const float4 aa = a == nullptr
                              ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : reinterpret_cast<const float4*>(a)[i];
        adam(pp.x, gg.x, mm.x, vv.x, a, aa.x, scale, wd, neg_lr, h);
        adam(pp.y, gg.y, mm.y, vv.y, a, aa.y, scale, wd, neg_lr, h);
        adam(pp.z, gg.z, mm.z, vv.z, a, aa.z, scale, wd, neg_lr, h);
        adam(pp.w, gg.w, mm.w, vv.w, a, aa.w, scale, wd, neg_lr, h);
        p4[i] = pp;
        m4[i] = mm;
        v4[i] = vv;
      }
      i = n / 4 * 4 + threadIdx.x;
    }
    for (; i < n; i += kThreads) {
      float pp = p[i], mm = m[i], vv = v[i];
      adam(pp, g == nullptr ? 0.f : g[i], mm, vv, a,
           a == nullptr ? 0.f : a[i], scale, wd, neg_lr, h);
      p[i] = pp;
      m[i] = mm;
      v[i] = vv;
    }
  }
}

}  // namespace

extern "C" {

// Blocks of the update's persistent grid on the current device: every SM
// full.  Returns the count, or the negated cudaError_t.
int vlp_bert_adam_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, bert_adam_update_kernel, kThreads, 0)) != cudaSuccess)
    return -(int)err;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Pass 1.  rows: device [n_tensors] TensorRow; owner: device int32
// [n_chunks], each chunk's tensor; chunk: elements a chunk, a multiple of 4;
// partials: fp64 [n_chunks]; tickets: uint32 [n_tensors], zero (each launch
// leaves them zero); sumsq: fp32 [n_tensors], each tensor's squared
// gradient norm (a tensor without chunks keeps its value).
// Returns cudaGetLastError().
int vlp_bert_adam_norms(const void* rows, const void* owner, int n_chunks,
                        int chunk, void* partials, void* tickets, void* sumsq,
                        void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  bert_adam_norms_kernel<<<n_chunks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorRow*>(rows), static_cast<const int*>(owner),
      chunk, static_cast<double*>(partials),
      static_cast<unsigned int*>(tickets),
      static_cast<float*>(sumsq));
  return (int)cudaGetLastError();
}

// Pass 2.  sumsq: pass 1's (after any all-reduce); lr: the fp32 learning
// rate of this update; finite: a bool, or null (always update); step_count:
// int64, advanced by one where the update is made; decay_on: whether
// weight decay applies at all; blocks: the persistent grid
// (vlp_bert_adam_blocks).  Returns cudaGetLastError().
int vlp_bert_adam_update(const void* rows, const void* owner, int n_chunks,
                         int chunk, const void* sumsq, const void* lr,
                         const void* finite,
                         void* step_count, float b1, float c1, float b2,
                         float c2, float eps, float max_norm, float clip_eps,
                         float weight_decay, int decay_on, int blocks,
                         void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % 4 != 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, c1, b2, c2, eps, max_norm, clip_eps, weight_decay,
                decay_on};
  bert_adam_update_kernel<<<blocks < n_chunks ? blocks : n_chunks, kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorRow*>(rows), static_cast<const int*>(owner),
      n_chunks, chunk, static_cast<const float*>(sumsq),
      static_cast<const float*>(lr),
      static_cast<const unsigned char*>(finite),
      static_cast<long long*>(step_count), h);
  return (int)cudaGetLastError();
}

}  // extern "C"
