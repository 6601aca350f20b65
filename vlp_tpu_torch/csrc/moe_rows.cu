// The row passes of Kimi-VL's expert layer (vlp_tpu_torch/models/kimi_vl.py)
// around its two grouped products: the gather of each held (token, expert)
// pair's token row into the sorted row buffer, the SwiGLU between the
// products, and the weighted combine of the rows back to their tokens, each
// with its backward.  The plain versions are ops/moe_rows.py's *_plain
// functions.
//
// They replace no TPU kernel: the JAX package has no expert layer.  They
// were added because the layer's row buffer is sized for the most pairs a
// layer can hold (tokens x min(top-k, held): 98,304 rows at the Kimi cell's
// 16,384 tokens), while the held experts take ~1/8 of them, and PyTorch's
// elementwise passes (masks, SiLU, the weighting, index_select) each cover
// the whole buffer.
//
// What bounds them: device bytes.  Each reads its inputs and writes its
// outputs once, and only the rows below the held-row count: the count is
// offs[n-1], the end of the last held expert's rows, read from device memory
// by every block, so nothing is read on the host and a CUDA graph captures
// the launches.  Grids are sized for the worst case; the row kernels walk
// (row, 16-byte vector) pairs in a grid-stride loop that stops at
// count x vectors a row, four loads in flight a thread; the token kernels
// give each token to one block, which loads all of a token's picks at once
// and skips those whose row is at or past the count.  Rows past the count
// are neither read nor written (their contents stay undefined).
//
// Sums are taken in fp32 in a fixed order (a token's picks j = 0..k-1, the
// base last; the combine's dot products in a fixed tree of lanes and warps)
// and rounded once, with no atomics: every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte vectors in flight a thread
constexpr int kMaxTopK = 8;     // ops/moe_rows.py MAX_TOPK

// 16 bytes of Elem as fp32 values, and back (rounded to nearest even).
template <typename Elem>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static unsigned pair(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

// The held-row count: the end of the last held expert's rows.
__device__ __forceinline__ long long held_count(const int* offs, int n) {
  return (long long)__ldg(offs + n - 1);
}

// --- the row kernels: rows [0, count) of the buffer ---------------------

// out[r] = x[order[r] / k] for r < count; vpr 16-byte vectors a row.
__global__ void __launch_bounds__(kThreads)
    moe_gather_kernel(const uint4* __restrict__ x,
                      const long long* __restrict__ order,
                      const int* __restrict__ offs, int n,
                      uint4* __restrict__ out, int vpr, int k) {
  const long long total = held_count(offs, n) * vpr;
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long v0 = (long long)blockIdx.x * kThreads * kUnroll
                      + threadIdx.x;
       v0 < total; v0 += stride) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) {
        const long long r = v / vpr;
        const long long t = __ldg(order + r) / k;
        buf[u] = __ldg(x + t * vpr + (v - r * vpr));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) out[v] = buf[u];
    }
  }
}

__device__ __forceinline__ float sigmoid_of(float g) {
  return 1.0f / (1.0f + expf(-g));
}

// h[r] = silu(g[r]) * u[r], gu[r] = [g | u] (2 vpr vectors), r < count.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_kernel(const uint4* __restrict__ gu,
                      const int* __restrict__ offs, int n,
                      uint4* __restrict__ h, int vpr) {
  using P = Pack<Elem>;
  const long long total = held_count(offs, n) * vpr;
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long v0 = (long long)blockIdx.x * kThreads * kUnroll
                      + threadIdx.x;
       v0 < total; v0 += stride) {
    uint4 gv[kUnroll], uv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) {
        const long long r = v / vpr;
        const long long at = v + r * vpr;   // row r's g vector v - r vpr
        gv[u] = __ldg(gu + at);
        uv[u] = __ldg(gu + at + vpr);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) {
        float g[P::N], up[P::N];
        P::unpack(gv[u], g);
        P::unpack(uv[u], up);
#pragma unroll
        for (int e = 0; e < P::N; ++e)
          g[e] = g[e] * sigmoid_of(g[e]) * up[e];
        h[v] = P::pack(g);
      }
    }
  }
}

// dgu[r] = [dh u silu'(g) | dh silu(g)] for r < count.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_bwd_kernel(const uint4* __restrict__ dh,
                          const uint4* __restrict__ gu,
                          const int* __restrict__ offs, int n,
                          uint4* __restrict__ dgu, int vpr) {
  using P = Pack<Elem>;
  const long long total = held_count(offs, n) * vpr;
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long v0 = (long long)blockIdx.x * kThreads * kUnroll
                      + threadIdx.x;
       v0 < total; v0 += stride) {
    uint4 dv[kUnroll], gv[kUnroll], uv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) {
        const long long at = v + (v / vpr) * vpr;
        dv[u] = __ldg(dh + v);
        gv[u] = __ldg(gu + at);
        uv[u] = __ldg(gu + at + vpr);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < total) {
        float d[P::N], g[P::N], up[P::N];
        P::unpack(dv[u], d);
        P::unpack(gv[u], g);
        P::unpack(uv[u], up);
#pragma unroll
        for (int e = 0; e < P::N; ++e) {
          const float s = sigmoid_of(g[e]);
          const float silu = g[e] * s;
          g[e] = d[e] * up[e] * (s * (1.0f + g[e] * (1.0f - s)));
          up[e] = d[e] * silu;
        }
        const long long at = v + (v / vpr) * vpr;
        dgu[at] = P::pack(g);
        dgu[at + vpr] = P::pack(up);
      }
    }
  }
}

// --- the token kernels: a block a token (grid-stride) ------------------

// A token's picks: each one's row (count where k <= j: never held) and
// scale, every load issued at once (the loops unroll over kMaxTopK).
struct Picks {
  long long row[kMaxTopK];
  float scale[kMaxTopK];
};

__device__ __forceinline__ Picks picks_of(const long long* row_of,
                                          const float* w, long long t, int k,
                                          long long count) {
  Picks p;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    p.row[j] = j < k ? __ldg(row_of + t * k + j) : count;
    p.scale[j] = j < k && w ? __ldg(w + t * k + j) : 1.0f;
  }
  return p;
}

// out[t] = sum_j [row_of[t k + j] < count] scale_j rows[row_of[t k + j]]
// (+ base[t]), scale_j = w[t k + j], or 1 without w; fp32, rounded once.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
    moe_sum_picks_kernel(const uint4* __restrict__ rows,
                         const float* __restrict__ w,
                         const uint4* __restrict__ base,
                         const long long* __restrict__ row_of,
                         const int* __restrict__ offs, int n,
                         uint4* __restrict__ out, long long T, int vpr,
                         int k) {
  using P = Pack<Elem>;
  const long long count = held_count(offs, n);
  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    const Picks p = picks_of(row_of, w, t, k, count);
    for (int c = threadIdx.x; c < vpr; c += kThreads) {
      uint4 d[kMaxTopK], b;
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j)
        if (p.row[j] < count) d[j] = __ldg(rows + p.row[j] * vpr + c);
      if (base) b = __ldg(base + t * vpr + c);
      float acc[P::N];
#pragma unroll
      for (int e = 0; e < P::N; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j) {
        if (p.row[j] >= count) continue;
        float y[P::N];
        P::unpack(d[j], y);
#pragma unroll
        for (int e = 0; e < P::N; ++e) acc[e] += p.scale[j] * y[e];
      }
      if (base) {
        float y[P::N];
        P::unpack(b, y);
#pragma unroll
        for (int e = 0; e < P::N; ++e) acc[e] += y[e];
      }
      out[t * vpr + c] = P::pack(acc);
    }
  }
}

// The combine's backward from g = dL/dy [T, H]: for each held pick (t, j)
// of row r, dy_rows[r] = w[t k + j] g[t] and dw[t k + j] = <g[t],
// y_rows[r]> (fp32: a thread's vectors in order, then a fixed tree over
// lanes and warps); dw is 0 for a pick that is not held.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd_kernel(const uint4* __restrict__ g,
                           const uint4* __restrict__ y_rows,
                           const float* __restrict__ w,
                           const long long* __restrict__ row_of,
                           const int* __restrict__ offs, int n,
                           uint4* __restrict__ dy_rows,
                           float* __restrict__ dw, long long T, int vpr,
                           int k) {
  using P = Pack<Elem>;
  __shared__ float red[kWarps][kMaxTopK];
  const long long count = held_count(offs, n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    const Picks p = picks_of(row_of, w, t, k, count);
    float part[kMaxTopK];
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) part[j] = 0.0f;
    for (int c = threadIdx.x; c < vpr; c += kThreads) {
      uint4 d[kMaxTopK];
      const uint4 gv = __ldg(g + t * vpr + c);
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j)
        if (p.row[j] < count) d[j] = __ldg(y_rows + p.row[j] * vpr + c);
      float gf[P::N];
      P::unpack(gv, gf);
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j) {
        if (p.row[j] >= count) continue;
        float y[P::N], dy[P::N];
        P::unpack(d[j], y);
#pragma unroll
        for (int e = 0; e < P::N; ++e) {
          part[j] += gf[e] * y[e];
          dy[e] = p.scale[j] * gf[e];
        }
        dy_rows[p.row[j] * vpr + c] = P::pack(dy);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j >= k) break;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);
      if (lane == 0) red[warp][j] = part[j];
    }
    __syncthreads();
    if (threadIdx.x < k) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += red[i][threadIdx.x];
      dw[t * k + threadIdx.x] =
          __ldg(row_of + t * k + threadIdx.x) < count ? s : 0.0f;
    }
    __syncthreads();   // red is read before the next token writes it
  }
}

inline int grid_of(long long work, int per_block, int max_blocks) {
  const long long b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b < max_blocks ? b : max_blocks));
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError().
// dtype: 0 fp32, 1 bf16 (ops/moe_rows.py DTYPE_CODES); vpr: 16-byte
// vectors a row of x / y (H), or of h (I); R: the buffer's rows;
// max_blocks: the most blocks a grid takes (the card's SMs x 8).

extern "C" int vlp_moe_gather(const void* x, const void* order,
                              const void* offs, int n, void* out,
                              long long R, int vpr, int k, int max_blocks,
                              void* stream) {
  if (R > 0)
    moe_gather_kernel<<<grid_of(R * vpr, kThreads * kUnroll, max_blocks),
                        kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, (const long long*)order, (const int*)offs, n,
        (uint4*)out, vpr, k);
  return (int)cudaGetLastError();
}

extern "C" int vlp_moe_swiglu(const void* gu, const void* offs, int n,
                              void* h, long long R, int vpr, int dtype,
                              int max_blocks, void* stream) {
  if (R > 0) {
    const int grid = grid_of(R * vpr, kThreads * kUnroll, max_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1)
      moe_swiglu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const uint4*)gu, (const int*)offs, n, (uint4*)h, vpr);
    else
      moe_swiglu_kernel<float><<<grid, kThreads, 0, s>>>(
          (const uint4*)gu, (const int*)offs, n, (uint4*)h, vpr);
  }
  return (int)cudaGetLastError();
}

extern "C" int vlp_moe_swiglu_bwd(const void* dh, const void* gu,
                                  const void* offs, int n, void* dgu,
                                  long long R, int vpr, int dtype,
                                  int max_blocks, void* stream) {
  if (R > 0) {
    const int grid = grid_of(R * vpr, kThreads * kUnroll, max_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1)
      moe_swiglu_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const uint4*)dh, (const uint4*)gu, (const int*)offs, n,
          (uint4*)dgu, vpr);
    else
      moe_swiglu_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
          (const uint4*)dh, (const uint4*)gu, (const int*)offs, n,
          (uint4*)dgu, vpr);
  }
  return (int)cudaGetLastError();
}

// The gather's backward (w and base null) and the combine (w [T, k] fp32,
// base [T, H] or null): out [T, H].
extern "C" int vlp_moe_sum_picks(const void* rows, const void* w,
                                 const void* base, const void* row_of,
                                 const void* offs, int n, void* out,
                                 long long T, int vpr, int k, int dtype,
                                 int max_blocks, void* stream) {
  if (T > 0) {
    const int grid = grid_of(T, 1, max_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1)
      moe_sum_picks_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const uint4*)rows, (const float*)w, (const uint4*)base,
          (const long long*)row_of, (const int*)offs, n, (uint4*)out, T,
          vpr, k);
    else
      moe_sum_picks_kernel<float><<<grid, kThreads, 0, s>>>(
          (const uint4*)rows, (const float*)w, (const uint4*)base,
          (const long long*)row_of, (const int*)offs, n, (uint4*)out, T,
          vpr, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int vlp_moe_combine_bwd(const void* g, const void* y_rows,
                                   const void* w, const void* row_of,
                                   const void* offs, int n, void* dy_rows,
                                   void* dw, long long T, int vpr, int k,
                                   int dtype, int max_blocks, void* stream) {
  if (k > kMaxTopK) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const int grid = grid_of(T, 1, max_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1)
      moe_combine_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const uint4*)g, (const uint4*)y_rows, (const float*)w,
          (const long long*)row_of, (const int*)offs, n, (uint4*)dy_rows,
          (float*)dw, T, vpr, k);
    else
      moe_combine_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
          (const uint4*)g, (const uint4*)y_rows, (const float*)w,
          (const long long*)row_of, (const int*)offs, n, (uint4*)dy_rows,
          (float*)dw, T, vpr, k);
  }
  return (int)cudaGetLastError();
}
