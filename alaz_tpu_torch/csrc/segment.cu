// Hand-written Hopper (sm_90a) kernels for the segment ops of the scoring
// paths (GraphSAGE and GAT). Plain C interface, built with nvcc into a
// shared library and loaded with ctypes (alaz_tpu_torch/ops/_build.py);
// the Python wrappers live in alaz_tpu_torch/ops/segment_kernels.py.
//
// K1  alaz_scatter_sum_sorted
//     Replaces alaz_tpu/ops/pallas_segment.py scatter_sum_sorted
//     (_scatter_kernel / _scatter_sorted): out[d] = sum_{e: dst[e]=d} msgs[e]
//     over dst-sorted edges, accumulated in f32.
//     Bound on the H100: bytes. Every message row is read once and every
//     output row written once; there are no FLOPs worth counting (one add
//     per element read). The TPU kernel's one-hot MXU matmuls only existed
//     to turn the scatter into dense work; here the sum is taken directly.
//     Design: one warp per dst row. The warp finds its row's edge run by
//     binary search inside the run of its 128-row dst block ([row_start[b],
//     row_start[b+1]) -- the COO layout's searchsorted or the blocked
//     layout's host extents), then its lanes stride the feature columns
//     with vector loads (16 B for f32, 8 B for bf16) and walk the run in
//     edge order, UNROLL rows in flight per lane to cover memory latency.
//     No atomics and a fixed order: results are deterministic, and the COO
//     and blocked layouts give bit-identical rows. Rows without edges get
//     zeros; every output row is written exactly once.
//     Known limit: a row's run is walked by one warp, so a hub row with a
//     very long run is latency bound on one SM.
//
// K2  alaz_segment_expand_sorted
//     Replaces alaz_tpu/ops/pallas_segment.py segment_expand_sorted
//     (_expand_kernel / _expand_sorted): out[e] = v[dst[e]].
//     Bound on the H100: bytes (the output rows dominate). The TPU kernel
//     expanded 128-row windows of v with one-hot matmuls because a TPU row
//     gather is row-op bound; on Hopper a row gather is plain coalesced
//     copying. Design: a grid-stride copy of W-byte words (W = 16 where
//     the row size and pointers allow), row index loaded once per word.
//     Exact for any dtype. An out-of-range dst yields a zero row.
//
// K3  alaz_gather_rows_banded
//     Replaces alaz_tpu/ops/pallas_segment.py gather_rows_banded
//     (_banded_gather_kernel / _gather_banded): out[e] = v[ids[e]] for
//     UNSORTED ids (the src side of a dst-sorted window).
//     Bound on the H100: bytes (the [E, F] output written once dominates;
//     the rows read are at most the table, which at N=131,072 x 256 B is
//     33.5 MB and fits the 50 MB L2). The TPU kernel covered a fixed band
//     of 128-row windows around each 512-edge chunk's median src window
//     with one-hot matmuls and fixed the strays up with an XLA gather,
//     because a TPU row gather is row-op bound and only windowed DMAs are
//     cheap. None of that is needed here: a random 256-byte row read is two
//     full cache lines, so the kernel is K2's coalesced W-byte copy over
//     unsorted ids. The cluster_renumber layout still helps, by keeping a
//     warp's rows in L2, but the result does not depend on it. Exact for
//     any dtype; an out-of-range id yields a zero row.
//
// K4  alaz_gather_scatter_sum
//     Replaces alaz_tpu/ops/pallas_segment.py pallas_gather_scatter_sum
//     (_forward, through _scatter_sorted): out[d] = sum_{e: dst[e]=d}
//     w[e] * x[src[e]] over dst-sorted edges.
//     Bound on the H100: bytes (src and dst ids, the weights, the x rows
//     the edges touch and the output; one multiply and one add per element
//     read). The TPU version gathered the messages into HBM with XLA and
//     then ran K1's one-hot matmuls over them. Design: K1's warp per dst
//     row, with the message row read as x[src[e]] and never stored, so the
//     [E, F] messages never reach device memory. The product is rounded to
//     x's dtype before it is added in f32 (the JAX package multiplies in
//     x's dtype, then sums in f32 and rounds once), and __fmul_rn keeps
//     nvcc from contracting it into an FMA. Deterministic, and COO and
//     blocked row starts give bit-identical rows, as K1. An out-of-range
//     src contributes zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;  // dst rows per extent block (EDGE_BLOCK_ROWS)
constexpr int kWarps = 8;        // warps per CTA: one dst row each
constexpr int kUnroll = 8;       // message rows in flight per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC contiguous elements moved by one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// first index in [lo, hi) whose dst is >= key (hi if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// [s, t): the edge run of dst row ``row``, searched inside the run of its
// 128-row block. The extents are clamped to the edge axis: a malformed
// extent vector can give wrong sums but never an out-of-bounds read.
__device__ __forceinline__ void row_run(const int* __restrict__ dst,
                                        const int* __restrict__ row_start, int row,
                                        int n_edges, int& s, int& t) {
  const int b = row / kBlockRows;
  const int lo = min(max(__ldg(row_start + b), 0), n_edges);
  const int hi = min(max(__ldg(row_start + b + 1), lo), n_edges);
  s = lower_bound(dst, lo, hi, row);
  t = lower_bound(dst, s, hi, row + 1);
}

template <typename InT, typename OutT, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
scatter_sum_sorted_kernel(const InT* __restrict__ msgs, const int* __restrict__ dst,
                          const int* __restrict__ row_start, OutT* __restrict__ out,
                          int n_rows, int f, int n_edges) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  int s, t;
  row_run(dst, row_start, row, n_edges, s, t);
  OutT* orow = out + (size_t)row * f;
  for (int c = lane * VEC; c < f; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    const InT* col = msgs + c;
    int e = s;
    for (; e + kUnroll <= t; e += kUnroll) {
      Vec<InT, VEC> m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        m[u] = *reinterpret_cast<const Vec<InT, VEC>*>(col + (size_t)(e + u) * f);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += to_f32(m[u].v[k]);
    }
    for (; e < t; ++e) {
      const Vec<InT, VEC> m = *reinterpret_cast<const Vec<InT, VEC>*>(col + (size_t)e * f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(m.v[k]);
    }
    Vec<OutT, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<OutT>(acc[k]);
    *reinterpret_cast<Vec<OutT, VEC>*>(orow + c) = o;
  }
}

template <typename InT, typename OutT>
cudaError_t launch_scatter(const void* msgs, const int* dst, const int* row_start, void* out,
                           int n_rows, int f, int n_edges, int vec, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const InT* m = static_cast<const InT*>(msgs);
  OutT* o = static_cast<OutT*>(out);
  if (vec == 4) {
    scatter_sum_sorted_kernel<InT, OutT, 4><<<grid, block, 0, stream>>>(m, dst, row_start, o, n_rows, f, n_edges);
  } else if (vec == 1) {
    scatter_sum_sorted_kernel<InT, OutT, 1><<<grid, block, 0, stream>>>(m, dst, row_start, o, n_rows, f, n_edges);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out[e] = v[ids[e]] as a grid-stride copy of W-byte words, the row
// index loaded once per word; an out-of-range id gives a zero row.
// Shared by K2 (dst-sorted ids) and K3 (unsorted ids), each its own
// __global__ so a profile tells their times apart.
template <typename W>
__device__ __forceinline__ void copy_rows(const W* __restrict__ v, const int* __restrict__ ids,
                                          W* __restrict__ out, int n_rows_v, int n_edges,
                                          int64_t row_words) {
  const int64_t total = (int64_t)n_edges * row_words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t e = i / row_words;
    const int64_t c = i - e * row_words;
    const int d = __ldg(ids + e);
    out[i] = (d >= 0 && d < n_rows_v) ? v[(int64_t)d * row_words + c] : W{};
  }
}

template <typename W>
__global__ void __launch_bounds__(256)
segment_expand_sorted_kernel(const W* __restrict__ v, const int* __restrict__ dst,
                             W* __restrict__ out, int n_rows_v, int n_edges, int64_t row_words) {
  copy_rows<W>(v, dst, out, n_rows_v, n_edges, row_words);
}

template <typename W>
__global__ void __launch_bounds__(256)
gather_rows_banded_kernel(const W* __restrict__ v, const int* __restrict__ ids,
                          W* __restrict__ out, int n_rows_v, int n_edges, int64_t row_words) {
  copy_rows<W>(v, ids, out, n_rows_v, n_edges, row_words);
}

enum class RowGather { kExpand, kBanded };

template <typename W>
cudaError_t launch_row_gather(RowGather which, const void* v, const int* ids, void* out,
                              int n_rows_v, int n_edges, int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_words = row_bytes / (int64_t)sizeof(W);
  const int64_t total = (int64_t)n_edges * row_words;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 CTAs per SM
  if (blocks < 1) blocks = 1;
  const W* vw = static_cast<const W*>(v);
  W* ow = static_cast<W*>(out);
  if (which == RowGather::kExpand) {
    segment_expand_sorted_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
        vw, ids, ow, n_rows_v, n_edges, row_words);
  } else {
    gather_rows_banded_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
        vw, ids, ow, n_rows_v, n_edges, row_words);
  }
  return cudaGetLastError();
}

cudaError_t row_gather(RowGather which, const void* v, const void* ids, void* out, int n_rows_v,
                       int n_edges, long long row_bytes, int word_bytes, void* stream) {
  const int* d = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: return launch_row_gather<uint4>(which, v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 8: return launch_row_gather<uint2>(which, v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 4: return launch_row_gather<uint32_t>(which, v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 2: return launch_row_gather<uint16_t>(which, v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 1: return launch_row_gather<uint8_t>(which, v, d, out, n_rows_v, n_edges, row_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

// a product in T's precision: the f32 product, rounded to T
template <typename T>
__device__ __forceinline__ float mul_in(float a, float b);
template <>
__device__ __forceinline__ float mul_in<float>(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ float mul_in<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_row(const T* __restrict__ x, int r, int n_rows_x,
                                                int f, int c) {
  if (r >= 0 && r < n_rows_x) return *reinterpret_cast<const Vec<T, VEC>*>(x + (size_t)r * f + c);
  Vec<T, VEC> z;
#pragma unroll
  for (int k = 0; k < VEC; ++k) z.v[k] = from_f32<T>(0.0f);
  return z;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
gather_scatter_sum_kernel(const T* __restrict__ x, const int* __restrict__ src,
                          const int* __restrict__ dst, const T* __restrict__ w,
                          const int* __restrict__ row_start, T* __restrict__ out, int n_rows,
                          int n_rows_x, int f, int n_edges) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  int s, t;
  row_run(dst, row_start, row, n_edges, s, t);
  T* orow = out + (size_t)row * f;
  for (int c = lane * VEC; c < f; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    int e = s;
    for (; e + kUnroll <= t; e += kUnroll) {
      Vec<T, VEC> m[kUnroll];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        m[u] = load_row<T, VEC>(x, __ldg(src + e + u), n_rows_x, f, c);
        wt[u] = w ? to_f32(w[e + u]) : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += mul_in<T>(to_f32(m[u].v[k]), wt[u]);
    }
    for (; e < t; ++e) {
      const Vec<T, VEC> m = load_row<T, VEC>(x, __ldg(src + e), n_rows_x, f, c);
      const float wt = w ? to_f32(w[e]) : 1.0f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += mul_in<T>(to_f32(m.v[k]), wt);
    }
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(acc[k]);
    *reinterpret_cast<Vec<T, VEC>*>(orow + c) = o;
  }
}

template <typename T>
cudaError_t launch_gather_scatter(const void* x, const int* src, const int* dst, const void* w,
                                  const int* row_start, void* out, int n_rows, int n_rows_x,
                                  int f, int n_edges, int vec, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (vec == 4) {
    gather_scatter_sum_kernel<T, 4><<<grid, block, 0, stream>>>(
        xt, src, dst, wt, row_start, o, n_rows, n_rows_x, f, n_edges);
  } else if (vec == 1) {
    gather_scatter_sum_kernel<T, 1><<<grid, block, 0, stream>>>(
        xt, src, dst, wt, row_start, o, n_rows, n_rows_x, f, n_edges);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes shared with segment_kernels.py
enum { kF32 = 0, kBF16 = 1 };

// K1. msgs [n_edges, f] (in_dtype), dst [n_edges] int32 dst-sorted,
// row_start [n_rows/128 + 1] int32, out [n_rows, f] (out_dtype).
// vec: 4 when f % 4 == 0 and both buffers are 16-byte aligned, else 1.
int alaz_scatter_sum_sorted(const void* msgs, const void* dst, const void* row_start, void* out,
                            int n_rows, int f, int n_edges, int in_dtype, int out_dtype, int vec,
                            void* stream) {
  const int* d = static_cast<const int*>(dst);
  const int* rs = static_cast<const int*>(row_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch_scatter<float, float>(msgs, d, rs, out, n_rows, f, n_edges, vec, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch_scatter<__nv_bfloat16, __nv_bfloat16>(msgs, d, rs, out, n_rows, f, n_edges, vec, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch_scatter<__nv_bfloat16, float>(msgs, d, rs, out, n_rows, f, n_edges, vec, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch_scatter<float, __nv_bfloat16>(msgs, d, rs, out, n_rows, f, n_edges, vec, s);
  return cudaErrorInvalidValue;
}

// K2. v [n_rows_v, row_bytes] (any dtype), dst [n_edges] int32,
// out [n_edges, row_bytes]. word_bytes divides row_bytes and both
// buffers' alignment: 16, 8, 4, 2 or 1.
int alaz_segment_expand_sorted(const void* v, const void* dst, void* out, int n_rows_v,
                               int n_edges, long long row_bytes, int word_bytes, void* stream) {
  return row_gather(RowGather::kExpand, v, dst, out, n_rows_v, n_edges, row_bytes, word_bytes,
                    stream);
}

// K3. As K2, with ids [n_edges] int32 in any order.
int alaz_gather_rows_banded(const void* v, const void* ids, void* out, int n_rows_v, int n_edges,
                            long long row_bytes, int word_bytes, void* stream) {
  return row_gather(RowGather::kBanded, v, ids, out, n_rows_v, n_edges, row_bytes, word_bytes,
                    stream);
}

// K4. x [n_rows_x, f] (dtype), src and dst [n_edges] int32 with dst
// sorted, w [n_edges] (dtype) or null for no weights, row_start
// [n_rows/128 + 1] int32, out [n_rows, f] (dtype).
// vec: 4 when f % 4 == 0 and x and out are 16-byte aligned, else 1.
int alaz_gather_scatter_sum(const void* x, const void* src, const void* dst, const void* w,
                            const void* row_start, void* out, int n_rows, int n_rows_x, int f,
                            int n_edges, int dtype, int vec, void* stream) {
  const int* sp = static_cast<const int*>(src);
  const int* dp = static_cast<const int*>(dst);
  const int* rs = static_cast<const int*>(row_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gather_scatter<float>(x, sp, dp, w, rs, out, n_rows, n_rows_x, f, n_edges, vec, s);
  if (dtype == kBF16)
    return launch_gather_scatter<__nv_bfloat16>(x, sp, dp, w, rs, out, n_rows, n_rows_x, f,
                                                n_edges, vec, s);
  return cudaErrorInvalidValue;
}

const char* alaz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
