// Hand-written Hopper (sm_90a) kernels for the dst-sorted segment ops of
// the GraphSAGE scoring path. Plain C interface, built with nvcc into a
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

template <typename InT, typename OutT, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
scatter_sum_sorted_kernel(const InT* __restrict__ msgs, const int* __restrict__ dst,
                          const int* __restrict__ row_start, OutT* __restrict__ out,
                          int n_rows, int f, int n_edges) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int b = row / kBlockRows;
  // clamp the extents to the edge axis: a malformed extent vector can
  // give wrong sums but never an out-of-bounds read
  const int lo = min(max(__ldg(row_start + b), 0), n_edges);
  const int hi = min(max(__ldg(row_start + b + 1), lo), n_edges);
  const int s = lower_bound(dst, lo, hi, row);
  const int t = lower_bound(dst, s, hi, row + 1);
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

template <typename W>
__global__ void __launch_bounds__(256)
segment_expand_sorted_kernel(const W* __restrict__ v, const int* __restrict__ dst,
                             W* __restrict__ out, int n_rows_v, int n_edges, int64_t row_words) {
  const int64_t total = (int64_t)n_edges * row_words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t e = i / row_words;
    const int64_t c = i - e * row_words;
    const int d = __ldg(dst + e);
    out[i] = (d >= 0 && d < n_rows_v) ? v[(int64_t)d * row_words + c] : W{};
  }
}

template <typename W>
cudaError_t launch_expand(const void* v, const int* dst, void* out, int n_rows_v, int n_edges,
                          int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_words = row_bytes / (int64_t)sizeof(W);
  const int64_t total = (int64_t)n_edges * row_words;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 CTAs per SM
  if (blocks < 1) blocks = 1;
  segment_expand_sorted_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const W*>(v), dst, static_cast<W*>(out), n_rows_v, n_edges, row_words);
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
  const int* d = static_cast<const int*>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: return launch_expand<uint4>(v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 8: return launch_expand<uint2>(v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 4: return launch_expand<uint32_t>(v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 2: return launch_expand<uint16_t>(v, d, out, n_rows_v, n_edges, row_bytes, s);
    case 1: return launch_expand<uint8_t>(v, d, out, n_rows_v, n_edges, row_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* alaz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
