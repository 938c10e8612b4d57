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
//     The TPU version gathered the messages into HBM with XLA and then ran
//     K1's one-hot matmuls over them; here the message row x[src[e]] is
//     read and never stored, so the [E, F] messages never reach device
//     memory. The product is rounded to x's dtype before it is added in
//     f32 (the JAX package multiplies in x's dtype, then sums in f32 and
//     rounds once), and __fmul_rn keeps nvcc from contracting it into an
//     FMA. An out-of-range src contributes zero; a row without edges is
//     zero.
//     Bound on the H100: bytes. HBM moves the src and dst ids, the
//     weights, each distinct x row once and the output (the bound). But
//     every edge reads its x row again, from L2 when the table fits there
//     (N = 131,072 bf16 rows of 256 B is 33.5 MB of the 50 MB L2): at the
//     smoke window's 1M edges that is 268 MB of L2 reads, ~4x the HBM
//     bytes the bound counts.
//     Design, and what each part is for:
//     - Edge-balanced tiles. A CTA takes kGsTile consecutive live edges
//       (the frontier is row_start[n_rows/128]; tiles past it exit), so a
//       window whose edges sit in a few dst blocks still spreads over all
//       SMs: 1,024 tiles of 1,024 edges, two waves of four CTAs an SM,
//       for the smoke windows. The tile's dst, src and weights go to
//       shared memory, every global load issued before the first store;
//       its runs of equal dst come from one block scan of dst[e] !=
//       dst[e-1]. No search, and no dependent id load before a row load:
//       each edge's row address (a generic pointer) is built once a tile.
//     - Rows in flight. A group of lanes owns a contiguous slice of the
//       tile and walks it run by run; each lane reads 16 bytes of a row (a
//       half-warp per 256-byte bf16 row, two rows per instruction),
//       kGsUnroll rows ahead of its sums: 16 rows per warp, 512 an SM.
//       Register unrolling, not a cp.async ring: the addresses are ready
//       in shared memory, and a ring would cost the shared memory that
//       holds four CTAs an SM. A run's last edges add a zero row for the
//       slots past it, so the loop body has no branch; an out-of-range src
//       reads the zero row too. bf16 products go two at a time (__hmul2);
//       the scalar f32 -> bf16 conversion pipe set the pace before.
//     - Determinism without atomics. A slice sums in f32 in edge order; a
//       row cut by slice ends is combined through shared memory in slice
//       order, a row cut by tile ends through per-tile f32 carries that a
//       second kernel adds in tile order and rounds once. The partition
//       depends only on edge positions, so COO and blocked row starts give
//       bit-identical rows. Every output row is written once: rows of
//       busy blocks by the tiles (gaps between dst values as zeros), the
//       empty 128-row blocks by the tile CTAs after their walks.
//     - Row starts. The COO layout's starts come from a one-pass kernel
//       (no search) launched ahead of the tiles, which overlap it while
//       they load their ids; the carry kernel in turn takes the SMs the
//       last tiles leave (Programmatic Dependent Launch).
//     - Not kept: staging each tile's reused src rows in shared memory
//       (a block sort of the tile's src ids, each row used twice or more
//       copied in once; the clustered window reads each src row 3.3 times
//       within a tile). It made K4 slower on both windows: the sort
//       lengthened every tile, and the staged rows' shared memory halved
//       the CTAs an SM (PERF.md, PR 3).
//     What sets the pace on the H100 (PERF.md): the tiles' phases (ids
//     into shared memory, the walk's short chains of L2 round trips, the
//     combine) in two waves, and the row-starts kernel; the L2 row reads
//     themselves cost a small part, as every edge reading one row shows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

constexpr int kGsThreads = 256;                 // threads per K4 tile CTA
constexpr int kGsTile = 1024;                   // live edges per tile
constexpr int kGsItems = kGsTile / kGsThreads;  // ids per thread
constexpr int kGsUnroll = 8;                    // x rows in flight per lane
constexpr int kGsMinBlocks = 4;                 // tile CTAs an SM holds (64 registers a thread)
constexpr int kGsCarryThreads = 128;            // threads per carry CTA
constexpr int kStartsEdges = 16;                // edges per thread of the row-starts kernel
constexpr int kNoRow = INT_MIN;                 // dst halo past either end of the live edges
constexpr int kMaxSmem = 232448;                // shared memory per CTA on the H100 (227 KB)

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// Byte offsets of a K4 tile's dynamic shared memory: dst with a one-id
// halo on each side; each edge's row address (a generic pointer: an x row
// or the zero row); weights; the starts of the tile's runs of equal dst;
// one scratch region (the src ids, then the slices' f32 partial sums);
// a row of zeros.
struct GsLayout {
  int addr, w, runs, scratch, zero, total;
  __host__ __device__ GsLayout(int vec, int row_bytes) {
    addr = align16(4 * (kGsTile + 2));
    w = addr + 8 * kGsTile;
    runs = w + 4 * kGsTile;
    scratch = align16(runs + 2 * (kGsTile + 1));
    const int part = 2 * vec * kGsThreads * 4;
    zero = align16(scratch + (4 * kGsTile > part ? 4 * kGsTile : part));
    total = zero + row_bytes;
  }
};

// a product in T's precision: the f32 product, rounded to T
template <typename T>
__device__ __forceinline__ float mul_in(float a, float b);
template <>
__device__ __forceinline__ float mul_in<float>(float a, float b) { return __fmul_rn(a, b); }
template <>
__device__ __forceinline__ float mul_in<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

// a tile's ids and weights as shared memory holds them: a bf16 weight
// twice, as the second factor of a bf16x2 product
__device__ __forceinline__ int to_smem(int v) { return v; }
__device__ __forceinline__ float to_smem(float v) { return v; }
__device__ __forceinline__ __nv_bfloat162 to_smem(__nv_bfloat16 v) {
  return __bfloat162bfloat162(v);
}

// acc[j] += m[j] * w, each product rounded to T before the f32 sum. For
// bf16 two products at a time (__hmul2: the exact product of two bf16
// values, rounded once to bf16, as the f32 product rounded to bf16).
template <int VEC>
__device__ __forceinline__ void add_products(float (&acc)[VEC], const Vec<float, VEC>& m, float w) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] += mul_in<float>(m.v[j], w);
}
template <int VEC>
__device__ __forceinline__ void add_products(float (&acc)[VEC], const Vec<__nv_bfloat16, VEC>& m,
                                             __nv_bfloat162 w) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 q = __hmul2(__halves2bfloat162(m.v[j], m.v[j + 1]), w);
      const unsigned bits = *reinterpret_cast<const unsigned*>(&q);
      acc[j] += __uint_as_float(bits << 16);  // the low bf16 as f32
      acc[j + 1] += __uint_as_float(bits & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] += mul_in<__nv_bfloat16>(__bfloat162float(m.v[j]), __low2float(w));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> zero_vec() {
  Vec<T, VEC> z;
#pragma unroll
  for (int k = 0; k < VEC; ++k) z.v[k] = from_f32<T>(0.0f);
  return z;
}

// The tile's dst, src and weights into shared memory (weights as to_smem
// gives them; one for no weights): every global load of a thread is
// issued before its first shared store, with 16-byte loads for a full,
// aligned tile.
template <typename T, typename W>
__device__ __forceinline__ void load_tile_ids(int* s_dst, int* s_src, W* s_w,
                                              const int* __restrict__ dst,
                                              const int* __restrict__ src,
                                              const T* __restrict__ w, int n, W one) {
  constexpr int KW = 16 / sizeof(T);
  constexpr int DI = (kGsTile / 4 + kGsThreads - 1) / kGsThreads;
  constexpr int DW = (kGsTile / KW + kGsThreads - 1) / kGsThreads;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(w);
  if (n == kGsTile && (bits & 15) == 0) {
    Vec<int, 4> dv[DI], sv[DI];
    Vec<T, KW> wv[DW];
#pragma unroll
    for (int j = 0; j < DI; ++j) {
      const int q = threadIdx.x + j * kGsThreads;
      if (q < kGsTile / 4) {
        dv[j] = *reinterpret_cast<const Vec<int, 4>*>(dst + 4 * q);
        sv[j] = *reinterpret_cast<const Vec<int, 4>*>(src + 4 * q);
      }
    }
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      const int q = threadIdx.x + j * kGsThreads;
      if (w && q < kGsTile / KW) wv[j] = *reinterpret_cast<const Vec<T, KW>*>(w + KW * q);
    }
#pragma unroll
    for (int j = 0; j < DI; ++j) {
      const int q = threadIdx.x + j * kGsThreads;
      if (q < kGsTile / 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_dst[4 * q + k] = dv[j].v[k];
          s_src[4 * q + k] = sv[j].v[k];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      const int q = threadIdx.x + j * kGsThreads;
      if (q < kGsTile / KW) {
#pragma unroll
        for (int k = 0; k < KW; ++k) s_w[KW * q + k] = w ? to_smem(wv[j].v[k]) : one;
      }
    }
  } else {
    int dv[kGsItems], sv[kGsItems];
    W wv[kGsItems];
#pragma unroll
    for (int j = 0; j < kGsItems; ++j) {
      const int i = threadIdx.x + j * kGsThreads;
      if (i < n) {
        dv[j] = __ldg(dst + i);
        sv[j] = __ldg(src + i);
        wv[j] = w ? to_smem(w[i]) : one;
      }
    }
#pragma unroll
    for (int j = 0; j < kGsItems; ++j) {
      const int i = threadIdx.x + j * kGsThreads;
      if (i < n) {
        s_dst[i] = dv[j];
        s_src[i] = sv[j];
        s_w[i] = wv[j];
      }
    }
  }
}

// exclusive prefix sum of v over the CTA's threads in order; total gets
// the sum. Every thread of the CTA must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kGsThreads / 32; ++i) {
    const int t = s_warp[i];
    before += i < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // s_warp is reused by the next scan
  return before + x - v;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ out, int row, int n_rows, int f, int c,
                                          const float (&acc)[VEC]) {
  if (row < 0 || row >= n_rows) return;
  Vec<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(acc[k]);
  *reinterpret_cast<Vec<T, VEC>*>(out + (size_t)row * f + c) = o;
}

template <typename T, int VEC>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int lo, int hi, int n_rows, int f,
                                          int c) {
  const Vec<T, VEC> z = zero_vec<T, VEC>();
  for (int r = lo < 0 ? 0 : lo; r < hi && r < n_rows; ++r)
    *reinterpret_cast<Vec<T, VEC>*>(out + (size_t)r * f + c) = z;
}

// Zero the rows without live edges between consecutive dst values a < b
// that share a 128-row block with a or with b (has_a false: b is the
// first live edge's dst). Blocks without edges are zeroed whole by
// zero_empty_block, so every row is written once.
template <typename T, int VEC>
__device__ __forceinline__ void zero_gap(T* __restrict__ out, int a, bool has_a, int b,
                                         int n_rows, int f, int c) {
  int lo = b >= 0 ? (b & ~(kBlockRows - 1)) : b;
  if (has_a) {
    int hi = a + 1;
    if (a >= 0 && a < n_rows) {
      hi = min((a | (kBlockRows - 1)) + 1, b);
      zero_rows<T, VEC>(out, a + 1, hi, n_rows, f, c);
    }
    lo = max(lo, hi);
  }
  zero_rows<T, VEC>(out, lo, b, n_rows, f, c);
}

// Zero the 128-row dst blocks without live edges among b = blockIdx.x,
// blockIdx.x + gridDim.x, ...: a share of the empty blocks for every CTA.
template <typename T, int VEC>
__device__ void zero_empty_blocks(const int* __restrict__ row_start, T* __restrict__ out,
                                  int n_blocks, int f, int n_edges) {
  const Vec<T, VEC> z = zero_vec<T, VEC>();
  const int words = kBlockRows * f / VEC;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int lo = min(max(__ldg(row_start + b), 0), n_edges);
    const int hi = min(max(__ldg(row_start + b + 1), lo), n_edges);
    if (hi > lo) continue;
    Vec<T, VEC>* o = reinterpret_cast<Vec<T, VEC>*>(out + (size_t)b * kBlockRows * f);
    for (int i = threadIdx.x; i < words; i += blockDim.x) o[i] = z;
  }
}

__device__ __forceinline__ int live_frontier(const int* __restrict__ row_start, int n_rows,
                                             int n_edges) {
  return min(max(__ldg(row_start + n_rows / kBlockRows), 0), n_edges);
}

// Programmatic Dependent Launch (Hopper): the next kernel on the stream
// may start once every CTA of this one has called launch_dependents (or
// ended); wait_prerequisites waits for the kernel before to end and its
// writes to be visible. Both do nothing for a kernel launched plainly.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// K4's phase timeline, compiled in only with -DALAZ_K4_TIMELINE (the
// timeline build of ops/_build.py; chip_smoke.py reads it): per tile CTA
// the %globaltimer ns at its start, after its ids and runs are in shared
// memory, after its first column pass's walk, at its end, and its SM.
#ifdef ALAZ_K4_TIMELINE
constexpr int kTimelineCtas = 4096;
__device__ unsigned long long g_k4_timeline[kTimelineCtas * 5];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K4_STAMP(slot, value)                                                     \
  if (threadIdx.x == 0 && blockIdx.x < kTimelineCtas)                              \
    g_k4_timeline[blockIdx.x * 5 + (slot)] = (value)
#else
#define K4_STAMP(slot, value)
#endif

// One CTA per tile of kGsTile live edges (at least one per 8 dst blocks);
// each also zeroes its share of the empty 128-row dst blocks. The tile
// finds its runs of equal dst once (a block scan of dst[i] != dst[i-1]).
// In each column pass (VEC columns a lane, LG lanes a group) every group
// walks its slice of the tile run by run, kGsUnroll rows at a time, and
// writes the rows that start and end inside the slice; rows cut by a
// slice end go to shared memory, where the group holding a row's first
// edge in the tile adds them up in slice order. A row cut by the tile's
// end leaves its partial in carry[tile][1] (it continues past the tile),
// one cut only by the tile's start in carry[tile][0]; the carry kernel
// finishes those.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGsThreads, kGsMinBlocks)
gather_scatter_tile_kernel(const T* __restrict__ x, const int* __restrict__ src,
                           const int* __restrict__ dst, const T* __restrict__ w,
                           const int* __restrict__ row_start, T* __restrict__ out,
                           float* __restrict__ carry, int n_rows, int n_rows_x, int f,
                           int n_edges, int lanes_log2) {
  using W = decltype(to_smem(T{}));
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kGsThreads / 32];
#ifdef ALAZ_K4_TIMELINE
  const unsigned long long start_ns = global_ns();
#endif
  launch_dependents();  // the carry kernel may take the SMs the tiles leave
  const int tile = blockIdx.x;
  const int t0 = tile * kGsTile;

  const GsLayout lay(VEC, f * (int)sizeof(T));
  int* s_dst = reinterpret_cast<int*>(smem) + 1;  // s_dst[-1 .. n]
  const T** s_addr = reinterpret_cast<const T**>(smem + lay.addr);
  W* s_w = reinterpret_cast<W*>(smem + lay.w);
  short* s_run = reinterpret_cast<short*>(smem + lay.runs);  // run starts, then n
  int* s_src = reinterpret_cast<int*>(smem + lay.scratch);
  float* s_part = reinterpret_cast<float*>(smem + lay.scratch);
  T* s_zero = reinterpret_cast<T*>(smem + lay.zero);
  const W one = to_smem(from_f32<T>(1.0f));

  // the ids do not depend on the row starts: load them while the kernel
  // that computes those (COO) may still run
  if (t0 < n_edges)
    load_tile_ids(s_dst, s_src, s_w, dst + t0, src + t0, w ? w + t0 : nullptr,
                  min(kGsTile, n_edges - t0), one);
  wait_prerequisites();
  const int frontier = live_frontier(row_start, n_rows, n_edges);
  if (t0 >= frontier) {
    zero_empty_blocks<T, VEC>(row_start, out, n_rows / kBlockRows, f, n_edges);
    return;
  }
  const int n = min(kGsTile, frontier - t0);
  for (int j = threadIdx.x; j < f; j += kGsThreads) s_zero[j] = from_f32<T>(0.0f);
  if (threadIdx.x == 0) {
    s_dst[-1] = t0 > 0 ? __ldg(dst + t0 - 1) : kNoRow;
    s_dst[n] = t0 + n < frontier ? __ldg(dst + t0 + n) : kNoRow;
  }
  __syncthreads();
  int n_runs;
  {
    int starts = 0;
#pragma unroll
    for (int j = 0; j < kGsItems; ++j) {
      const int i = threadIdx.x * kGsItems + j;
      starts += (i < n && (i == 0 || s_dst[i] != s_dst[i - 1])) ? 1 : 0;
    }
    int at = block_exclusive_scan(starts, s_warp, n_runs);
#pragma unroll
    for (int j = 0; j < kGsItems; ++j) {
      const int i = threadIdx.x * kGsItems + j;
      if (i < n && (i == 0 || s_dst[i] != s_dst[i - 1])) s_run[at++] = (short)i;
    }
    if (threadIdx.x == 0) s_run[n_runs] = (short)n;
  }
  // each edge's row: x's, or (src out of range) the zero row at weight
  // one, which adds +0.0 and so leaves every sum as it is
  for (int i = threadIdx.x; i < n; i += kGsThreads) {
    const int s = s_src[i];
    const bool valid = s >= 0 && s < n_rows_x;
    s_addr[i] = valid ? x + (size_t)s * f : s_zero;
    if (!valid) s_w[i] = one;
  }
  __syncthreads();

  K4_STAMP(0, start_ns);
  K4_STAMP(1, global_ns());  // ids, runs and row addresses in shared memory
  const int lanes = 1 << lanes_log2;
  const int g = threadIdx.x >> lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int slice = kGsItems << lanes_log2;  // edges per group
  const int s0 = g * slice;
  const int s1 = min(s0 + slice, n);
  float* my_carry = carry + (size_t)tile * 2 * f;

  for (int c0 = 0; c0 < f; c0 += lanes * VEC) {
    const int c = c0 + lane * VEC;
    const bool col = c < f;
    if (s0 < s1 && col) {
      int r = 0;  // the run holding s0: the last run start at or before it
      for (int hi = n_runs; hi - r > 1;) {
        const int mid = (r + hi) >> 1;
        if (s_run[mid] <= s0) r = mid; else hi = mid;
      }
      for (int a = s0; a < s1; ++r) {
        const int b = min((int)s_run[r + 1], s1);
        const int row = s_dst[a];
        float acc[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
        int e = a;
        for (; e + kGsUnroll <= b; e += kGsUnroll) {
          Vec<T, VEC> m[kGsUnroll];
#pragma unroll
          for (int u = 0; u < kGsUnroll; ++u)
            m[u] = *reinterpret_cast<const Vec<T, VEC>*>(s_addr[e + u] + c);
#pragma unroll
          for (int u = 0; u < kGsUnroll; ++u) add_products(acc, m[u], s_w[e + u]);
        }
        if (e < b) {  // the run's last edges; the slots past it add the zero row
          Vec<T, VEC> m[kGsUnroll];
          W wt[kGsUnroll];
#pragma unroll
          for (int u = 0; u < kGsUnroll; ++u) {
            const bool in = e + u < b;
            m[u] = *reinterpret_cast<const Vec<T, VEC>*>((in ? s_addr[e + u] : s_zero) + c);
            wt[u] = in ? s_w[e + u] : one;
          }
#pragma unroll
          for (int u = 0; u < kGsUnroll; ++u) add_products(acc, m[u], wt[u]);
        }
        const bool cut_front = a == s0 && s_dst[s0 - 1] == row;  // begun before the slice
        if (b == s1 && s_dst[s1] == row) {  // continues past the slice: slot 1
#pragma unroll
          for (int j = 0; j < VEC; ++j) s_part[(VEC + j) * kGsThreads + threadIdx.x] = acc[j];
        } else if (cut_front) {  // slot 0
#pragma unroll
          for (int j = 0; j < VEC; ++j) s_part[j * kGsThreads + threadIdx.x] = acc[j];
        } else {
          store_row<T, VEC>(out, row, n_rows, f, c, acc);
        }
        if (!cut_front) zero_gap<T, VEC>(out, s_dst[a - 1], t0 + a > 0, row, n_rows, f, c);
        a = b;
      }
      const int last = s_dst[s1 - 1];
      if (t0 + s1 == frontier && last >= 0 && last < n_rows)  // after the last live edge
        zero_rows<T, VEC>(out, last + 1, (last | (kBlockRows - 1)) + 1, n_rows, f, c);
    }
    __syncthreads();
    if (c0 == 0) K4_STAMP(2, global_ns());  // the walk of every group
    if (s0 < s1 && col) {
      const int first_row = s_dst[s0], last_row = s_dst[s1 - 1];
      const bool single = first_row == last_row;
      const bool head_cut = s_dst[s0 - 1] == first_row;
      const bool tail_cut = s_dst[s1] == last_row;
      // add a row's partials from this group on, in slice order, and
      // finish the row or carry it
      for (int which = 0; which < 2; ++which) {
        int slot, row;
        bool from_prev_tile;
        if (which == 0) {  // the tile's first row, begun in an earlier tile
          if (g != 0 || !head_cut) continue;
          slot = single && tail_cut ? 1 : 0;
          row = first_row;
          from_prev_tile = true;
        } else {  // this slice's last row, begun in this slice
          if (!tail_cut || (single && head_cut)) continue;
          slot = 1;
          row = last_row;
          from_prev_tile = false;
        }
        float acc[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = s_part[(slot * VEC + j) * kGsThreads + threadIdx.x];
        bool open = slot == 1;
        for (int h = g + 1; open; ++h) {
          const int j0 = h * slice;
          if (j0 >= n) break;  // continues past the tile
          const int j1 = min(j0 + slice, n);
          const int js = (s_dst[j1 - 1] == row && s_dst[j1] == row) ? 1 : 0;
          const int t = (h << lanes_log2) + lane;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += s_part[(js * VEC + j) * kGsThreads + t];
          open = js == 1;
        }
        if (open) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) my_carry[f + c + j] = acc[j];
        } else if (from_prev_tile) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) my_carry[c + j] = acc[j];
        } else {
          store_row<T, VEC>(out, row, n_rows, f, c, acc);
        }
      }
    }
    __syncthreads();  // s_part is reused by the next column pass
  }
  // last, so that the tiles' HBM writes spread over the time they finish
  zero_empty_blocks<T, VEC>(row_start, out, n_rows / kBlockRows, f, n_edges);
#ifdef ALAZ_K4_TIMELINE
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  K4_STAMP(3, global_ns());
  K4_STAMP(4, smid);
#endif
}

// K4's row starts for the COO layout, as a search of the sorted dst would
// give them: row_start[b] is the first edge whose dst is at or past row
// 128·b (b = 0 .. n_rows/128; the last is the live-edge frontier). One
// pass over the edges, no search: edge e writes the blocks that start in
// (dst[e-1], dst[e]]; the blocks up to the first edge's get 0, those past
// the last edge's n_edges.
__device__ __forceinline__ int floor_block(int d) {
  return d >= 0 ? d / kBlockRows : -((kBlockRows - 1 - d) / kBlockRows);
}

__global__ void __launch_bounds__(256)
block_starts_kernel(const int* __restrict__ dst, int* __restrict__ row_start, int n_edges,
                    int n_blocks) {
  launch_dependents();  // the tile kernel may start loading its ids
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  // the blocks before the first edge's and after the last edge's, by all
  // threads together
  const int lead = n_edges > 0 ? min(floor_block(__ldg(dst)), n_blocks) : n_blocks;
  const int trail = n_edges > 0 ? max(floor_block(__ldg(dst + n_edges - 1)) + 1, 0) : 0;
  for (int b = gtid; b <= n_blocks; b += gridDim.x * blockDim.x) {
    if (b <= lead) row_start[b] = 0;
    else if (b >= trail) row_start[b] = n_edges;
  }
  // edges 1 .. n_edges-1, kStartsEdges consecutive ones a thread
  const long long first = (long long)gtid * kStartsEdges;
  if (first >= n_edges) return;
  int d[kStartsEdges + 1];  // dst[first - 1 .. first + kStartsEdges - 1]
  d[0] = first > 0 ? __ldg(dst + first - 1) : 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && first + kStartsEdges <= n_edges) {
#pragma unroll
    for (int q = 0; q < kStartsEdges / 4; ++q) {
      const Vec<int, 4> v = *reinterpret_cast<const Vec<int, 4>*>(dst + first + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[1 + 4 * q + k] = v.v[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kStartsEdges; ++j)
      d[1 + j] = first + j < n_edges ? __ldg(dst + first + j) : 0;
  }
#pragma unroll
  for (int j = 0; j < kStartsEdges; ++j) {
    const long long e = first + j;
    if (e < 1 || e >= n_edges) continue;
    const int hi = min(floor_block(d[1 + j]), n_blocks);
    for (int b = max(floor_block(d[j]) + 1, 0); b <= hi; ++b) row_start[b] = (int)e;
  }
}

// The rows cut by tile ends: the tile where such a row begins adds its
// carry and those of the following tiles, in tile order, and rounds once.
template <typename T>
__global__ void __launch_bounds__(kGsCarryThreads)
gather_scatter_carry_kernel(const int* __restrict__ dst, const int* __restrict__ row_start,
                            const float* __restrict__ carry, T* __restrict__ out, int n_rows,
                            int f, int n_edges) {
  wait_prerequisites();  // the tile kernel's carries
  const int frontier = live_frontier(row_start, n_rows, n_edges);
  const int tile = blockIdx.x;
  const int t0 = tile * kGsTile;
  if (t0 >= frontier) return;
  const int t1 = min(t0 + kGsTile, frontier);
  const int row = __ldg(dst + t1 - 1);
  if (t1 >= frontier || __ldg(dst + t1) != row) return;  // the last row ends in this tile
  if (__ldg(dst + t0) == row && t0 > 0 && __ldg(dst + t0 - 1) == row) return;  // begun earlier
  if (row < 0 || row >= n_rows) return;
  for (int c = threadIdx.x; c < f; c += kGsCarryThreads) {
    float acc = carry[((size_t)tile * 2 + 1) * f + c];
    for (int h = tile + 1;; ++h) {
      const int j0 = h * kGsTile, j1 = min(j0 + kGsTile, frontier);
      const bool through = __ldg(dst + j1 - 1) == row && j1 < frontier && __ldg(dst + j1) == row;
      acc += carry[((size_t)h * 2 + (through ? 1 : 0)) * f + c];
      if (!through) break;
    }
    out[(size_t)row * f + c] = from_f32<T>(acc);
  }
}

// Launch on the stream; overlap: the kernel may start before the one
// ahead of it on the stream ends (Programmatic Dependent Launch) and
// waits for it in cudaGridDependencySynchronize before reading its output.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), unsigned grid, unsigned block, int smem,
                   cudaStream_t stream, bool overlap, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = overlap ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int VEC>
cudaError_t launch_gather_scatter_vec(const T* x, const int* src, const int* dst, const T* w,
                                      int* row_start, bool find_starts, T* out, float* carry,
                                      int n_rows, int n_rows_x, int f, int n_edges,
                                      cudaStream_t stream) {
  const int n_tiles = (n_edges + kGsTile - 1) / kGsTile;
  const int n_blocks = n_rows / kBlockRows;
  const int chunks = (f + VEC - 1) / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const GsLayout lay(VEC, f * (int)sizeof(T));
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err;
  if (find_starts) {
    const long long ctas = ((long long)n_edges + 256 * kStartsEdges - 1) / (256 * kStartsEdges);
    block_starts_kernel<<<(unsigned)(ctas > 0 ? ctas : 1), 256, 0, stream>>>(dst, row_start,
                                                                            n_edges, n_blocks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // overlapping the tile kernel with the one before it is safe only when
  // that is the starts kernel: the ids it reads early may come from any
  // earlier work
  auto kernel = gather_scatter_tile_kernel<T, VEC>;
  if ((err = allow_smem(kernel, lay.total)) != cudaSuccess) return err;
  const unsigned grid = (unsigned)max(n_tiles, (n_blocks + 7) / 8);
  err = launch(kernel, grid, kGsThreads, lay.total, stream, find_starts, x, src, dst, w,
               (const int*)row_start, out, carry, n_rows, n_rows_x, f, n_edges, lanes_log2);
  if (err != cudaSuccess || n_tiles == 0) return err;
  return launch(gather_scatter_carry_kernel<T>, n_tiles, kGsCarryThreads, 0, stream, true, dst,
                (const int*)row_start, (const float*)carry, out, n_rows, f, n_edges);
}

template <typename T>
cudaError_t launch_gather_scatter(const void* x, const int* src, const int* dst, const void* w,
                                  int* row_start, bool find_starts, void* out, float* carry,
                                  int n_rows, int n_rows_x, int f, int n_edges, int vec,
                                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (vec * (int)sizeof(T) == 16)
    return launch_gather_scatter_vec<T, 16 / sizeof(T)>(xt, src, dst, wt, row_start, find_starts,
                                                         o, carry, n_rows, n_rows_x, f, n_edges,
                                                         stream);
  if (vec == 4 && sizeof(T) == 2)
    return launch_gather_scatter_vec<T, 4>(xt, src, dst, wt, row_start, find_starts, o, carry,
                                           n_rows, n_rows_x, f, n_edges, stream);
  if (vec == 1)
    return launch_gather_scatter_vec<T, 1>(xt, src, dst, wt, row_start, find_starts, o, carry,
                                           n_rows, n_rows_x, f, n_edges, stream);
  return cudaErrorInvalidValue;
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
// [n_rows/128 + 1] int32 (its last entry is the live-edge frontier;
// find_starts != 0: computed here from dst, as the COO layout's search),
// out [n_rows, f] (dtype), carry [ceil(n_edges / tile), 2, f] f32
// scratch (tile: alaz_gather_scatter_tile_edges()).
// vec: elements a lane moves at once; 16 bytes' worth (8 bf16, 4 f32)
// or 4 bf16 when f is a multiple and x and out are aligned to it, else 1.
int alaz_gather_scatter_sum(const void* x, const void* src, const void* dst, const void* w,
                            void* row_start, int find_starts, void* out, void* carry, int n_rows,
                            int n_rows_x, int f, int n_edges, int dtype, int vec, void* stream) {
  const int* sp = static_cast<const int*>(src);
  const int* dp = static_cast<const int*>(dst);
  int* rs = static_cast<int*>(row_start);
  float* cy = static_cast<float*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gather_scatter<float>(x, sp, dp, w, rs, find_starts != 0, out, cy, n_rows,
                                        n_rows_x, f, n_edges, vec, s);
  if (dtype == kBF16)
    return launch_gather_scatter<__nv_bfloat16>(x, sp, dp, w, rs, find_starts != 0, out, cy,
                                                n_rows, n_rows_x, f, n_edges, vec, s);
  return cudaErrorInvalidValue;
}

// K4's live edges per tile: the carry scratch has 2 rows per tile.
int alaz_gather_scatter_tile_edges(void) { return kGsTile; }

#ifdef ALAZ_K4_TIMELINE
// Copy K4's timeline of the last launch ([kTimelineCtas, 5] u64) to host.
int alaz_k4_timeline(void* host) {
  return cudaMemcpyFromSymbol(host, g_k4_timeline, sizeof(g_k4_timeline));
}
#endif

const char* alaz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
