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
//     No atomics on the sums and a fixed order: results are deterministic,
//     and the COO and blocked layouts give bit-identical rows. Rows without
//     edges get zeros; every output row is written exactly once.
//     Long runs. One warp walks a run kUnroll rows a round, one memory
//     latency each (~0.8 us: a 9,152-edge run took ~950 us, the rest of a
//     131,072-row grid ~25 us; PERF.md). So a row whose run is longer than
//     kSplitRun = 256 edges -- about what one warp walks while the rest of
//     that grid runs -- is split: its row warp leaves it, and chunk warps,
//     one for each kChunk = 128 consecutive edges of the edge axis, sum it
//     in the same launch. They come first in the grid, so their walks (16
//     rounds) overlap the row warps' (placed last, the 9,152-edge run's K1
//     took 60 us instead of 37). A chunk warp probes four edges (its first
//     and last, the first of the chunk before and the last of the chunk
//     after): a run of more than 2 * kChunk edges covers a whole chunk, so
//     these show every split row that meets the chunk. The warp finds such
//     a row's run by the row warps' search, sums its part in f32 in edge
//     order into a scratch slot (two a chunk: the row holding its first
//     edge, and one starting inside it), then arrives at a counter kept by
//     the row's first chunk; the last to arrive adds the row's partials in
//     chunk order, rounds once and writes the row. A row of at most
//     kSplitRun edges is summed as before, bit for bit. The partition
//     depends on edge positions alone, so COO and blocked rows still agree
//     bit for bit. The counters carry the launch's epoch (rising from launch
//     to launch on a stream; an atomicMax lifts an older count to zero), so
//     no launch clears them; they are the only atomics. Each launch adds its
//     split rows and their edges to two device totals (alaz_k1_split_counts).
//     kChunk: 64 made the 1M-edge windows' K1 ~10 us slower (their runs of
//     ~105 edges cover 64-edge chunks, whose warps then search); 256 made
//     the 9,152-edge run's K1 47 us (its chunk walks, 32 rounds, outlast the
//     row grid). A warp-wide 33-way search in place of the binary one saved
//     ~1 us a launch and was left out.
//     What bounds it now (PERF.md): at the TGN stream's shape (~37 us
//     against a 13.8 us bound), the row grid (~27 us with no long run: the
//     131,072 rows' searches and writes), then the split row's combine, one
//     warp adding a partial a chunk in turn (~0.08 us each, 72 there). The
//     chunk warps cost a window with no long run ~2 us.
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
//
// SORT alaz_sort_by_ids
//     Replaces no TPU kernel. The JAX package's backward passes of K3 and
//     K4 are XLA scatters (alaz_tpu/ops/pallas_segment.py, the custom_vjp
//     backward rules of gather_rows_banded and pallas_gather_scatter_sum);
//     the port sums them with K4 over the ids' stable sort instead, in a
//     fixed order, so that two runs give the same bits. This kernel is that
//     sort: it replaces torch.argsort and the gathers by its permutation in
//     K3's backward (segment_kernels.py unsorted_segment_sum) and K4's dx.
//     It sorts the ids stably by the key clamp(id, -1, n_rows) + 1: every
//     negative id sorts as 0, an id at or past n_rows as n_rows + 1, so
//     every in-range edge lands where torch.argsort(ids, stable=True) puts
//     it and K4 cuts the in-range edges into the same tiles. Out: the ids
//     decoded (key - 1), the permutation (int32) and up to one int32 and one
//     f32 payload carried into sorted order.
//     Bound on the H100: bytes. The ids read once (4 B an edge), the sorted
//     ids and the permutation written once (8 B), each payload read and
//     written once (8 B): 12 MB, 3.76 us at E = 1M with no payload.
//     Design: LSD radix passes over bit_length(n_rows + 1) bits, digits of
//     at most 9 bits (two passes at N = 131,072), each pass reduce then scan,
//     three kernels launched plainly (Programmatic Dependent Launch was no
//     faster, PERF.md):
//     - an upsweep counts each tile's digits (4,096 keys a CTA of 512
//       threads) by shared-memory atomics into a warp's own counters:
//       exact counts whatever their order;
//     - a scan (a warp a digit) turns the digit-major [bins x tiles] counts
//       into each tile's first slot of each digit, in tile order, which
//       makes the sort stable across tiles;
//     - a downsweep reloads its tile into shared memory by one bulk copy
//       (cp.async.bulk under an mbarrier) while its counts load, ranks each
//       key inside the tile in position order (the lanes of a warp
//       instruction that share a digit found by one ballot a digit bit, a
//       warp's digit counters in shared memory, scanned over warps), stages
//       the tile in digit order in shared memory and writes each digit's
//       run out contiguously.
//     The first pass encodes the ids as it reads them and makes the edge
//     indices itself; the last writes the decoded ids, the permutation and
//     the payloads (gathered through the permutation, from L2). No int64,
//     no atomics in global memory, no host sync: the passes and tiles come
//     from E and n_rows. One tile (E <= 4,096: the train CLI's windows)
//     runs the same passes with one CTA each: a one-CTA kernel for it
//     saved ~5 us of device time a sort and left the train CLI's step
//     where it was (PERF.md).
//     What sets the pace (PERF.md): the downsweep's ranking, the ballots'
//     instructions (2 CTAs an SM, one wave at E = 1M); then the writes,
//     each tile's load and six launches. Between passes the keys and the
//     permutation are written and read once more (16 B an edge, mostly in
//     L2) and each upsweep reads the keys once more: the bound counts none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;  // dst rows per extent block (EDGE_BLOCK_ROWS)
constexpr int kWarps = 8;        // warps per CTA: one dst row each
constexpr int kUnroll = 8;       // message rows in flight per lane
constexpr int kChunk = 128;      // K1: edges of a split row one chunk warp sums
constexpr int kSplitRun = 256;   // K1: a row's run longer than this is split
// A split row then covers at least one whole chunk (a run of 2 * kChunk + 1
// edges always does), which is what the chunk warps' probes look for.
static_assert(kSplitRun >= 2 * kChunk, "a split row must cover a whole chunk");

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

// K1's chunks for n_edges edges: a chunk warp each
__host__ __device__ constexpr int k1_chunks(int n_edges) {
  return n_edges / kChunk + (n_edges % kChunk != 0);
}

// K1's split rows and their edges, summed over every launch on the device
// (read by alaz_k1_split_counts)
__device__ unsigned long long g_k1_split[2];

// acc += msgs[e][c .. c + VEC) for e in [s, t), in edge order, kUnroll
// rows in flight per lane; ``col`` is msgs + c
template <typename InT, int VEC>
__device__ __forceinline__ void sum_run(const InT* __restrict__ col, int f, int s, int t,
                                        float (&acc)[VEC]) {
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
}

// VEC f32 partial sums, read from L2: another SM wrote them
template <int VEC>
__device__ __forceinline__ Vec<float, VEC> load_partial(const float* p);
template <>
__device__ __forceinline__ Vec<float, 4> load_partial<4>(const float* p) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  Vec<float, 4> r;
  r.v[0] = v.x;
  r.v[1] = v.y;
  r.v[2] = v.z;
  r.v[3] = v.w;
  return r;
}
template <>
__device__ __forceinline__ Vec<float, 1> load_partial<1>(const float* p) {
  Vec<float, 1> r;
  r.v[0] = __ldcg(p);
  return r;
}

// One arrival at a split row's counter, tagged with the launch's epoch:
// returns the arrivals of this launch before this one. Epochs rise from
// launch to launch on a stream, so the max lifts a count left by an
// earlier launch to (epoch, 0) and no launch has to clear the counters;
// two atomics, no retry loop, whatever the number of arrivals.
__device__ __forceinline__ unsigned arrive(unsigned long long* ctr, unsigned epoch) {
  const unsigned long long tag = (unsigned long long)epoch << 32;
  atomicMax(ctr, tag);
  return (unsigned)atomicAdd(ctr, 1ull);
}

// Chunk c's share of split row r (if r is one, and meets the chunk): its
// edges in [a, b) summed in f32 in edge order into partials[c][slot] (slot
// 0 for the row holding edge a, 1 for a row starting past it), then one
// arrival at the counter of the row's first chunk. The last of the row's
// chunks to arrive adds their partials in chunk order, rounds once and
// writes the row.
template <typename InT, typename OutT, int VEC>
__device__ void split_part(const InT* __restrict__ msgs, const int* __restrict__ dst,
                           const int* __restrict__ row_start, OutT* __restrict__ out,
                           float* __restrict__ partials, unsigned long long* __restrict__ counters,
                           unsigned epoch, int n_rows, int f, int n_edges, int c, int a, int b,
                           int r, int lane) {
  if (r < 0 || r >= n_rows) return;
  int s, t;
  row_run(dst, row_start, r, n_edges, s, t);  // as its row warp finds it
  const int from = max(s, a), to = min(t, b);
  if (t - s <= kSplitRun || from >= to) return;
  const int c0 = s / kChunk, c1 = (t - 1) / kChunk;
  const int first_slot = s != c0 * kChunk;  // the row's first chunk holds it in slot 1
  float* part = partials + ((size_t)c * 2 + (c == c0 ? first_slot : 0)) * f;
  for (int col = lane * VEC; col < f; col += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    sum_run<InT, VEC>(msgs + col, f, from, to, acc);
    Vec<float, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = acc[k];
    *reinterpret_cast<Vec<float, VEC>*>(part + col) = o;
  }
  __threadfence();  // this lane's partials before the arrival
  __syncwarp();
  unsigned before = 0;
  if (lane == 0) before = arrive(counters + c0, epoch);
  before = __shfl_sync(0xffffffffu, before, 0);
  if (before + 1u != (unsigned)(c1 - c0 + 1)) return;
  __threadfence();  // every chunk's partials are in; read them from L2
  OutT* orow = out + (size_t)r * f;
  for (int col = lane * VEC; col < f; col += 32 * VEC) {
    float acc[VEC];
    Vec<float, VEC> p = load_partial<VEC>(partials + ((size_t)c0 * 2 + first_slot) * f + col);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = p.v[k];
    int k0 = c0 + 1;
    for (; k0 + kUnroll <= c1 + 1; k0 += kUnroll) {
      Vec<float, VEC> q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q[u] = load_partial<VEC>(partials + (size_t)(k0 + u) * 2 * f + col);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += q[u].v[k];
    }
    for (; k0 <= c1; ++k0) {
      p = load_partial<VEC>(partials + (size_t)k0 * 2 * f + col);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += p.v[k];
    }
    Vec<OutT, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<OutT>(acc[k]);
    *reinterpret_cast<Vec<OutT, VEC>*>(orow + col) = o;
  }
  if (lane == 0) {
    atomicAdd(&g_k1_split[0], 1ull);
    atomicAdd(&g_k1_split[1], (unsigned long long)(t - s));
  }
}

// The first chunk_ctas CTAs hold the chunk warps, one per kChunk edges,
// ahead of the row warps so that a split row's walk overlaps theirs.
template <typename InT, typename OutT, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
scatter_sum_sorted_kernel(const InT* __restrict__ msgs, const int* __restrict__ dst,
                          const int* __restrict__ row_start, OutT* __restrict__ out,
                          float* __restrict__ partials, unsigned long long* __restrict__ counters,
                          unsigned epoch, int n_rows, int f, int n_edges, int chunk_ctas) {
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x < chunk_ctas) {
    const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (c >= k1_chunks(n_edges)) return;
    const int a = c * kChunk;
    const int b = a + min(kChunk, n_edges - a);
    // A split row (longer than 2 * kChunk edges) that holds edge a covers
    // the chunk (edge b - 1 is the row's) or ends in it (then it covers
    // the chunk before, and edge a - kChunk is the row's); one that starts
    // past edge a covers the next chunk (the row's last edge there too).
    const int first = __ldg(dst + a);
    const int last = __ldg(dst + b - 1);
    const int back = c > 0 ? __ldg(dst + a - kChunk) : first;
    const int next_last = __ldg(dst + a + min(2 * kChunk, n_edges - a) - 1);
    if (last == first || (c > 0 && back == first))
      split_part<InT, OutT, VEC>(msgs, dst, row_start, out, partials, counters, epoch, n_rows, f,
                                 n_edges, c, a, b, first, lane);
    if (last != first && next_last == last)
      split_part<InT, OutT, VEC>(msgs, dst, row_start, out, partials, counters, epoch, n_rows, f,
                                 n_edges, c, a, b, last, lane);
    return;
  }
  const int row = (blockIdx.x - chunk_ctas) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  int s, t;
  row_run(dst, row_start, row, n_edges, s, t);
  if (t - s > kSplitRun) return;  // the chunk warps sum and write it
  OutT* orow = out + (size_t)row * f;
  for (int c = lane * VEC; c < f; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    sum_run<InT, VEC>(msgs + c, f, s, t, acc);
    Vec<OutT, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<OutT>(acc[k]);
    *reinterpret_cast<Vec<OutT, VEC>*>(orow + c) = o;
  }
}

template <typename InT, typename OutT>
cudaError_t launch_scatter(const void* msgs, const int* dst, const int* row_start, void* out,
                           float* partials, unsigned long long* counters, unsigned epoch,
                           int n_rows, int f, int n_edges, int vec, cudaStream_t stream) {
  const int chunk_ctas = (k1_chunks(n_edges) + kWarps - 1) / kWarps;
  const dim3 grid(chunk_ctas + (n_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const InT* m = static_cast<const InT*>(msgs);
  OutT* o = static_cast<OutT*>(out);
  if (vec == 4) {
    scatter_sum_sorted_kernel<InT, OutT, 4><<<grid, block, 0, stream>>>(
        m, dst, row_start, o, partials, counters, epoch, n_rows, f, n_edges, chunk_ctas);
  } else if (vec == 1) {
    scatter_sum_sorted_kernel<InT, OutT, 1><<<grid, block, 0, stream>>>(
        m, dst, row_start, o, partials, counters, epoch, n_rows, f, n_edges, chunk_ctas);
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

// ---------------------------------------------------------------------------
// SORT: stable LSD radix sort of int32 ids by node
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 512;                     // threads per sort CTA
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;                         // keys a thread
constexpr int kSortTile = kSortThreads * kSortItems;  // keys a tile: 4,096
constexpr int kSortWarpKeys = 32 * kSortItems;        // a warp's run of the tile
constexpr int kSortDigitBits = 9;                     // most bits a pass
constexpr int kSortBins = 1 << kSortDigitBits;
constexpr int kSortBinsPerThread = (kSortBins + kSortThreads - 1) / kSortThreads;

// A sort CTA's dynamic shared memory: the tile's keys and values (the bulk
// copy's targets, then the tile staged in digit order), each warp's digit
// counters, the tile's first slot and the pass's first global slot of each
// digit, and the bulk copy's mbarrier.
struct SortSmem {
  int keys[kSortTile];
  int vals[kSortTile];
  int cnt[kSortWarps * kSortBins];
  int start[kSortBins];
  int goff[kSortBins];
  int warp_sums[kSortWarps];
  unsigned long long bar;
};

// 0 for a negative id, id + 1 in range, n_rows + 1 at or past n_rows
__device__ __forceinline__ int sort_key(int id, int n_rows) {
  return id < 0 ? 0 : (id >= n_rows ? n_rows + 1 : id + 1);
}

// the bits of the largest key, n_rows + 1; the passes split them as evenly
// as they can, low bits first
__host__ __device__ inline int sort_key_bits(int n_rows) {
  int b = 0;
  for (long long v = (long long)n_rows + 1; v > 0; v >>= 1) ++b;
  return b;
}
__host__ __device__ inline int sort_passes(int key_bits) {
  return (key_bits + kSortDigitBits - 1) / kSortDigitBits;
}
__host__ __device__ inline int sort_pass_bits(int key_bits, int passes, int p) {
  return key_bits / passes + (p < key_bits % passes ? 1 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// exclusive prefix sum of v over the sort CTA's threads in order; total
// gets the sum. Every thread of the CTA must call it. (K4's
// block_exclusive_scan, for the sort's 512 threads.)
__device__ __forceinline__ int sort_block_scan(int v, int* s_warp, int& total) {
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
  for (int i = 0; i < kSortWarps; ++i) {
    const int t = s_warp[i];
    before += i < warp ? t : 0;
    total += t;
  }
  __syncthreads();  // s_warp is reused by the next scan
  return before + x - v;
}

// Start loading the tile's n ints at keys (and at vals, if not null) into
// shared memory: the 16-byte-aligned whole 16-byte part of each by one bulk
// copy that thread 0 issues under the mbarrier, the rest by plain loads.
// Returns whether the bulk copy was issued. Every thread must call, then
// wait_sort_tile with what this returned.
__device__ bool load_sort_tile(SortSmem& s, const int* keys, const int* vals, int n) {
  auto bulk_bytes = [n](const int* g) -> unsigned {
    return (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? 4u * (unsigned)(n & ~3) : 0u;
  };
  const unsigned kb = bulk_bytes(keys);
  const unsigned vb = vals ? bulk_bytes(vals) : 0u;
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(&s.bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (kb + vb) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(kb + vb)
                   : "memory");
      if (kb)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(smem_u32(s.keys)), "l"(reinterpret_cast<uint64_t>(keys)), "r"(kb), "r"(bar)
            : "memory");
      if (vb)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(smem_u32(s.vals)), "l"(reinterpret_cast<uint64_t>(vals)), "r"(vb), "r"(bar)
            : "memory");
    }
  }
  for (int i = (int)(kb / 4) + threadIdx.x; i < n; i += kSortThreads) s.keys[i] = __ldg(keys + i);
  if (vals)
    for (int i = (int)(vb / 4) + threadIdx.x; i < n; i += kSortThreads) s.vals[i] = __ldg(vals + i);
  return kb + vb > 0;
}

// On return every thread sees the whole tile.
__device__ void wait_sort_tile(SortSmem& s, bool bulk) {
  __syncthreads();  // the mbarrier's init and the plain loads, for every thread
  if (bulk) {
    unsigned done = 0;
    do {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(smem_u32(&s.bar)) : "memory");
    } while (!done);
  }
}

// Rank a warp's keys by digit in the warp's counters cnt (zeroed here):
// key[j] sits at tile slot base + 32 j (base: the warp's first slot plus
// the lane); a slot at or past n is left out. rank[j] = the keys of its
// digit in the warp's slots before it. The lanes of one instruction that
// share a digit find each other by a ballot a digit bit (a fixed cost,
// where __match_any_sync's grows with the distinct digits), all of the
// instructions' ballots first, for they do not depend on the counters;
// then each group reads its counter and the lowest lane of it writes it
// back, so no two lanes write one.
__device__ __forceinline__ void warp_rank(const int (&key)[kSortItems], int base, int n, int shift,
                                          int bits, int* cnt, int (&rank)[kSortItems]) {
  const int lane = threadIdx.x & 31;
  const int bins = 1 << bits;
  for (int b = lane; b < bins; b += 32) cnt[b] = 0;
  const unsigned below = (1u << lane) - 1u;
  const bool partial = n < kSortTile;
  unsigned peers[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const unsigned d = (unsigned)(key[j] >> shift) & (bins - 1);
    peers[j] = 0xffffffffu;
#pragma unroll
    for (int b = 0; b < kSortDigitBits; ++b) {
      if (b < bits) {
        const unsigned on = 0u - ((d >> b) & 1u);  // all ones where the bit is set
        peers[j] &= ~(__ballot_sync(0xffffffffu, on) ^ on);
      }
    }
    if (partial) {
      const unsigned on = 0u - (unsigned)(base + 32 * j < n);
      peers[j] &= ~(__ballot_sync(0xffffffffu, on) ^ on);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const unsigned d = (unsigned)(key[j] >> shift) & (bins - 1);
    const int c = cnt[d];
    rank[j] = c + __popc(peers[j] & below);
    __syncwarp();  // every lane has read before the group's lowest lane writes
    if ((peers[j] & below) == 0 && base + 32 * j < n) cnt[d] = c + __popc(peers[j]);
    __syncwarp();  // the next instruction's group of this digit reads the count
  }
}

// After every warp's warp_rank: cnt[w][b] becomes the keys of digit b in
// the warps before w, start[b] the tile's first slot of digit b. Every
// thread must call; ends synchronized.
__device__ void tile_digit_starts(SortSmem& s, int bins) {
  __syncthreads();
  const int b0 = threadIdx.x * kSortBinsPerThread;
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kSortBinsPerThread; ++q) {
    const int b = b0 + q;
    if (b < bins) {
      int c[kSortWarps];
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) c[w] = s.cnt[w * kSortBins + b];
      int run = 0;
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        s.cnt[w * kSortBins + b] = run;
        run += c[w];
      }
      s.start[b] = run;
      sum += run;
    }
  }
  int total;
  int at = sort_block_scan(sum, s.warp_sums, total);
#pragma unroll
  for (int q = 0; q < kSortBinsPerThread; ++q) {
    const int b = b0 + q;
    if (b < bins) {
      const int c = s.start[b];
      s.start[b] = at;
      at += c;
    }
  }
  __syncthreads();
}

// One pass over the tile in shared memory: each thread takes its keys (the
// first pass encodes the ids and makes the values, the edge indices from
// t0), the warps rank them, and the tile is staged back in digit order,
// stably. Every thread must call; ends synchronized.
__device__ void sort_tile_pass(SortSmem& s, int n, int n_rows, int shift, int bits, bool first,
                               int t0) {
  const int warp = threadIdx.x >> 5;
  const int base = warp * kSortWarpKeys + (threadIdx.x & 31);
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int i = base + 32 * j;
    key[j] = i < n ? (first ? sort_key(s.keys[i], n_rows) : s.keys[i]) : 0;
    val[j] = i < n ? (first ? t0 + i : s.vals[i]) : 0;
  }
  int* cnt = s.cnt + warp * kSortBins;
  warp_rank(key, base, n, shift, bits, cnt, rank);
  tile_digit_starts(s, 1 << bits);
  const int mask = (1 << bits) - 1;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (base + 32 * j < n) {
      const int d = (key[j] >> shift) & mask;
      const int at = s.start[d] + cnt[d] + rank[j];
      s.keys[at] = key[j];
      s.vals[at] = val[j];
    }
  }
  __syncthreads();
}

// Pass upsweep: counts[b * n_tiles + tile] = the keys of digit b in the
// tile (first pass: the ids, encoded here), counted by shared-memory
// atomics into a warp's own counters: exact whatever their order.
__global__ void __launch_bounds__(kSortThreads)
sort_upsweep_kernel(const int* __restrict__ keys, int* __restrict__ counts, int n_keys,
                    int n_rows, int first, int shift, int bits, int n_tiles) {
  __shared__ int s_cnt[kSortWarps * kSortBins];
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kSortTile;
  const int n = min(kSortTile, n_keys - t0);
  const int base = warp * kSortWarpKeys + (threadIdx.x & 31);
  const int bins = 1 << bits;
  int key[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int i = base + 32 * j;
    key[j] = i < n ? __ldg(keys + t0 + i) : 0;
  }
  int* cnt = s_cnt + warp * kSortBins;
  for (int b = threadIdx.x & 31; b < bins; b += 32) cnt[b] = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (base + 32 * j < n) {
      const int k = first ? sort_key(key[j], n_rows) : key[j];
      atomicAdd(cnt + ((k >> shift) & (bins - 1)), 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kSortThreads) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) c += s_cnt[w * kSortBins + b];
    counts[(size_t)b * n_tiles + blockIdx.x] = c;
  }
}

// Pass scan, a warp a digit: each digit's counts become exclusive prefix
// sums over the tiles, in tile order; totals[b] = the digit's keys.
__global__ void __launch_bounds__(kSortThreads)
sort_scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int bins, int n_tiles) {
  constexpr int kChunks = 8;  // 32 tiles each, loaded before the first is scanned
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSortWarps + (threadIdx.x >> 5);
  if (b >= bins) return;
  int* c = counts + (size_t)b * n_tiles;
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32 * kChunks) {
    int v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int t = t0 + 32 * k + lane;
      v[k] = t < n_tiles ? c[t] : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      int x = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      const int t = t0 + 32 * k + lane;
      if (t < n_tiles) c[t] = carry + x - v[k];
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  if (lane == 0) totals[b] = carry;
}

// Pass downsweep: the tile ranked and staged in shared memory, each key and
// value written to its digit's slot of the pass: goff[d] (the tile's first
// global slot of digit d: the digits before d over all tiles, then digit d
// in the tiles before this one) plus its place among the tile's keys of d.
// The last pass writes the ids decoded and gathers the payloads.
__global__ void __launch_bounds__(kSortThreads)
sort_downsweep_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                      const int* __restrict__ counts, const int* __restrict__ totals,
                      int* __restrict__ keys_out, int* __restrict__ vals_out,
                      const int* __restrict__ pay_i, int* __restrict__ out_i,
                      const float* __restrict__ pay_f, float* __restrict__ out_f, int n_keys,
                      int n_rows, int shift, int bits, int n_tiles, int first, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortSmem& s = *reinterpret_cast<SortSmem*>(smem);
  const int t0 = blockIdx.x * kSortTile;
  const int n = min(kSortTile, n_keys - t0);
  const int bins = 1 << bits;
  // this tile's counts and the digits' totals, loaded while the tile comes
  // in and is ranked
  const int b0 = threadIdx.x * kSortBinsPerThread;
  int tot[kSortBinsPerThread], cts[kSortBinsPerThread];
#pragma unroll
  for (int q = 0; q < kSortBinsPerThread; ++q) {
    const bool in = b0 + q < bins;
    tot[q] = in ? __ldg(totals + b0 + q) : 0;
    cts[q] = in ? __ldg(counts + (size_t)(b0 + q) * n_tiles + blockIdx.x) : 0;
  }
  wait_sort_tile(s, load_sort_tile(s, keys_in + t0, first ? nullptr : vals_in + t0, n));
  sort_tile_pass(s, n, n_rows, shift, bits, first != 0, t0);
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kSortBinsPerThread; ++q) sum += tot[q];
  int total;
  int at = sort_block_scan(sum, s.warp_sums, total);
#pragma unroll
  for (int q = 0; q < kSortBinsPerThread; ++q) {
    if (b0 + q < bins) s.goff[b0 + q] = at + cts[q] - s.start[b0 + q];
    at += tot[q];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int i = threadIdx.x + j * kSortThreads;
    if (i < n) {
      const int k = s.keys[i];
      const int v = s.vals[i];
      const int o = s.goff[(k >> shift) & (bins - 1)] + i;
      keys_out[o] = last ? k - 1 : k;
      vals_out[o] = v;
      if (last && out_i) out_i[o] = __ldg(pay_i + v);
      if (last && out_f) out_f[o] = __ldg(pay_f + v);
    }
  }
}

long long sort_scratch_words(int n_keys) {
  const long long tiles = (n_keys + kSortTile - 1) / kSortTile;
  return 2LL * n_keys + (long long)kSortBins * (tiles + 1);
}

// The passes on the stream, each kernel launched plainly. Pass p writes the
// output buffers when an even number of passes follow it, else the scratch
// pair, so the last writes the outputs and no pass writes what it reads.
cudaError_t launch_sort(const int* ids, int* sorted_ids, int* perm, const int* pay_i, int* out_i,
                        const float* pay_f, float* out_f, int* scratch, int n_keys, int n_rows,
                        cudaStream_t stream) {
  if (n_keys < 0 || n_rows < 0 || n_rows == INT_MAX) return cudaErrorInvalidValue;
  if (n_keys == 0) return cudaSuccess;
  const int smem = (int)sizeof(SortSmem);
  cudaError_t err;
  if ((err = allow_smem(sort_downsweep_kernel, smem)) != cudaSuccess) return err;
  const int tiles = (n_keys + kSortTile - 1) / kSortTile;
  int* keys_b = scratch;
  int* vals_b = scratch + n_keys;
  int* counts = scratch + 2LL * n_keys;
  int* totals = counts + (long long)kSortBins * tiles;
  const int key_bits = sort_key_bits(n_rows);
  const int passes = sort_passes(key_bits);
  const int* kin = ids;
  const int* vin = nullptr;
  for (int p = 0, shift = 0; p < passes; ++p) {
    const int bits = sort_pass_bits(key_bits, passes, p);
    const int bins = 1 << bits;
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int* kout = to_out ? sorted_ids : keys_b;
    int* vout = to_out ? perm : vals_b;
    sort_upsweep_kernel<<<tiles, kSortThreads, 0, stream>>>(kin, counts, n_keys, n_rows, p == 0,
                                                            shift, bits, tiles);
    sort_scan_kernel<<<(bins + kSortWarps - 1) / kSortWarps, kSortThreads, 0, stream>>>(
        counts, totals, bins, tiles);
    sort_downsweep_kernel<<<tiles, kSortThreads, smem, stream>>>(
        kin, vin, counts, totals, kout, vout, pay_i, out_i, pay_f, out_f, n_keys, n_rows, shift,
        bits, tiles, p == 0, p == passes - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kin = kout;
    vin = vout;
    shift += bits;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype codes shared with segment_kernels.py
enum { kF32 = 0, kBF16 = 1 };

// K1. msgs [n_edges, f] (in_dtype), dst [n_edges] int32 dst-sorted,
// row_start [n_rows/128 + 1] int32, out [n_rows, f] (out_dtype).
// partials [ceil(n_edges / C), 2, f] f32 scratch and counters
// [ceil(n_edges / C)] u64, zeroed once and kept for the stream's later
// launches (C: alaz_scatter_sum_split_lengths); epoch: above every earlier
// launch's on the counters.
// vec: 4 when f % 4 == 0 and both buffers are 16-byte aligned, else 1.
int alaz_scatter_sum_sorted(const void* msgs, const void* dst, const void* row_start, void* out,
                            void* partials, void* counters, unsigned epoch, int n_rows, int f,
                            int n_edges, int in_dtype, int out_dtype, int vec, void* stream) {
  const int* d = static_cast<const int*>(dst);
  const int* rs = static_cast<const int*>(row_start);
  float* p = static_cast<float*>(partials);
  unsigned long long* c = static_cast<unsigned long long*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch_scatter<float, float>(msgs, d, rs, out, p, c, epoch, n_rows, f, n_edges, vec, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch_scatter<__nv_bfloat16, __nv_bfloat16>(msgs, d, rs, out, p, c, epoch, n_rows, f,
                                                         n_edges, vec, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch_scatter<__nv_bfloat16, float>(msgs, d, rs, out, p, c, epoch, n_rows, f, n_edges,
                                                vec, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch_scatter<float, __nv_bfloat16>(msgs, d, rs, out, p, c, epoch, n_rows, f, n_edges,
                                                vec, s);
  return cudaErrorInvalidValue;
}

// K1's split length and chunk length in edges: {kSplitRun, kChunk}.
void alaz_scatter_sum_split_lengths(int* host) {
  host[0] = kSplitRun;
  host[1] = kChunk;
}

// K1's split rows and their edges since the library was loaded, on the
// current device: {rows, edges}. Synchronous.
int alaz_k1_split_counts(void* host) {
  return cudaMemcpyFromSymbol(host, g_k1_split, sizeof(g_k1_split));
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

// SORT. ids [n_keys] int32 in any order, sorted by clamp(id, -1, n_rows) + 1
// (0 <= n_rows < INT_MAX); out sorted_ids (the clamped ids) and perm
// [n_keys] int32; pay_i -> out_i [n_keys] int32 and pay_f -> out_f [n_keys]
// f32 carried into sorted order, each pair null for no payload; scratch
// [alaz_sort_scratch_words(n_keys)] int32.
int alaz_sort_by_ids(const void* ids, void* sorted_ids, void* perm, const void* pay_i, void* out_i,
                     const void* pay_f, void* out_f, void* scratch, int n_keys, int n_rows,
                     void* stream) {
  return launch_sort(static_cast<const int*>(ids), static_cast<int*>(sorted_ids),
                     static_cast<int*>(perm), static_cast<const int*>(pay_i),
                     static_cast<int*>(out_i), static_cast<const float*>(pay_f),
                     static_cast<float*>(out_f), static_cast<int*>(scratch), n_keys, n_rows,
                     static_cast<cudaStream_t>(stream));
}

// The sort's int32 scratch words for n_keys ids.
long long alaz_sort_scratch_words(int n_keys) { return sort_scratch_words(n_keys); }

// The sort's keys per tile (a CTA each in every pass).
int alaz_sort_tile_keys(void) { return kSortTile; }

const char* alaz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
