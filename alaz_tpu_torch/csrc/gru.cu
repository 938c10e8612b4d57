// Hand-written Hopper (sm_90a) kernel for TGN's GRU memory update. Plain C
// interface, built with nvcc into the same shared library as segment.cu and
// loaded with ctypes (alaz_tpu_torch/ops/_build.py); the Python wrapper and
// the weights' packing live in alaz_tpu_torch/ops/gru_kernels.py.
//
// GRU alaz_gru_update
//     Replaces no TPU kernel: the JAX package leaves TGN's memory update
//     (alaz_tpu/models/tgn.py step) to XLA, which fuses it there. In PyTorch
//     the same update is three bf16 GEMMs, their bias adds, two concats and
//     some twenty element-wise launches over [rows, H] tensors, every
//     intermediate going to device memory and back. This kernel does the
//     whole update in one launch, every intermediate in registers:
//
//       x   = [bf16(m) | h]                    [rows, 2H]
//       r   = sigmoid(x W_r + b_r),  z = sigmoid(x W_z + b_z)
//       n   = tanh([bf16(r * m) | h] W_n + b_n)
//       m'  = mask ? (1 - z) * n + z * m : m    (f32)
//
//     and writes every row of a new [n_mem, H] f32 memory: the first n_pad
//     rows as above, the rows past them copied from the old memory.
//     Rounding is the plain path's (gru_kernels.py gru_update_plain): every
//     product's operands bf16 and its sum f32, rounded to bf16; the bias
//     added to that in f32 and rounded to bf16; sigmoid and tanh of that
//     bf16 value rounded to bf16; r * m in f32, rounded to bf16 as the
//     operand; the blend in f32 in the plain path's order, with __f*_rn so
//     that nothing contracts into an FMA. sigmoid is rcp.approx(1 +
//     __expf(-x)) and tanh is tanh.approx: on every bf16 input, rounded to
//     bf16, they give torch.sigmoid's and torch.tanh's bits (all 65,536
//     inputs checked on the card: tests/test_torch_cuda.py, through
//     alaz_gru_activations), at a fifth of the IEEE division's and tanhf's
//     cost. So only the order in which each product's terms are summed
//     differs from the plain path.
//     Bound on the H100: bytes. m read and m' written in f32, h in bf16 and
//     the mask, 1,281 B a row at H = 128: 168.7 MB for the 131,072-row
//     bucket, 50.4 us at 3.35 TB/s. The products are 3 x rows x 2H x H
//     multiply-adds, 25.8 GFLOP there, 26 us at 989 TFLOP/s.
//     Design:
//     - A persistent grid, one CTA of two warpgroups on each SM (1 CTA an
//       SM: the weights take the shared memory). Each CTA copies the three
//       weight matrices, packed once on the host, into shared memory (12 H^2
//       bytes: 192 KB at H = 128) with cp.async while its warps load their
//       first rows. A warpgroup owns 64 rows at a time (a warp 16) and
//       walks the tiles 2 * gridDim.x apart.
//     - wgmma m64nNk16 (bf16 in, f32 sums), the A operand in registers and
//       the weights read from shared memory by the tensor cores, once a
//       warpgroup (mma.sync's per-warp fragment loads of the weights held a
//       first version of this kernel to 270 us at the cell's shape). A
//       thread loads its rows straight into the A fragment layout: rows g
//       and g+8 of its warp's 16 (g = lane / 4) and the four columns
//       16b + 4q .. 16b + 4q + 3 (q = lane % 4) of every 16-column block b,
//       one 16-byte load of m (f32) and one 8-byte load of h (bf16) a row
//       and block, whole sectors a warp. The fragment's k slots 2q, 2q+1,
//       2q+8, 2q+9 then hold the logical columns 4q .. 4q+3: a permutation
//       of k that the packed weights repeat, so the sums are unchanged. The
//       output columns are permuted the same way (n8 tile 2b holds columns
//       16b + 4q + {0, 1}, tile 2b + 1 columns 16b + 4q + {2, 3}), so each
//       thread's sums are the same elements as its m registers: the
//       epilogue exchanges nothing between lanes, and r * m, rounded to
//       bf16, is already the A fragment of the n product.
//     - The weights: for each product, pass and 16-row k block, an N x 16
//       slab of 8 x 8 core matrices, K-major, no swizzle (LBO 128 B along
//       k, SBO 256 B along n).
//     - Each product runs in kGruPasses passes over a share of its output
//       columns, two sets of sums in turn, so that the tensor cores run the
//       next pass while the warps take the last one's epilogue: r's passes
//       in turn, then n and z of each pass, the next pass's n issued before
//       z's epilogue. The second warpgroup starts its first tile once the
//       first has taken r, so that their epilogues and products interleave.
//     - Registers: m in f32 and as bf16 fragments, h, r * m, two sets of
//       sums and n (bf16) of a pass: 240 at H = 128, no spills.
//     - The next tile's rows are prefetched into L2 while the current one
//       is computed.
//     What sets the pace (PERF.md): the epilogue's instructions (two
//     roundings and an activation an element for each gate, the blend) and
//     the products, in turn within a warpgroup; the rows' device-memory
//     stream runs under them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGruGroupWarps = 4;  // a warpgroup
constexpr int kGruGroups = 2;      // warpgroups a CTA
constexpr int kGruThreads = 32 * kGruGroupWarps * kGruGroups;
constexpr int kGruTileRows = 16 * kGruGroupWarps;  // rows a warpgroup takes at a time
// passes over each product's output columns (at most H / 16); the packing
// (gru_kernels.py GRU_PASSES) follows it
constexpr int kGruPasses = 4;
constexpr int kCoreLbo = 128;  // bytes between the two 8-element core matrices along k
constexpr int kCoreSbo = 256;  // bytes between 8-row core matrices along n

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The gate's input as the plain path rounds it: the product's sum rounded
// to bf16, the bias added in f32 and the sum rounded to bf16.
__device__ __forceinline__ float pre_activation(float acc, float bias) {
  return round_bf16(__fadd_rn(round_bf16(acc), bias));
}

// torch.sigmoid and torch.tanh of a bf16 value, rounded to bf16 (see above:
// bit for bit on every bf16 input). rcp.approx without .ftz keeps the
// subnormal results of inputs near -88, which __fdividef flushes to zero.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(1.0f + __expf(-x)));
  return round_bf16(y);
}

__device__ __forceinline__ float tanh_bf16(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return round_bf16(y);
}

// A shared-memory matrix descriptor: K-major, no swizzle
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(kCoreLbo >> 4) << 16) |
         ((uint64_t)(kCoreSbo >> 4) << 32);
}

// d (+)= a * B for one warpgroup: m64nNk16, bf16 operands, f32 sums, A from
// registers, B from shared memory (desc); scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<16>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, "
      "1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's wgmma groups are pending, then
// pin the n finished sums d after the wait.
template <int N>
__device__ __forceinline__ void wgmma_wait(float* d, int n) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float f4_at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int H>
struct GruTile {
  static constexpr int NB = H / 16;  // 16-column blocks of the output and of m, h
  static constexpr int KB = 2 * NB;  // 16-row k blocks of each product
  static constexpr int PASSES = NB < kGruPasses ? NB : kGruPasses;
  static constexpr int PB = NB / PASSES;          // output blocks a pass
  static constexpr int ACC = 8 * PB;              // sums a thread holds for a pass
  static constexpr int SLAB = 16 * PB * 32;       // bytes of a pass's k block of weights
  static constexpr int MAT = PASSES * KB * SLAB;  // bytes of one packed matrix

  float4 m_lo[NB], m_hi[NB];  // m, rows g and g + 8, columns 16b + 4q .. + 3
  uint2 h_lo[NB], h_hi[NB];   // h likewise, 4 bf16
  uint32_t ma[NB][4];         // bf16(m), the A fragment of each k block
  uint32_t rm[NB][4];         // bf16(r * m), likewise
  bool live_lo, live_hi;      // row < n_pad
  bool keep_lo, keep_hi;      // the node mask

  // Pass p of the product of [bf16(m) or bf16(r * m) | h] and the packed
  // matrix at shared address mat into acc, as one wgmma group.
  __device__ __forceinline__ void issue(bool with_rm, unsigned mat, int p, float* acc) const {
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t a[4];
      if (kb < NB) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = with_rm ? rm[kb][i] : ma[kb][i];
      } else {
        a[0] = h_lo[kb - NB].x;
        a[1] = h_hi[kb - NB].x;
        a[2] = h_lo[kb - NB].y;
        a[3] = h_hi[kb - NB].y;
      }
      wgmma<16 * PB>(acc, a, smem_desc(mat + (p * KB + kb) * SLAB), kb > 0);
    }
    wgmma_commit();
  }
};

// The sum of a pass for the thread's row (0: g, 1: g + 8) and column j
// (0..3) of the pass's block i: n8 tile 2i + (j >> 1), element j & 1 of
// the row's pair.
__device__ __forceinline__ float acc_at(const float* acc, int i, int row, int j) {
  return acc[8 * i + 4 * (j >> 1) + 2 * row + (j & 1)];
}

template <int H>
__global__ void __launch_bounds__(kGruThreads, 1)
    gru_update_kernel(const float* __restrict__ mem, const __nv_bfloat16* __restrict__ node_h,
                      const unsigned char* __restrict__ mask, const uint4* __restrict__ weights,
                      const __nv_bfloat16* __restrict__ bias, float* __restrict__ out, int n_pad,
                      int n_mem) {
  using T = GruTile<H>;
  constexpr int NB = T::NB, PB = T::PB, ACC = T::ACC, PASSES = T::PASSES;
  extern __shared__ uint4 smem[];
  __nv_bfloat16* s_bias =
      reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) + 3 * T::MAT);  // r, z, n

  // the weights into shared memory, asynchronously, and the biases
  const unsigned w_r = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  for (int i = threadIdx.x; i < 3 * T::MAT / 16; i += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(w_r + 16u * i),
                 "l"(weights + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) s_bias[i] = bias[i];
  const unsigned w_z = w_r + T::MAT, w_n = w_r + 2 * T::MAT;
  const __nv_bfloat16* b_r = s_bias;
  const __nv_bfloat16* b_z = s_bias + H;
  const __nv_bfloat16* b_n = s_bias + 2 * H;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int group = warp / kGruGroupWarps;
  const int wrow = 16 * (warp % kGruGroupWarps);  // the warp's rows in its group's tile
  const int n_tiles = (n_pad + kGruTileRows - 1) / kGruTileRows;
  const int stride = gridDim.x * kGruGroups;
  T tile;

  auto load = [&](int t) {
    const int r0 = t * kGruTileRows + wrow + g, r1 = r0 + 8;
    tile.live_lo = r0 < n_pad;
    tile.live_hi = r1 < n_pad;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const uint2 zero2 = make_uint2(0u, 0u);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int col = 16 * b + 4 * q;
      tile.m_lo[b] = tile.live_lo
          ? __ldcs(reinterpret_cast<const float4*>(mem + (size_t)r0 * H + col)) : zero4;
      tile.m_hi[b] = tile.live_hi
          ? __ldcs(reinterpret_cast<const float4*>(mem + (size_t)r1 * H + col)) : zero4;
      tile.h_lo[b] = tile.live_lo
          ? __ldcs(reinterpret_cast<const uint2*>(node_h + (size_t)r0 * H + col)) : zero2;
      tile.h_hi[b] = tile.live_hi
          ? __ldcs(reinterpret_cast<const uint2*>(node_h + (size_t)r1 * H + col)) : zero2;
    }
    tile.keep_lo = tile.live_lo && mask[r0] != 0;
    tile.keep_hi = tile.live_hi && mask[r1] != 0;
  };

  // the warp's rows of a tile into L2: a 128-byte line a lane at a time
  auto prefetch = [&](int t) {
    const int r0 = t * kGruTileRows + wrow;
    const int rows = min(16, n_pad - r0);
    if (rows <= 0) return;
    const char* m_base = reinterpret_cast<const char*>(mem + (size_t)r0 * H);
    const char* h_base = reinterpret_cast<const char*>(node_h + (size_t)r0 * H);
    const int m_lines = (rows * H * 4 + 127) / 128, h_lines = (rows * H * 2 + 127) / 128;
    for (int i = lane; i < m_lines; i += 32)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(m_base + 128 * i));
    for (int i = lane; i < h_lines; i += 32)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(h_base + 128 * i));
  };

  int t = blockIdx.x * kGruGroups + group;
  if (t < n_tiles) load(t);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // The second warpgroup waits (named barrier 1) until the first has taken
  // r of its first tile; where the second has no tile, neither waits.
  bool stagger = blockIdx.x * kGruGroups + 1 < n_tiles;

  while (t < n_tiles) {
    if (stagger && group == 1) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kGruThreads) : "memory");
      stagger = false;
    }
    if (t + stride < n_tiles) prefetch(t + stride);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      tile.ma[b][0] = pack_bf16x2(tile.m_lo[b].x, tile.m_lo[b].y);
      tile.ma[b][1] = pack_bf16x2(tile.m_hi[b].x, tile.m_hi[b].y);
      tile.ma[b][2] = pack_bf16x2(tile.m_lo[b].z, tile.m_lo[b].w);
      tile.ma[b][3] = pack_bf16x2(tile.m_hi[b].z, tile.m_hi[b].w);
    }
    float acc0[ACC], acc1[ACC];

    // r pass by pass, the next pass's product running under this one's
    // epilogue; bf16(r * m) becomes the n product's A fragments
    tile.issue(false, w_r, 0, acc0);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      float* cur = (p & 1) ? acc1 : acc0;
      if (p + 1 < PASSES) {
        tile.issue(false, w_r, p + 1, (p & 1) ? acc0 : acc1);
        wgmma_wait<1>(cur, ACC);
      } else {
        wgmma_wait<0>(cur, ACC);
      }
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const int b = p * PB + i;
        float rmv[2][4];
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const float4& m = row ? tile.m_hi[b] : tile.m_lo[b];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bias = __bfloat162float(b_r[16 * b + 4 * q + j]);
            const float r = sigmoid_bf16(pre_activation(acc_at(cur, i, row, j), bias));
            rmv[row][j] = __fmul_rn(r, f4_at(m, j));
          }
        }
        tile.rm[b][0] = pack_bf16x2(rmv[0][0], rmv[0][1]);
        tile.rm[b][1] = pack_bf16x2(rmv[1][0], rmv[1][1]);
        tile.rm[b][2] = pack_bf16x2(rmv[0][2], rmv[0][3]);
        tile.rm[b][3] = pack_bf16x2(rmv[1][2], rmv[1][3]);
      }
    }
    if (stagger && group == 0) {
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kGruThreads) : "memory");
      stagger = false;
    }

    // n (acc0) and z (acc1) pass by pass: z's product runs under n's
    // epilogue, the next pass's n under z's; then the blend and the store
    const int r0 = t * kGruTileRows + wrow + g;
    tile.issue(true, w_n, 0, acc0);
    tile.issue(false, w_z, 0, acc1);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      wgmma_wait<1>(acc0, ACC);
      uint32_t npk[PB][2][2];  // n, bf16-valued: [block][row][column pair]
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const int b = p * PB + i;
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float nv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bias = __bfloat162float(b_n[16 * b + 4 * q + j]);
            nv[j] = tanh_bf16(pre_activation(acc_at(acc0, i, row, j), bias));
          }
          npk[i][row][0] = pack_bf16x2(nv[0], nv[1]);  // exact: bf16 values
          npk[i][row][1] = pack_bf16x2(nv[2], nv[3]);
        }
      }
      if (p + 1 < PASSES) {
        tile.issue(true, w_n, p + 1, acc0);
        wgmma_wait<1>(acc1, ACC);
      } else {
        wgmma_wait<0>(acc1, ACC);
      }
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const int b = p * PB + i;
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const float4& m = row ? tile.m_hi[b] : tile.m_lo[b];
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bias = __bfloat162float(b_z[16 * b + 4 * q + j]);
            const float z = sigmoid_bf16(pre_activation(acc_at(acc1, i, row, j), bias));
            const uint32_t pair = npk[i][row][j >> 1];
            const float n = (j & 1) ? bf16_hi(pair) : bf16_lo(pair);
            o[j] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, f4_at(m, j)));
          }
          const bool live = row ? tile.live_hi : tile.live_lo;
          const bool keep = row ? tile.keep_hi : tile.keep_lo;
          if (live) {
            const float4 v = keep ? make_float4(o[0], o[1], o[2], o[3]) : m;
            __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + 8 * row) * H + 16 * b + 4 * q),
                   v);
          }
        }
      }
      if (p + 1 < PASSES) tile.issue(false, w_z, p + 1, acc1);
    }

    t += stride;
    if (t < n_tiles) load(t);
  }

  // the rows past the bucket, as they were
  const size_t tail = (size_t)(n_mem - n_pad) * H / 4;
  const float4* src = reinterpret_cast<const float4*>(mem + (size_t)n_pad * H);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)n_pad * H);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < tail;
       i += (size_t)gridDim.x * blockDim.x)
    __stcs(dst + i, __ldcs(src + i));
}

constexpr int kGruDevices = 64;

// Once a device: the kernel's shared-memory allowance and the SM count
// (each launch sits inside the update's device-time span, so the launch
// path makes no attribute calls of its own after the first).
template <int H>
cudaError_t gru_device_setup(int smem, int* sms) {
  static int sm_count[kGruDevices];  // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kGruDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(gru_update_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

template <int H>
cudaError_t launch_gru(const float* mem, const __nv_bfloat16* node_h, const unsigned char* mask,
                       const uint4* weights, const __nv_bfloat16* bias, float* out, int n_pad,
                       int n_mem, cudaStream_t stream) {
  using T = GruTile<H>;
  const int smem = 3 * T::MAT + 3 * H * (int)sizeof(__nv_bfloat16);
  int sms = 0;
  cudaError_t err = gru_device_setup<H>(smem, &sms);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_pad + kGruTileRows - 1) / kGruTileRows;
  const int ctas = (n_tiles + kGruGroups - 1) / kGruGroups;
  const int grid = ctas < 1 ? 1 : (ctas < sms ? ctas : sms);
  gru_update_kernel<H><<<grid, kGruThreads, smem, stream>>>(mem, node_h, mask, weights, bias, out,
                                                            n_pad, n_mem);
  return cudaGetLastError();
}

// The kernel's sigmoid and tanh of n bf16 inputs: out [2][n] bf16
__global__ void gru_activations_kernel(const __nv_bfloat16* __restrict__ x,
                                       __nv_bfloat16* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = __bfloat162float(x[i]);
  out[i] = __float2bfloat16_rn(sigmoid_bf16(v));
  out[n + i] = __float2bfloat16_rn(tanh_bf16(v));
}

}  // namespace

extern "C" {

// GRU. memory [n_mem, h] f32 (n_mem >= n_pad), node_h [n_pad, h] bf16,
// mask [n_pad] bool, weights [3][2 h^2] bf16 (W_r, W_z, W_n, packed by
// gru_kernels.py pack_gru_weight for kGruPasses passes), bias [3][h] bf16
// (b_r, b_z, b_n), out [n_mem, h] f32; every buffer 16-byte aligned. h: 32,
// 64 or 128.
int alaz_gru_update(const void* memory, const void* node_h, const void* mask, const void* weights,
                    const void* bias, void* out, int n_pad, int n_mem, int h, void* stream) {
  const float* m = static_cast<const float*>(memory);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(node_h);
  const unsigned char* k = static_cast<const unsigned char*>(mask);
  const uint4* w = static_cast<const uint4*>(weights);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pad < 0 || n_mem < n_pad) return cudaErrorInvalidValue;
  if (n_mem == 0) return cudaSuccess;
  switch (h) {
    case 32: return launch_gru<32>(m, x, k, w, b, o, n_pad, n_mem, s);
    case 64: return launch_gru<64>(m, x, k, w, b, o, n_pad, n_mem, s);
    case 128: return launch_gru<128>(m, x, k, w, b, o, n_pad, n_mem, s);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel's sigmoid and tanh, rounded to bf16, of n bf16 inputs x: out
// [2][n] bf16 (sigmoid, then tanh).
int alaz_gru_activations(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  gru_activations_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
