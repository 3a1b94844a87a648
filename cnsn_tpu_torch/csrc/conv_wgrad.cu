// Weight gradient of a 3x3 / stride-1 / same-padding convolution (K4) for
// Hopper (sm_90a): two kernels, chosen per call by shape.
//
// Replaces cnsn_tpu/ops/pallas/conv_wgrad.py: wgrad3x3_tiled (def :143,
// pallas_call :170; batch-tiled, native-dtype operands with fp32 sums) and
// wgrad3x3_pallas (def :188, pallas_call :197; one image per grid step,
// operands cast to fp32).  Both compute, for NHWC x (B, H, W, Cin) and dy
// (B, H, W, Cout),
//   dW[kh][kw][ci][co] = sum_{b,h,w} x[b, h+kh-1, w+kw-1, ci] * dy[b, h, w, co]
// with x read as zero outside the image (the jnp.pad at :168 and :195), into
// a (3, 3, Cin, Cout) fp32 array: the TPU kernels' (9 * Cin, Cout) block.  A
// product of two bf16 values is exact in fp32, so bf16 operands with fp32
// accumulation give both entry points' result up to the order of the sums.
//
// Bound.  2 * B*H*W * 9 * Cin * Cout operations on (x + dy) bytes read once.
// At b=128 bf16 each stride-1 3x3 of ResNet-50 is 29.6 GFLOP, 0.030 ms at 989
// TFLOP/s, and layer1 reads 103 MB, 0.031 ms at 3.35 TB/s: both bounds are
// close, so the operations set it at layers 2-4 and the bytes at layer1.  A
// WRN-40-2 site is about 2.4 GFLOP and 4-17 MB.  Only the tensor cores'
// wgmma reaches that rate, fed from shared memory faster than threads can
// load it.
//
// Both kernels: one implicit GEMM, M = 9 * Cin, tap-major as the TPU
// kernel's block (row m is tap t = m / Cin, channel m mod Cin), N = Cout,
// reduced over the rows r = (b, h, w).  Split-K: where the output tiles leave
// the card short of blocks, the rows are cut into chunks, each block writes
// its fp32 partial tile to scratch that the caller allocates, and a second
// launch adds the chunks in order.  No atomics: dW has the same bits from
// run to run.
//
// wgmma kernel (bf16, Cin and Cout multiples of 64, x and dy 16-byte
// aligned: every stride-1 3x3 of ResNet-50 and 22 of WRN-40-2's 35).  A step
// of the reduction is one box of rows (b, h, w): bt images x ht rows x wt
// columns, wt * ht * bt a multiple of 16, planned per (B, H, W) on the host to
// waste few rows.  4-D TMA tensor maps over x and dy as (C, W, H, B), with the
// 128-byte swizzle, load 64 channels of a box as rows of 128 bytes: the
// MN-major tile that wgmma reads (both operands MN-major, the reduction
// running over the tile's rows).  For tap (kh, kw) the x box starts at
// (c0, w0 + kw - 1, h0 + kh - 1, b0): TMA fills every element outside the
// tensor with zero, negative coordinates included, so the tap shift and the
// image border come from the coordinates alone, and b is a dimension of its
// own, so no tap reads into the next image.  dy's box is unshifted; the
// padded columns and rows past the image read dy as zero and add nothing.  A
// block holds a 128 x 128 tile (128 x 64 where Cout = 64): two consumer
// warpgroups each run wgmma.m64n128k16 (m64n64k16) on a 64-row slice of M,
// one (tap, 64-channel block) each with its own x box, both on the same dy
// tile (two 64-channel boxes).  One producer thread keeps a ring of up to 4
// stages in flight, a full and an empty mbarrier per stage; the consumers
// keep one step's wgmma group in flight and release a stage once its group
// has completed.  Accumulator fragments are written straight to the
// (9 * Cin, Cout) partial.  Still to do: x is read once per tap (nine times
// per chunk, mostly from the L2), the grid is not persistent, and no warp
// is specialised by register count.
//
// wmma kernel (everything else: fp32, the narrow WRN shapes 3->16, 16->32,
// 32->32, unaligned views; TMA needs 16-byte aligned bases and strides, and
// a 64-row wgmma slice needs 64 channels of one tap).  A block computes one
// 64 x 64 tile over one chunk of rows, 32 rows per step.  A column of its x
// tile reads row r shifted by (kh-1)*W + (kw-1) for its tap, the zero border
// masked in the kernel; dy's rows are read as they are; ragged tiles and the
// chunk's last rows are masked to zero.  At Cin = 3 (the WRN stem) one tile
// holds all 27 rows, and x is read once.  bf16 tiles go through the tensor
// cores with nvcuda::wmma (16x16x16, fp32 accumulators); fp32 tiles take fp32
// FMAs without TF32, as the TPU's one-image kernel is fp32.  While a step's
// tiles are multiplied from shared memory, the next step's are loaded into
// registers.
#include "row_pass.cuh"  // cuda_bf16.h, and dispatch over (dtype, vec)

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <mma.h>

#include <algorithm>
#include <climits>
#include <mutex>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;       // rows of 9 * Cin per block tile
constexpr int kBN = 64;       // Cout per block tile
constexpr int kBK = 32;       // rows per step
constexpr int kThreads = 128;  // 4 warps
constexpr int kBlocksPerSm = 4;   // grid size the chunk count aims at
constexpr int kMinSteps = 16;     // rows of a chunk: at least 16 steps
constexpr int kMaxChunks = 1024;  // bounds the scratch and the second stage
constexpr int kLdC = kBN + 4;     // fp32 row of the output staging tile

// Shared-memory row length of an operand tile: 16 bytes of padding keeps
// wmma's 32-byte alignment and spreads the rows over the banks.
template <typename T>
struct Ld {
  static constexpr int value = kBM + 16 / static_cast<int>(sizeof(T));
};

// The bits one thread moves per load: one 16-byte vector, or one element.
template <typename T, int V>
struct Bits;
template <>
struct Bits<__nv_bfloat16, 8> { using type = uint4; };
template <>
struct Bits<__nv_bfloat16, 1> { using type = unsigned short; };
template <>
struct Bits<float, 4> { using type = float4; };
template <>
struct Bits<float, 1> { using type = float; };

__device__ __forceinline__ unsigned short ldg_bits(const unsigned short* p) {
  return __ldg(p);
}
__device__ __forceinline__ uint4 ldg_bits(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ float4 ldg_bits(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_bits(const float* p) { return __ldg(p); }

struct Problem {
  int rows;  // B * H * W
  int hw;    // H * W
  int h;
  int w;
  int cin;
  int cout;
  int m;     // 9 * cin: the GEMM's rows
  int chunk_rows;
};

// One step's operand tiles, held in registers between their load from
// device memory and their store to shared memory: kBK rows of kBM columns
// of shifted x (a; column m is tap m / cin, channel m mod cin) and of kBN
// channels of dy (b), V columns per load.  V divides cin, so the V columns
// of one load share a tap.
template <typename T, int V>
struct Stage {
  using Vec = typename Bits<T, V>::type;
  static constexpr int kVecsPerRow = kBM / V;
  static constexpr int kRowsPerPass = kThreads / kVecsPerRow;
  static constexpr int kPerThread = kBK / kRowsPerPass;
  static_assert(kBM == kBN, "one loop loads both operands");
  static_assert(kThreads % kVecsPerRow == 0 && kBK % kRowsPerPass == 0,
                "whole rows per pass, whole passes per step");

  Vec a[kPerThread];
  Vec b[kPerThread];
  // A thread loads one column of each tile, rows row0, row0 + kRowsPerPass,
  // ...; what the column needs is fixed for the whole block.
  int row0;
  bool a_live;  // column inside 9 * cin
  bool b_live;  // column inside cout
  int dh;       // the column's tap, as a row shift
  int dw;
  int a_off;    // x's element offset of the column: channel, less the shift
  int b_off;

  __device__ __forceinline__ Stage(const Problem& p, int m0, int n0) {
    const int c = (threadIdx.x % kVecsPerRow) * V;
    row0 = threadIdx.x / kVecsPerRow;
    a_live = m0 + c < p.m;
    b_live = n0 + c < p.cout;
    const int tap = a_live ? (m0 + c) / p.cin : 4;
    dh = tap / 3 - 1;
    dw = tap % 3 - 1;
    a_off = (dh * p.w + dw) * p.cin + m0 + c - tap * p.cin;
    b_off = n0 + c;
  }

  __device__ __forceinline__ void load(const T* __restrict__ x,
                                       const T* __restrict__ dy,
                                       const Problem& p, int k0, int r_end) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int r = k0 + row0 + i * kRowsPerPass;
      a[i] = Vec{};
      b[i] = Vec{};
      if (r >= r_end) continue;
      if (b_live) {
        b[i] = ldg_bits(reinterpret_cast<const Vec*>(
            dy + static_cast<size_t>(r) * p.cout + b_off));
      }
      if (a_live) {
        const int pix = r % p.hw;
        const int hh = pix / p.w + dh;
        const int ww = pix % p.w + dw;
        if (hh >= 0 && hh < p.h && ww >= 0 && ww < p.w) {
          // the shifted pixel is in the same image: hh is inside it
          a[i] = ldg_bits(reinterpret_cast<const Vec*>(
              x + static_cast<ptrdiff_t>(r) * p.cin + a_off));
        }
      }
    }
  }

  __device__ __forceinline__ void store(T* sa, T* sb) const {
    constexpr int ld = Ld<T>::value;
    const int col = (threadIdx.x % kVecsPerRow) * V;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int off = (row0 + i * kRowsPerPass) * ld + col;
      *reinterpret_cast<Vec*>(sa + off) = a[i];
      *reinterpret_cast<Vec*>(sb + off) = b[i];
    }
  }
};

// The block's 64 x 64 fp32 accumulator and the product of one step's tiles
// into it.  bf16: four warps in a 2 x 2 grid, each a 32 x 32 quarter as 2 x 2
// wmma fragments; sa holds a step's x tile as [row][m] (wmma's column-major
// A = x^T), sb dy's as [row][co] (row-major B).
template <typename T>
struct Acc;

template <>
struct Acc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int ld = Ld<T>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  __device__ __forceinline__ void step(const T* sa, const T* sb) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp % 2) * 32;
    const int wn = (warp / 2) * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], sa + kk * ld + wm + i * 16, ld);
        wmma::load_matrix_sync(b[i], sb + kk * ld + wn + i * 16, ld);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }

  // Through a shared staging tile, so that the writes are whole rows of Cout
  // and the ragged edges are masked.  Follows a __syncthreads().
  __device__ __forceinline__ void write(float* stage, float* __restrict__ out,
                                        const Problem& p, int m0, int n0) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp % 2) * 32;
    const int wn = (warp / 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + (wm + i * 16) * kLdC + wn + j * 16,
                                c[i][j], kLdC, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
      const int m = m0 + idx / kBN;
      const int n = n0 + idx % kBN;
      if (m < p.m && n < p.cout) {
        out[static_cast<size_t>(m) * p.cout + n] =
            stage[(idx / kBN) * kLdC + idx % kBN];
      }
    }
  }
};

// fp32: thread (tm, tn) owns rows 4 tm .. 4 tm + 3 and columns 8 tn .. 8 tn + 7.
template <>
struct Acc<float> {
  using T = float;
  static constexpr int ld = Ld<T>::value;
  float c[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const T* sa, const T* sb) {
    const int tm = (threadIdx.x % 16) * 4;
    const int tn = (threadIdx.x / 16) * 8;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sa + kk * ld + tm);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * ld + tn);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * ld + tn + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void write(float*, float* __restrict__ out,
                                        const Problem& p, int m0, int n0) {
    const int tm = m0 + (threadIdx.x % 16) * 4;
    const int tn = n0 + (threadIdx.x / 16) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (tm + i < p.m && tn + j < p.cout) {
          out[static_cast<size_t>(tm + i) * p.cout + tn + j] = c[i][j];
        }
      }
  }
};

constexpr int kOperandBytes = 2 * kBK * Ld<float>::value * 4;
constexpr int kStageBytes = kBM * kLdC * 4;
constexpr int kSmemBytes =
    kOperandBytes > kStageBytes ? kOperandBytes : kStageBytes;

// Grid (9 * Cin tiles * Cout tiles, chunks).  out: (chunks, 9 * Cin, Cout)
// fp32 partial sums, or dW itself when there is one chunk.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
wgrad3x3_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                float* __restrict__ out, Problem p) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  constexpr int ld = Ld<T>::value;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + kBK * ld;

  const int ntiles = (p.cout + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / ntiles) * kBM;
  const int n0 = (blockIdx.x % ntiles) * kBN;
  const int r_begin = blockIdx.y * p.chunk_rows;
  const int r_end = min(r_begin + p.chunk_rows, p.rows);

  Acc<T> acc;
  acc.zero();
  Stage<T, V> st(p, m0, n0);
  if (r_begin < r_end) st.load(x, dy, p, r_begin, r_end);
  for (int k0 = r_begin; k0 < r_end; k0 += kBK) {
    st.store(sa, sb);
    __syncthreads();
    if (k0 + kBK < r_end) st.load(x, dy, p, k0 + kBK, r_end);
    acc.step(sa, sb);
    __syncthreads();
  }
  const size_t plane = static_cast<size_t>(p.m) * p.cout;
  acc.write(reinterpret_cast<float*>(smem), out + blockIdx.y * plane, p, m0,
            n0);
}

// out[i] = sum over the chunks k = 0, 1, ... of part[k][i], in that order.
__global__ void __launch_bounds__(256)
wgrad3x3_finalize_kernel(const float* __restrict__ part,
                         float* __restrict__ out, size_t n, int chunks) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[static_cast<size_t>(k) * n + i];
    out[i] = s;
  }
}

template <typename T, int V>
struct Wgrad {
  static void run(const void* x, const void* dy, float* out, Problem p,
                  int chunks, cudaStream_t stream) {
    const int tiles = ((p.m + kBM - 1) / kBM) * ((p.cout + kBN - 1) / kBN);
    wgrad3x3_kernel<T, V><<<dim3(tiles, chunks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), out, p);
  }
};

int chunk_rows(int rows, int chunks) {
  const int per = (rows + chunks - 1) / chunks;
  return (per + kBK - 1) / kBK * kBK;
}

// The card's SM count and the shared memory a block may opt in to; false if
// the device cannot be queried.
bool card(int* sms, int* smem) {
  static int s = 0;
  static int m = 0;
  if (s == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      s = 0;
      return false;
    }
  }
  *sms = s;
  *smem = m;
  return true;
}

// ---- wgmma kernel ----------------------------------------------------------

constexpr int kWgConsumers = 2;  // consumer warpgroups, 64 rows of M each
constexpr int kWgThreads = kWgConsumers * 128 + 32;  // and one producer warp
constexpr int kWgMaxStages = 4;
constexpr int kWgMaxRows = 128;  // rows of (b, h, w) in one step's box
constexpr int kWgBoxC = 64;      // channels of a box: the 128-byte swizzle span
constexpr int kWgStepRows = 32;  // a step's fixed cost, in rows, for the plan
constexpr int kWgAlign = 1024;   // the swizzle pattern repeats every 8 rows

// What the host plans for one call.  A step is the box of rows bt images x
// ht image rows x wt columns starting at (b0, h0, w0); the steps run w
// fastest, then h, then b, and chunk y takes steps [y * steps / chunks,
// (y + 1) * steps / chunks).
struct WgPlan {
  int wt, ht, bt;
  int rows;        // wt * ht * bt, a multiple of 16
  int nw, nh;      // boxes across W and across H
  int steps;
  int cin_blocks;  // cin / 64
  int slices;      // 9 * cin / 64: 64-row slices of M, one (tap, block) each
  int ntiles;      // Cout tiles of the block
  int nt;          // Cout per block tile: 128, or 64 where Cout = 64
  int cout;
  int stages;
  int chunks;
  int smem;        // dynamic shared memory of a block, in bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrive, and expect `bytes` from the TMA loads of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of the 4-D map at (c, w, h, b) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int w, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
         "r"(w), "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor of an MN-major tile under the 128-byte
// swizzle (CUTLASS's canonical GMMA layout ((8, 8, m), (8, k)) : ((1, 8,
// LBO), (64, SBO)) in bf16 elements): 64 contiguous MN elements per
// 128-byte row, the next 64 of MN `lbo` bytes on, the next 8 rows of K
// 1024 bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(kWgAlign >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// D (64 x N, fp32, in registers) += A (64 x 16) * B (16 x N), both operands
// bf16 in shared memory and MN-major (imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int NT>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n64(d, a, b);
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    wgmma_m64n128(d, a, b);
  }
};

// Grid (M blocks * Cout tiles, chunks); block: kWgConsumers consumer
// warpgroups, then the producer warp.  xmap, dymap: (C, W, H, B) bf16 maps
// with (64, wt, ht, bt) boxes.  out: (chunks, 9 * Cin, Cout) fp32 partial
// sums, or dW itself when there is one chunk.
template <int NT>
__global__ void __launch_bounds__(kWgThreads, 1)
wgrad3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dymap,
                      float* __restrict__ out, const WgPlan p) {
  constexpr int kDyBoxes = NT / kWgBoxC;
  __shared__ uint64_t full[kWgMaxStages];
  __shared__ uint64_t empty[kWgMaxStages];
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + kWgAlign - 1) & ~(kWgAlign - 1);
  const int box = p.rows * kWgBoxC * 2;  // bytes
  const int stage_bytes = (kWgConsumers + kDyBoxes) * box;

  const int slice0 = (blockIdx.x / p.ntiles) * kWgConsumers;
  const int n0 = (blockIdx.x % p.ntiles) * NT;
  const int active = min(kWgConsumers, p.slices - slice0);
  const int first = static_cast<int>(static_cast<long long>(blockIdx.y) *
                                     p.steps / p.chunks);
  const int steps = static_cast<int>(
                        static_cast<long long>(blockIdx.y + 1) * p.steps /
                        p.chunks) - first;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * active);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgConsumers) {  // the producer warp: one thread issues the loads
    if (threadIdx.x % 32 != 0) return;
    const int per_image = p.nw * p.nh;
    for (int k = 0; k < steps; ++k) {
      const int s = k % p.stages;
      const uint32_t bar = smem_u32(&full[s]);
      if (k >= p.stages) {  // the consumers' release of step k - stages
        mbar_wait(smem_u32(&empty[s]), ((k / p.stages) & 1) ^ 1);
      }
      mbar_expect_tx(bar, (active + kDyBoxes) * box);
      const int g = first + k;
      const int b0 = g / per_image * p.bt;
      const int h0 = g % per_image / p.nw * p.ht;
      const int w0 = g % p.nw * p.wt;
      const uint32_t dst = base + s * stage_bytes;
      for (int j = 0; j < active; ++j) {
        const int tap = (slice0 + j) / p.cin_blocks;
        const int c0 = (slice0 + j) % p.cin_blocks * kWgBoxC;
        tma_load(dst + j * box, &xmap, bar, c0, w0 + tap % 3 - 1,
                 h0 + tap / 3 - 1, b0);
      }
      for (int j = 0; j < kDyBoxes; ++j) {
        tma_load(dst + (kWgConsumers + j) * box, &dymap, bar,
                 n0 + j * kWgBoxC, w0, h0, b0);
      }
    }
    return;
  }
  if (wg >= active) return;  // past the last slice of M

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < steps; ++k) {
    const int s = k % p.stages;
    mbar_wait(smem_u32(&full[s]), (k / p.stages) & 1);
    const uint32_t a = base + s * stage_bytes + wg * box;
    const uint32_t b = base + s * stage_bytes + kWgConsumers * box;
    wgmma_fence();
    for (int kk = 0; kk < p.rows / 16; ++kk) {  // 16 rows: 2048 bytes
      Mma<NT>::run(acc, smem_desc(a + kk * 2048, box),
                   smem_desc(b + kk * 2048, box));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the step before has completed: release its stage
    if (k > 0 && lane == 0) {
      mbar_arrive(smem_u32(&empty[(k - 1) % p.stages]));
    }
  }
  wgmma_wait<0>();

  // Fragment layout of m64nNk16: warp w of the warpgroup holds rows 16 w ..
  // 16 w + 15; register 4 j + i holds row lane / 4 + 8 (i / 2), column
  // 8 j + 2 (lane % 4) + i % 2.  Cout is a multiple of 64: an 8-column group
  // lies inside it or past it whole.
  const int row = (slice0 + wg) * 64 + (threadIdx.x % 128) / 32 * 16 +
                  lane / 4;
  float* dst = out +
               static_cast<size_t>(blockIdx.y) * p.slices * 64 * p.cout +
               static_cast<size_t>(row) * p.cout + n0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    if (n0 + j * 8 < p.cout) {
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + 8 * p.cout + j * 8) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The step boxes, the stages and the chunks for (batch, h, w, cin, cout);
// false if the device cannot be queried or no plan fits.  Boxes: the least
// rows computed, padding included, plus kWgStepRows for each step; among
// equals the most rows, then the widest (longer contiguous runs).  Chunks:
// the least estimated time, counting waves of one block per SM, a two-step
// fill per block and the second launch's read of every chunk's partial.
bool plan_wgmma(int batch, int h, int w, int cin, int cout, WgPlan* out) {
  int sms = 0;
  int smem_optin = 0;
  if (!card(&sms, &smem_optin)) return false;
  static std::mutex mu;
  static WgPlan cache[8];
  static int keys[8][5];
  static int used = 0;
  const int key[5] = {batch, h, w, cin, cout};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < 8; ++i) {
    if (std::equal(key, key + 5, keys[i])) {
      *out = cache[i];
      return true;
    }
  }
  WgPlan p{};
  long long best = LLONG_MAX;
  for (int wt = 1; wt <= kWgMaxRows; ++wt) {
    for (int ht = 1; ht <= h && wt * ht <= kWgMaxRows; ++ht) {
      // several images to a box only where a box holds whole images
      const int most_bt = (ht == h && wt >= w) ? batch : 1;
      for (int bt = 1; bt <= most_bt && wt * ht * bt <= kWgMaxRows; ++bt) {
        const int rows = wt * ht * bt;
        if (rows % 16 != 0) continue;
        const long long steps = static_cast<long long>((w + wt - 1) / wt) *
                                ((h + ht - 1) / ht) * ((batch + bt - 1) / bt);
        const long long cost = steps * (rows + kWgStepRows);
        if (cost < best || (cost == best && (rows > p.rows ||
                                             (rows == p.rows && wt > p.wt)))) {
          best = cost;
          p.wt = wt;
          p.ht = ht;
          p.bt = bt;
          p.rows = rows;
        }
      }
    }
  }
  if (best == LLONG_MAX) return false;
  p.nw = (w + p.wt - 1) / p.wt;
  p.nh = (h + p.ht - 1) / p.ht;
  const long long steps =
      static_cast<long long>(p.nw) * p.nh * ((batch + p.bt - 1) / p.bt);
  if (steps >= INT_MAX) return false;
  p.steps = static_cast<int>(steps);
  p.cin_blocks = cin / kWgBoxC;
  p.slices = 9 * p.cin_blocks;
  p.nt = cout == 64 ? 64 : 128;
  p.ntiles = (cout + p.nt - 1) / p.nt;
  p.cout = cout;
  const int stage_bytes =
      (kWgConsumers + p.nt / kWgBoxC) * p.rows * kWgBoxC * 2;
  // static shared memory: the barriers
  const int room = smem_optin - kWgAlign - 2 * kWgMaxStages * 8;
  p.stages = room / stage_bytes < kWgMaxStages ? room / stage_bytes
                                               : kWgMaxStages;
  if (p.stages < 2) return false;
  p.smem = p.stages * stage_bytes + kWgAlign;
  // estimated time of a chunk count, in microseconds: a step of a block at
  // ~5 TFLOP/s per SM, the partials read at ~3 TB/s
  const int tiles = (p.slices + kWgConsumers - 1) / kWgConsumers * p.ntiles;
  const double step_us = 2.0 * kWgConsumers * 64 * p.nt * p.rows / 5e6;
  const double plane_us = 9.0 * cin * cout * 4 / 3e6;
  double best_us = 1e300;
  p.chunks = 1;
  const int most = p.steps < kMaxChunks ? p.steps : kMaxChunks;
  for (int c = 1; c <= most; ++c) {
    const long long waves = (static_cast<long long>(tiles) * c + sms - 1) / sms;
    const double us = waves * ((p.steps + c - 1) / c + 2) * step_us +
                      (c > 1 ? c * plane_us : 0.0);
    if (us < best_us) {
      best_us = us;
      p.chunks = c;
    }
  }
  const int slot = used % 8;
  std::copy(key, key + 5, keys[slot]);
  cache[slot] = p;
  ++used;
  *out = p;
  return true;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// needs no -lcuda.  nullptr if the installed CUDA lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The (C, W, H, B) map of a contiguous NHWC bf16 tensor, (64, wt, ht, bt)
// boxes, 128-byte swizzle, zero outside the tensor.
bool nhwc_map(CUtensorMap* map, const void* t, int batch, int h, int w, int c,
              const WgPlan& p) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {kWgBoxC, static_cast<cuuint32_t>(p.wt),
                             static_cast<cuuint32_t>(p.ht),
                             static_cast<cuuint32_t>(p.bt)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& dymap,
                         float* out, const WgPlan& p, int chunks,
                         cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad3x3_wgmma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return err;
  WgPlan q = p;
  q.chunks = chunks;
  const int mblocks = (p.slices + kWgConsumers - 1) / kWgConsumers;
  wgrad3x3_wgmma_kernel<NT>
      <<<dim3(mblocks * p.ntiles, chunks), kWgThreads, p.smem, stream>>>(
          xmap, dymap, out, q);
  return cudaGetLastError();
}

bool wgmma_legal(int dtype, const void* x, const void* dy, int cin,
                 int cout) {
  return dtype == 1 && cin % kWgBoxC == 0 && cout % kWgBoxC == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dy) % 16 == 0;
}

}  // namespace

// path: 0 = the wmma kernel, 1 = the wgmma kernel (bf16, cin and cout
// multiples of 64, x and dy 16-byte aligned; the caller decides, by shape).

// Number of row chunks of a path: the caller allocates (chunks, 3, 3, cin,
// cout) fp32 scratch when it is above 1.  -1 if the device cannot be queried
// or the wgmma kernel has no plan for the shape.
extern "C" int cnsn_wgrad3x3_chunks(int path, int batch, int h, int w,
                                    int cin, int cout) {
  int sms = 0;
  int smem = 0;
  if (batch < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 ||
      !card(&sms, &smem)) {
    return -1;
  }
  if (path == 1) {  // a shape the kernel does not take is refused at launch
    WgPlan p;
    return plan_wgmma(batch, h, w, cin, cout, &p) ? p.chunks : -1;
  }
  const long long rows = static_cast<long long>(batch) * h * w;
  const long long blocks =
      ((9LL * cin + kBM - 1) / kBM) * ((cout + kBN - 1) / kBN);
  long long chunks = (static_cast<long long>(kBlocksPerSm) * sms + blocks - 1) /
                     blocks;
  const long long most = rows / (kMinSteps * kBK);
  if (chunks > most) chunks = most;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

// The wgmma kernel's plan for a shape, for reports: plan[0..9] = box
// columns, image rows and images, rows per step, steps, stages, chunks, Cout
// per block tile, block tiles, and the bytes its TMA loads bring into shared
// memory in all.  -1 if the device cannot be queried or no plan fits.
extern "C" int cnsn_wgrad3x3_wgmma_plan(int batch, int h, int w, int cin,
                                        int cout, long long* plan) {
  WgPlan p;
  if (batch < 1 || h < 1 || w < 1 || cin < kWgBoxC || cout < 1 ||
      !plan_wgmma(batch, h, w, cin, cout, &p)) {
    return -1;
  }
  const int mblocks = (p.slices + kWgConsumers - 1) / kWgConsumers;
  // every block loads one x box per slice it holds and the dy boxes of its
  // tile, per step of the whole reduction (its chunks together)
  const long long boxes = static_cast<long long>(p.slices) * p.ntiles +
                          static_cast<long long>(mblocks) * p.ntiles *
                              (p.nt / kWgBoxC);
  const long long values[10] = {p.wt,     p.ht,     p.bt,
                                p.rows,   p.steps,  p.stages,
                                p.chunks, p.nt,     mblocks * p.ntiles,
                                boxes * p.steps * p.rows * kWgBoxC * 2};
  std::copy(values, values + 10, plan);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; vec (wmma path): 1, or 4 (fp32) / 8
// (bf16) when it divides cin and cout and x and dy are 16-byte aligned.  x
// (batch, h, w, cin) and dy (batch, h, w, cout) are contiguous, of one dtype;
// out is (3, 3, cin, cout) fp32; part is the scratch above (unused when
// chunks is 1).  Returns the cudaError_t of the launches (0 on success), and
// cudaErrorInvalidValue, launching nothing, for a path the shape does not
// allow.
extern "C" int cnsn_wgrad3x3(int path, int dtype, int vec, const void* x,
                             const void* dy, void* part, void* out, int batch,
                             int h, int w, int cin, int cout, int chunks,
                             void* stream) {
  const long long rows = static_cast<long long>(batch) * h * w;
  if (batch < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || rows >= (1LL << 31) ||
      chunks < 1 || chunks > 65535 || (path != 0 && path != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((dtype != 0 && dtype != 1) || (chunks > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : out);
  if (path == 1) {
    WgPlan p;
    CUtensorMap xmap;
    CUtensorMap dymap;
    if (!wgmma_legal(dtype, x, dy, cin, cout) ||
        !plan_wgmma(batch, h, w, cin, cout, &p) ||
        !nhwc_map(&xmap, x, batch, h, w, cin, p) ||
        !nhwc_map(&dymap, dy, batch, h, w, cout, p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err =
        p.nt == 64 ? launch_wgmma<64>(xmap, dymap, dst, p, chunks, s)
                   : launch_wgmma<128>(xmap, dymap, dst, p, chunks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (vec != 1 && (cin % vec != 0 || cout % vec != 0 ||
                     !row_pass::valid_pass(dtype, 1, 1, cin, vec, x, dy))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Problem p;
    p.rows = static_cast<int>(rows);
    p.hw = h * w;
    p.h = h;
    p.w = w;
    p.cin = cin;
    p.cout = cout;
    p.m = 9 * cin;
    p.chunk_rows = chunk_rows(p.rows, chunks);
    if (!row_pass::dispatch<Wgrad>(dtype, vec, x, dy, dst, p, chunks, s)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (chunks == 1) return 0;
  const size_t n = static_cast<size_t>(9) * cin * cout;
  size_t grid = (n + 255) / 256;
  if (grid > 4096) grid = 4096;
  wgrad3x3_finalize_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, chunks);
  return static_cast<int>(cudaGetLastError());
}
