// Weight gradient of a 3x3 / stride-1 / same-padding convolution (K4) for
// Hopper (sm_90a).
//
// Replaces cnsn_tpu/ops/pallas/conv_wgrad.py: wgrad3x3_pallas (:188, one image
// per grid step, operands cast to fp32) and wgrad3x3_tiled (:143, batch-tiled,
// native-dtype operands with fp32 accumulation).  Both compute, for NHWC x
// (B, H, W, Cin) and dy (B, H, W, Cout),
//   dW[kh][kw][ci][co] = sum_{b,h,w} x[b, h+kh-1, w+kw-1, ci] * dy[b, h, w, co]
// with x read as zero outside the image, into a (3, 3, Cin, Cout) fp32 array.
// A product of two bf16 values is exact in fp32, so bf16 operands with fp32
// accumulation give both entry points' result up to the order of the sums.
//
// Bound.  2 * B*H*W * 9 * Cin * Cout operations on (x + dy) bytes read once.
// At b=128 bf16 each stride-1 3x3 of ResNet-50 is 29.6 GFLOP, 0.030 ms at 989
// TFLOP/s, and layer1 reads 103 MB, 0.031 ms at 3.35 TB/s: both bounds are
// close, so the operations set it at layers 2-4 and the bytes at layer1.  A
// WRN-40-2 site is about 2.4 GFLOP and 4-17 MB.
//
// Design.  One implicit GEMM: M = 9 * Cin, tap-major as the TPU kernel's
// (9 * Cin, Cout) block (row m is tap t = m / Cin, channel m mod Cin; the
// (3, 3, Cin, Cout) output is that matrix), N = Cout, and the reduction runs
// over the rows r = (b, h, w).  A block computes one 64 x 64 tile of it over
// one chunk of rows, 32 rows per step.  A column of its x tile reads row r
// shifted by (kh-1)*W + (kw-1) for its tap, the zero border masked in the
// kernel (the TPU kernel pads a copy of x with jnp.pad); dy's rows are read
// as they are; ragged tiles and the chunk's last rows are masked to zero.
// At Cin >= 64 a tile holds one tap, and the tiles of one chunk's nine taps
// sit next to each other in the grid, so the shifted re-reads of x mostly
// hit the L2; at Cin = 3 (the WRN stem) one tile holds all 27 rows, and x
// is read once.  bf16 tiles go through the tensor cores with nvcuda::wmma
// (16x16x16, fp32 accumulators); fp32 tiles take fp32 FMAs without TF32, as
// the TPU's one-image kernel is fp32.  While a step's tiles are multiplied
// from shared memory, the next step's are loaded into registers.  Split-K:
// where the tiles leave the card short of blocks (every WRN-40-2 shape,
// ResNet-50 layers 1-3), the rows are cut into chunks, each block writes its
// fp32 partial tile to scratch that the caller allocates, and a second
// launch adds the chunks in order.  No atomics: dW has the same bits from
// run to run.  wgmma, TMA, a persistent grid and one read of x for all nine
// taps at wide Cin are left to the work that makes this kernel fast.
#include "row_pass.cuh"  // cuda_bf16.h, and dispatch over (dtype, vec)

#include <mma.h>

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

}  // namespace

// Number of row chunks: the caller allocates (chunks, 3, 3, cin, cout) fp32
// scratch when it is above 1.  -1 if the device cannot be queried.
extern "C" int cnsn_wgrad3x3_chunks(int rows, int cin, int cout) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    int count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return -1;
    }
    sms = count;
  }
  const long long blocks =
      ((9LL * cin + kBM - 1) / kBM) * ((cout + kBN - 1) / kBN);
  long long chunks = (static_cast<long long>(kBlocksPerSm) * sms + blocks - 1) /
                     blocks;
  const long long most = rows / (kMinSteps * kBK);
  if (chunks > most) chunks = most;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

// dtype: 0 = float32, 1 = bfloat16; vec: 1, or 4 (fp32) / 8 (bf16) when it
// divides cin and cout and x and dy are 16-byte aligned.  x (batch, h, w, cin)
// and dy (batch, h, w, cout) are contiguous, of one dtype; out is (3, 3, cin,
// cout) fp32; part is the scratch above (unused when chunks is 1).  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int cnsn_wgrad3x3(int dtype, int vec, const void* x, const void* dy,
                             void* part, void* out, int batch, int h, int w,
                             int cin, int cout, int chunks, void* stream) {
  const long long rows = static_cast<long long>(batch) * h * w;
  if (batch < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || rows >= (1LL << 31) ||
      chunks < 1 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec != 1 && (cin % vec != 0 || cout % vec != 0 ||
                   !row_pass::valid_pass(dtype, 1, 1, cin, vec, x, dy))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((dtype != 0 && dtype != 1) || (chunks > 1 && part == nullptr)) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : out);
  if (!row_pass::dispatch<Wgrad>(dtype, vec, x, dy, dst, p, chunks, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(9) * cin * cout;
  size_t grid = (n + 255) / 256;
  if (grid > 4096) grid = 4096;
  wgrad3x3_finalize_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, chunks);
  return static_cast<int>(cudaGetLastError());
}
