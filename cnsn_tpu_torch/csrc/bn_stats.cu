// Shifted BatchNorm sums (K2) for Hopper (sm_90a), forward and backward.
//
// Replaces cnsn_tpu/ops/pallas/bn_stats.py: bn_sums_pallas (:109) and the jnp
// backward of bn_sums (:146-155).  Over the R = N*H*W rows of an NHWC x and a
// per-channel shift m0 (the running mean):
//   forward   s1[c] = sum_r (x - m0[c]),  s2[c] = sum_r (x - m0[c])^2   (fp32)
//   backward  dx    = g1[c] + 2 (x - m0[c]) g2[c]   in x's type
// The caller forms mean = m0 + s1/R and var = max(s2/R - (s1/R)^2, 0).  m0 is
// a buffer with no gradient (stop_gradient in JAX), so the TPU backward's dm0
// term has no counterpart.
//
// Bound: bytes.  The forward reads x once, the backward reads x and writes
// dx.  The 53 BatchNorm2d inputs of ResNet-50 hold 11,113,984 elements per
// image: at b=128 bf16 that is 2.85 GB, >= 0.85 ms forward and >= 1.70 ms
// backward per step at 3.35 TB/s.
//
// Design.  The TPU kernel carries the sums in VMEM scratch along a sequential
// grid of row chunks.  Hopper blocks run in no order, so the forward is two
// launches (row_pass.cuh): blocks over (channel tile, row chunk) write fp32
// partial sums to a scratch buffer the caller allocates, then a second launch
// adds each channel's chunks in a fixed order.  No atomics: the sums are the
// same from run to run.  The shapes run from C=64 over 1.6M rows (the stem)
// to C=2048 over 6,272 rows (layer4); the chunk count keeps ~8 blocks per SM
// at both ends.  At C=64 bf16 a row is 128 bytes, so 8 lanes of 16-byte loads
// span it and a warp reads four whole rows: 512 contiguous bytes, where one
// thread per channel would read 64.  The TPU kernel's lane folding for C<128
// answers the same problem for its (8, 128) tiles.  The backward is one
// elementwise pass in the same geometry; every product and sum is rounded on
// its own, as the plain version computes it.
#include "row_pass.cuh"

namespace {

using row_pass::Geometry;
using row_pass::Place;
using row_pass::kThreads;

constexpr int kFinalRows = 32;  // chunk strides per block of the second stage

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_sums_kernel(const T* __restrict__ x, const float* __restrict__ m0,
               float* __restrict__ part, int rows, int c, int chunk_rows) {
  row_pass::row_sums<T, V>(x, m0, part, rows, c, chunk_rows);
}

template <typename T, int V>
struct BnSums {
  static void run(const void* x, const void* m0, float* part, int rows,
                  int c, int chunks, cudaStream_t stream) {
    const Geometry g = row_pass::geometry(c, V);
    const dim3 grid(g.ctiles, chunks, 1);
    bn_sums_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(m0), part, rows,
        c, row_pass::chunk_rows(rows, chunks));
  }
};

// Grid ceil(c / 32), block (32, kFinalRows): thread (tx, ty) adds chunks
// ty, ty + kFinalRows, ... of channel 32 * blockIdx.x + tx, then row 0 adds
// the kFinalRows results in order.
__global__ void __launch_bounds__(32 * kFinalRows)
bn_finalize_kernel(const float* __restrict__ part, float* __restrict__ s1,
                   float* __restrict__ s2, int chunks, int c) {
  __shared__ float r1[kFinalRows][33];
  __shared__ float r2[kFinalRows][33];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  const size_t plane = static_cast<size_t>(chunks) * c;
  float a = 0.f;
  float q = 0.f;
  if (ch < c) {
    for (int k = ty; k < chunks; k += kFinalRows) {
      a += part[static_cast<size_t>(k) * c + ch];
      q += part[plane + static_cast<size_t>(k) * c + ch];
    }
  }
  r1[ty][tx] = a;
  r2[ty][tx] = q;
  __syncthreads();
  if (ty != 0 || ch >= c) return;
  float t1 = 0.f;
  float t2 = 0.f;
#pragma unroll
  for (int k = 0; k < kFinalRows; ++k) {
    t1 += r1[k][tx];
    t2 += r2[k][tx];
  }
  s1[ch] = t1;
  s2[ch] = t2;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ m0,
              const float* __restrict__ g1, const float* __restrict__ g2,
              T* __restrict__ dx, int rows, int c, int chunk_rows) {
  const Geometry g = row_pass::geometry(c, V);
  const Place p = row_pass::place(g, rows, c, V, chunk_rows);
  if (!p.live) return;
  float m[V];
  float a[V];
  float k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = m0[p.c0 + i];
    a[i] = g1[p.c0 + i];
    k[i] = g2[p.c0 + i];
  }
#pragma unroll 4
  for (int r = p.r_begin + p.rin; r < p.r_end; r += g.rows_per_iter) {
    const size_t off = static_cast<size_t>(r) * c + p.c0;
    float v[V];
    row_pass::load_vec<V>(x + off, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // g1 + (2 d) g2 with each step rounded: no FMA contraction
      v[i] = __fadd_rn(a[i], __fmul_rn(__fmul_rn(2.f, v[i] - m[i]), k[i]));
    }
    row_pass::store_vec<V>(dx + off, v);
  }
}

template <typename T, int V>
struct BnBwd {
  static void run(const void* x, const void* m0, const void* g1,
                  const void* g2, void* dx, int rows, int c, int chunks,
                  cudaStream_t stream) {
    const Geometry g = row_pass::geometry(c, V);
    const dim3 grid(g.ctiles, chunks, 1);
    bn_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(m0),
        static_cast<const float*>(g1), static_cast<const float*>(g2),
        static_cast<T*>(dx), rows, c, row_pass::chunk_rows(rows, chunks));
  }
};

}  // namespace

// Number of row chunks of the forward: the caller allocates a (2, chunks, c)
// fp32 scratch buffer.  -1 if the device cannot be queried.
extern "C" int cnsn_bn_sums_chunks(int rows, int c, int vec) {
  return row_pass::plan_chunks(1, rows, c, vec);
}

// dtype: 0 = float32, 1 = bfloat16; vec: 1, or 4 (fp32) / 8 (bf16) when c is
// a multiple of it and x is 16-byte aligned.  x is row-major (rows, c); m0,
// s1 and s2 are (c,) fp32; part is the scratch above.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int cnsn_bn_sums(int dtype, int vec, const void* x, const void* m0,
                            void* part, void* s1, void* s2, int rows, int c,
                            int chunks, void* stream) {
  if (!row_pass::valid_pass(dtype, 1, rows, c, vec, x, nullptr) ||
      chunks < 1 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partf = static_cast<float*>(part);
  if (!row_pass::dispatch<BnSums>(dtype, vec, x, m0, partf, rows, c, chunks,
                                  s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, kFinalRows);
  bn_finalize_kernel<<<(c + 31) / 32, block, 0, s>>>(
      partf, static_cast<float*>(s1), static_cast<float*>(s2), chunks, c);
  return static_cast<int>(cudaGetLastError());
}

// dx = g1 + 2 (x - m0) g2 per channel, written in x's type.  x and dx are
// row-major (rows, c) of one dtype; m0, g1, g2 are (c,) fp32.  Returns the
// cudaError_t of the launch.
extern "C" int cnsn_bn_sums_bwd(int dtype, int vec, const void* x,
                                const void* m0, const void* g1,
                                const void* g2, void* dx, int rows, int c,
                                void* stream) {
  if (!row_pass::valid_pass(dtype, 1, rows, c, vec, x, dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = row_pass::plan_chunks(1, rows, c, vec);
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!row_pass::dispatch<BnBwd>(dtype, vec, x, m0, g1, g2, dx, rows, c,
                                 chunks, static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
