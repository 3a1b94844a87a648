// Instance statistics (K1) for Hopper (sm_90a), forward and backward.
//
// Replaces cnsn_tpu/ops/pallas/ins_stats.py: ins_stats_pallas (v1, :78),
// ins_stats_v2 (:140) and the jnp backward of ins_stats_diff (:179-190).
// Per (sample n, channel c) of an NHWC tensor x with HW = H*W rows:
//   forward   mean = S1 / HW,  var = (S2 / HW - mean^2) * HW / max(HW - ddof, 1)
//             std  = sqrt(var + eps)      (one pass in fp32, no clamp, as JAX)
//   backward  dx   = gm / HW + gs * (x - mean) / (max(HW - ddof, 1) * std)
//             in x's type, from the fp32 (N, C) mean, std and cotangents.
//
// Bound: bytes.  The forward reads x once (its (N, C) outputs are noise); the
// backward reads x and writes dx.  ResNet-50's 16 SelfNorm sites at b=128
// bf16 hold 5,519,360 elements per image: 1.41 GB, so >= 0.42 ms forward and
// >= 0.84 ms backward per step at 3.35 TB/s.  The image CrossNorm statistics
// (128 x 224 x 224 x 3 fp32) read 77 MB: >= 0.023 ms.
//
// Design.  The TPU kernels hold one sample's (HW, 128) plane in VMEM (v2) or
// carry running sums along a sequential HW grid (v1).  A Hopper block has
// neither the room nor the order, so the forward is two launches
// (row_pass.cuh): blocks over (channel tile, HW chunk, sample) write fp32
// partial sums S1, S2 to a scratch buffer the caller allocates, then one
// thread per (n, c) adds its chunks in order and forms mean and std.  The HW
// chunks keep ~8 blocks per SM busy at every shape: at C=256 bf16 a sample is
// one channel tile, and 128 samples alone would give each SM one block.
// Loads are 16 bytes a thread where C allows.  No vector width divides C=3,
// so image planes load one element a thread, but three lanes span a row and a
// warp still reads 128 contiguous bytes.  The backward is one elementwise
// pass in the same geometry; each thread loads its channels' four
// statistics once.
#include <limits.h>

#include "row_pass.cuh"

namespace {

using row_pass::Geometry;
using row_pass::Place;
using row_pass::kThreads;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ins_sums_kernel(const T* __restrict__ x, float* __restrict__ part, int hw,
                int c, int chunk_rows) {
  row_pass::row_sums<T, V>(x, nullptr, part, hw, c, chunk_rows);
}

template <typename T, int V>
struct InsSums {
  static void run(const void* x, float* part, int n, int hw, int c,
                  int chunks, cudaStream_t stream) {
    const Geometry g = row_pass::geometry(c, V);
    const dim3 grid(g.ctiles, chunks, n);
    ins_sums_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), part, hw, c,
        row_pass::chunk_rows(hw, chunks));
  }
};

__global__ void ins_finalize_kernel(const float* __restrict__ part,
                                    float* __restrict__ mean,
                                    float* __restrict__ std_out, int n,
                                    int chunks, int c, int hw, float eps,
                                    float corr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * c) return;
  const int b = i / c;
  const int ch = i - b * c;
  const size_t plane = static_cast<size_t>(n) * chunks * c;
  float t1 = 0.f;
  float t2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const size_t o = (static_cast<size_t>(b) * chunks + k) * c + ch;
    t1 += part[o];
    t2 += part[plane + o];
  }
  const float count = static_cast<float>(hw);
  const float m = t1 / count;
  // __fmul_rn keeps nvcc from contracting this into an FMA, whose exact m²
  // would leave the negative rounding error of S2/HW as the variance of a
  // constant plane (HW = 1), and sqrt would give NaN.
  const float var = (t2 / count - __fmul_rn(m, m)) * corr;
  mean[i] = m;
  std_out[i] = sqrtf(var + eps);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ins_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ std_in, const float* __restrict__ gm,
               const float* __restrict__ gs, T* __restrict__ dx, int hw, int c,
               int chunk_rows, float denom) {
  const Geometry g = row_pass::geometry(c, V);
  const Place p = row_pass::place(g, hw, c, V, chunk_rows);
  if (!p.live) return;
  const size_t stat = static_cast<size_t>(blockIdx.z) * c + p.c0;
  float m[V];
  float a[V];
  float k[V];
  float den[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = mean[stat + i];
    a[i] = gm[stat + i] / static_cast<float>(hw);
    k[i] = gs[stat + i];
    den[i] = denom * std_in[stat + i];
  }
  const size_t base = static_cast<size_t>(blockIdx.z) * hw * c + p.c0;
#pragma unroll 4
  for (int r = p.r_begin + p.rin; r < p.r_end; r += g.rows_per_iter) {
    const size_t off = base + static_cast<size_t>(r) * c;
    float v[V];
    row_pass::load_vec<V>(x + off, v);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = a[i] + k[i] * (v[i] - m[i]) / den[i];
    row_pass::store_vec<V>(dx + off, v);
  }
}

template <typename T, int V>
struct InsBwd {
  static void run(const void* x, const void* mean, const void* std_in,
                  const void* gm, const void* gs, void* dx, int n, int hw,
                  int c, int chunks, float denom, cudaStream_t stream) {
    const Geometry g = row_pass::geometry(c, V);
    const dim3 grid(g.ctiles, chunks, n);
    ins_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(std_in), static_cast<const float*>(gm),
        static_cast<const float*>(gs), static_cast<T*>(dx), hw, c,
        row_pass::chunk_rows(hw, chunks), denom);
  }
};

}  // namespace

// Number of HW chunks the forward splits each (sample, channel tile) into:
// the caller allocates a (2, n, chunks, c) fp32 scratch buffer.  -1 if the
// device cannot be queried.
extern "C" int cnsn_ins_stats_chunks(int n, int hw, int c, int vec) {
  return row_pass::plan_chunks(n, hw, c, vec);
}

// dtype: 0 = float32, 1 = bfloat16; vec: 1, or 4 (fp32) / 8 (bf16) when c is
// a multiple of it and x is 16-byte aligned.  x is NHWC-contiguous (n, hw, c);
// part is the scratch above; mean and std are (n, c) fp32.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int cnsn_ins_stats(int dtype, int vec, const void* x, void* part,
                              void* mean, void* std_out, int n, int hw, int c,
                              int chunks, float eps, int ddof, void* stream) {
  if (!row_pass::valid_pass(dtype, n, hw, c, vec, x, nullptr) || chunks < 1 ||
      chunks > 65535 || static_cast<long long>(n) * c > INT_MAX || ddof < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partf = static_cast<float*>(part);
  if (!row_pass::dispatch<InsSums>(dtype, vec, x, partf, n, hw, c, chunks,
                                   s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // HW / max(HW - ddof, 1), as the JAX package corrects the variance
  const float corr = static_cast<float>(
      static_cast<double>(hw) / (hw - ddof > 1 ? hw - ddof : 1));
  const int total = n * c;
  ins_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      partf, static_cast<float*>(mean), static_cast<float*>(std_out), n,
      chunks, c, hw, eps, corr);
  return static_cast<int>(cudaGetLastError());
}

// dx = gm / hw + gs * (x - mean) / (max(hw - ddof, 1) * std), written in x's
// type.  x and dx are NHWC-contiguous (n, hw, c) of one dtype; mean, std, gm
// and gs are (n, c) fp32.  Returns the cudaError_t of the launch.
extern "C" int cnsn_ins_stats_bwd(int dtype, int vec, const void* x,
                                  const void* mean, const void* std_in,
                                  const void* gm, const void* gs, void* dx,
                                  int n, int hw, int c, int ddof,
                                  void* stream) {
  if (!row_pass::valid_pass(dtype, n, hw, c, vec, x, dx) || ddof < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = row_pass::plan_chunks(n, hw, c, vec);
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float denom = static_cast<float>(hw - ddof > 1 ? hw - ddof : 1);
  if (!row_pass::dispatch<InsBwd>(dtype, vec, x, mean, std_in, gm, gs, dx, n,
                                  hw, c, chunks, denom,
                                  static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
