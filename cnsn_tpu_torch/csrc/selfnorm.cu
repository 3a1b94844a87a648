// Fused eval-mode SelfNorm for Hopper (sm_90a).
//
// Replaces cnsn_tpu/ops/pallas/selfnorm.py::selfnorm_infer_pallas.  Per
// (sample n, channel c) of an NHWC tensor x:
//     mean, var  = one-pass spatial moments in fp32, var *= HW / (HW - 1)
//     std        = sqrt(var + eps)                      (no clamp, as in JAX)
//     g          = sigmoid(a[c] * (w[c,0] * mean + w[c,1] * std) + b[c])
//     out        = (x * g) taken in fp32, then cast to x's type
// where a, b are SelfNorm's BatchNorm1d running stats folded into an affine
// by the caller.
//
// Bound: bytes.  The work is a handful of flops per element, so the least
// time is one read and one write of x at the card's memory rate.  At b=64
// bf16 over the 16 SelfNorm sites of ResNet-50 that is 5,519,360 elements
// per image * 64 * 2 B * 2 = 1.41 GB per forward (~0.42 ms at 3.35 TB/s,
// ~61 us for one layer1 site).
//
// Design.  The TPU kernel holds one sample's whole (HW, 128) plane in VMEM;
// at 56x56x128 that is 0.8 MB in bf16, far above the 227 KB of shared memory
// a block can use.  Here one block owns (sample, tile of kTileC channels):
//   - a warp spans the tile's channels, so neighbouring threads read
//     neighbouring channels of one NHWC row;
//   - kRowGroups warps stride over the HW rows, each thread summing s1, s2
//     for its channel in fp32 registers;
//   - a shared-memory reduction over the row groups, then one thread per
//     channel forms mean, std and g;
//   - a second pass over the same rows writes x * g.  The tile (HW x kTileC)
//     is re-read, from the 50 MB L2 only where the tiles of all resident
//     blocks fit there (PERF.md discusses the layer1 case, where they don't).
// Ragged channel and row edges are masked, so any C >= 1 and HW >= 1 work.
// No TMA or wgmma: making this fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTileC = 32;      // channels per block (one warp wide)
constexpr int kRowGroups = 16;  // warps per block striding over HW rows

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA/PyTorch cast
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kRowGroups)
selfnorm_infer_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ a, const float* __restrict__ b,
                      T* __restrict__ out, int hw, int c, float eps,
                      float corr) {
  __shared__ float s1_part[kRowGroups][kTileC];
  __shared__ float s2_part[kRowGroups][kTileC];
  __shared__ float gate[kTileC];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ch = blockIdx.x * kTileC + tx;
  const bool live = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.y) * hw * c;
  const T* xs = x + base;
  T* os = out + base;

  float s1 = 0.f;
  float s2 = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = ty; r < hw; r += kRowGroups) {
      const float v = load_f32(xs + static_cast<size_t>(r) * c + ch);
      s1 += v;
      s2 += __fmul_rn(v, v);  // rounded square, as the plain version
    }
  }
  s1_part[ty][tx] = s1;
  s2_part[ty][tx] = s2;
  __syncthreads();

  if (ty == 0) {
    float t1 = 0.f;
    float t2 = 0.f;
#pragma unroll
    for (int k = 0; k < kRowGroups; ++k) {
      t1 += s1_part[k][tx];
      t2 += s2_part[k][tx];
    }
    float g = 0.f;
    if (live) {
      const float n = static_cast<float>(hw);
      const float mean = t1 / n;
      // __fmul_rn keeps nvcc from contracting this into an FMA: with the
      // exact mean² of an FMA, E[x²] − mean² of a constant plane (HW = 1)
      // is the negative rounding error of E[x²], and sqrt gives NaN.
      const float var = (t2 / n - __fmul_rn(mean, mean)) * corr;
      const float std = sqrtf(var + eps);
      const float y = w[2 * ch] * mean + w[2 * ch + 1] * std;
      g = 1.f / (1.f + expf(-(a[ch] * y + b[ch])));
    }
    gate[tx] = g;
  }
  __syncthreads();

  if (!live) return;
  const float g = gate[tx];
#pragma unroll 4
  for (int r = ty; r < hw; r += kRowGroups) {
    const size_t off = static_cast<size_t>(r) * c + ch;
    store_from_f32(os + off, load_f32(xs + off) * g);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* out, int n, int hw, int c, float eps, float corr,
           cudaStream_t stream) {
  const dim3 grid((c + kTileC - 1) / kTileC, n);
  const dim3 block(kTileC, kRowGroups);
  selfnorm_infer_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), hw, c, eps, corr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and out are NHWC-contiguous
// (n, hw, c); w is (c, 2) fp32; a, b are (c,) fp32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int cnsn_selfnorm_infer(int dtype, const void* x, const void* w,
                                   const void* a, const void* b, void* out,
                                   int n, int hw, int c, float eps,
                                   void* stream) {
  if (n < 1 || n > 65535 || hw < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // unbiased variance (ddof 1), HW / max(HW - 1, 1), as the JAX package
  const float corr =
      static_cast<float>(static_cast<double>(hw) / (hw > 1 ? hw - 1 : 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, a, b, out, n, hw, c, eps, corr, s);
    case 1:
      return launch<__nv_bfloat16>(x, w, a, b, out, n, hw, c, eps, corr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
