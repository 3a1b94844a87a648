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
// Two kernels; ops/kernels/selfnorm.py::selfnorm_path picks one per call.
//
// `staged` (selfnorm_staged_kernel): x read from device memory once.  The
// TPU kernel keeps each (HW, 128) tile in VMEM; here a block, or a cluster
// of up to 8 blocks split over the rows, owns (sample, tile of `lanes` x 16
// bytes of channels) and brings its whole rows x tile plane into dynamic
// shared memory with 16-byte cp.async copies (at most 227 KB a block).
// Each thread then sums its channels' rows from shared memory in fp32, the
// row groups of a warp add by a fixed butterfly of shuffles, the warps in
// order through shared memory, and a cluster's blocks read each other's
// partials over distributed shared memory in rank order, so every block of
// the cluster forms the same mean, std and gate.  x * g is written from the
// staged plane with 16-byte stores.  staged_plan (below; its size query is
// cnsn_selfnorm_plan) sets the tile width and the cluster size per (N, HW,
// C, dtype) from the card's SMs and shared memory, so that the card is
// filled at b=64 and at b=1; the kernel needs C a multiple of one 16-byte
// vector (8 bf16, 4 fp32), 16-byte aligned x and out, and a plane that fits
// a cluster of 8 blocks.
//
// `v1` (selfnorm_infer_kernel, the first port's): every other call (unaligned
// views, C not a multiple of the vector, a plane too large for a cluster).
// One block owns (sample, tile of kTileC channels): a warp spans the tile's
// channels, kRowGroups warps stride over the HW rows summing s1, s2 per
// channel in fp32 registers, a shared-memory reduction forms mean, std and
// g, and a second pass over the same rows writes x * g.  That second read
// comes from the L2 only where the tiles of all resident blocks fit there;
// at ResNet-50's layer1 (56x56x256, b=64) they do not, and x is read from
// device memory twice.  Ragged channel and row edges are masked, so any
// C >= 1 and HW >= 1 work.
//
// Both round as the Pallas kernel does: x * g in fp32, cast once; the
// square of the mean with __fmul_rn (see below).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

// ---- staged kernel ---------------------------------------------------------

constexpr int kStThreads = 256;
constexpr int kStWarps = kStThreads / 32;
constexpr int kMaxCluster = 8;
// Shared memory per channel of the tile beside the plane: the warps' sums
// (kStWarps x 2 floats), the block's partial (2) and the gate (1).
constexpr int kStPerChannel = (kStWarps * 2 + 2 + 1) * 4;

// 16 bytes of T as floats, and back (round to nearest even, as the casts of
// XLA and PyTorch).
template <typename T>
struct Lane16;

template <>
struct Lane16<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Lane16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& q, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    return q;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(__cvta_generic_to_global(src))
               : "memory");
}

// Grid (cluster * C / tile, N), clusters of `ranks` blocks along x: block
// (ct * ranks + rank, n) stages rows [rank * rows_blk, ...) of sample n's
// channel tile ct (tile = lanes * V channels).  Dynamic shared memory: the
// plane (rows_blk x tile of T), then red[kStWarps][2][tile],
// part[2][tile], gate[tile] in fp32.
template <typename T>
__global__ void __launch_bounds__(kStThreads)
selfnorm_staged_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ a,
                       const float* __restrict__ b, T* __restrict__ out,
                       int hw, int c, int lanes, int rows_blk, float eps,
                       float corr) {
  using L = Lane16<T>;
  constexpr int V = L::V;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = lanes * V;
  const int ct = blockIdx.x / ranks;
  const int r0 = rank * rows_blk;
  const int nrows = hw - r0 < rows_blk ? hw - r0 : rows_blk;
  uint4* plane = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + static_cast<size_t>(rows_blk) * tile * sizeof(T));
  float* part = red + kStWarps * 2 * tile;
  float* gate = part + 2 * tile;

  // kStThreads is a multiple of lanes: a thread keeps one lane (its V
  // channels) over every row it touches
  const int t = threadIdx.x;
  const int l = t % lanes;
  const int rstep = kStThreads / lanes;
  const size_t base =
      (static_cast<size_t>(blockIdx.y) * hw + r0) * c +
      static_cast<size_t>(ct) * tile + l * V;
  const int units = nrows * lanes;
  for (int u = t; u < units; u += kStThreads) {
    cp_async16(plane + u, x + base + static_cast<size_t>(u / lanes) * c);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
  __syncthreads();

  float s1[V];
  float s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[i] = 0.f;
    s2[i] = 0.f;
  }
  for (int r = t / lanes; r < nrows; r += rstep) {
    float v[V];
    L::unpack(plane[r * lanes + l], v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1[i] += v[i];
      s2[i] += __fmul_rn(v[i], v[i]);  // rounded square, as the plain version
    }
  }
  // the row groups of a warp hold the same lane: a fixed butterfly leaves
  // every one of them the same sum
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  }
  const int warp = t / 32;
  if (t % 32 < lanes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[(warp * 2) * tile + l * V + i] = s1[i];
      red[(warp * 2 + 1) * tile + l * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int i = t; i < 2 * tile; i += kStThreads) {
    const int s = i / tile;
    const int ch = i % tile;
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kStWarps; ++k) tot += red[(k * 2 + s) * tile + ch];
    part[s * tile + ch] = tot;
  }
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  for (int ch = t; ch < tile; ch += kStThreads) {
    float t1 = 0.f;
    float t2 = 0.f;
    for (int k = 0; k < ranks; ++k) {
      const float* p = ranks > 1 ? cluster.map_shared_rank(part, k) : part;
      t1 += p[ch];
      t2 += p[tile + ch];
    }
    const int cc = ct * tile + ch;
    const float n = static_cast<float>(hw);
    const float mean = t1 / n;
    // as in selfnorm_infer_kernel: no FMA for mean^2
    const float var = (t2 / n - __fmul_rn(mean, mean)) * corr;
    const float std = sqrtf(var + eps);
    const float y = w[2 * cc] * mean + w[2 * cc + 1] * std;
    gate[ch] = 1.f / (1.f + expf(-(a[cc] * y + b[cc])));
  }
  // no block leaves while another may still read its partial
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  float g[V];
#pragma unroll
  for (int i = 0; i < V; ++i) g[i] = gate[l * V + i];
  for (int u = t; u < units; u += kStThreads) {
    float v[V];
    L::unpack(plane[u], v);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] *= g[i];
    *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(u / lanes) * c) =
        L::pack(v);
  }
}

// The card's facts the plan reads, queried once: out[0] SMs, out[1] the
// shared memory a block may opt in to; false if the device cannot be
// queried.
bool card(int* out) {
  static int f[2] = {0, 0};
  if (f[0] == 0 || f[1] == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&f[0], cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&f[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      f[0] = f[1] = 0;
      return false;
    }
  }
  out[0] = f[0];
  out[1] = f[1];
  return true;
}

// The staged kernel's dynamic shared memory for (lanes, cluster) over
// planes of hw rows x c channels of `item`-byte elements, or 0 where that
// is no plan: lanes a power of 2 in [1, 32] whose tile divides c, cluster
// 1, 2, 4 or 8 with no block of the cluster left without rows, and the
// block's shared memory within `optin`.
size_t staged_smem(int item, int hw, int c, int lanes, int cluster,
                   int optin) {
  const int tile = lanes * (16 / item);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || c % tile != 0) {
    return 0;
  }
  const int rows_blk = (hw + cluster - 1) / cluster;
  if (static_cast<long long>(cluster - 1) * rows_blk >= hw) return 0;
  const size_t smem = static_cast<size_t>(rows_blk) * tile * item +
                      static_cast<size_t>(kStPerChannel) * tile;
  return smem <= static_cast<size_t>(optin) ? smem : 0;
}

// The plan: bytes of x a block aims at, and the size of x from which the
// memory rate, not latency, sets the time.
constexpr long long kBlockBytes = 32 * 1024;
constexpr long long kMinBlockBytes = 4 * 1024;
constexpr long long kBandwidthBytes = 32ll << 20;

// The staged kernel's plan for x of (n, hw rows, c) `item`-byte elements
// on a card of `sms` SMs and `optin` bytes of shared memory a block:
// out[0..4] = lanes (0: no plan), cluster, rows a block stages, its shared
// memory, blocks.  Lanes of 16 bytes span the tile (2 to 32, or 1 where c
// allows no more).  Of the plans staged_smem allows it takes, in this
// order (set by utils/stats_sweep.py's times over every plan; each one
// moved the ResNet-50 or WRN-40-2 forward):
//   - at least min(sms, x's bytes / kBlockBytes) blocks, else the most;
//   - a block within half an SM's shared memory (two resident);
//   - where x holds kBandwidthBytes or more, row segments of 128 bytes
//     (whole cache lines), or the widest c allows;
//   - the smallest cluster (a cluster's barriers cost ~1-2 us);
//   - the bytes a block stages closest (in log2) to x's bytes / (2 sms),
//     kept within [kMinBlockBytes, kBlockBytes];
//   - then the widest tile.
void staged_plan(int item, int n, int hw, int c, int sms, int optin,
                 int* out) {
  const int vec = 16 / item;
  for (int i = 0; i < 5; ++i) out[i] = 0;
  if (c % vec != 0) return;
  const double total = static_cast<double>(n) * hw * c * item;
  const double want = std::min<double>(sms, std::ceil(total / kBlockBytes));
  const double aim = std::min<double>(
      std::max<double>(total / (2.0 * sms), kMinBlockBytes), kBlockBytes);
  const bool wide = total >= kBandwidthBytes;
  bool any_wide = false;
  for (int lanes = 2; lanes <= 32; lanes *= 2) {
    any_wide = any_wide || c % (lanes * vec) == 0;
  }
  double best[5] = {0, 0, 0, 0, 0};
  for (int lanes = 32; lanes >= 1; lanes /= 2) {  // widest first
    if ((lanes == 1) == any_wide || c % (lanes * vec) != 0) continue;
    const int tile = lanes * vec;
    for (int cluster = 1; cluster <= kMaxCluster; cluster *= 2) {
      const size_t smem = staged_smem(item, hw, c, lanes, cluster, optin);
      if (smem == 0) continue;
      const int rows = (hw + cluster - 1) / cluster;
      const double blocks = static_cast<double>(n) * (c / tile) * cluster;
      const double staged = static_cast<double>(rows) * tile * item;
      const double key[5] = {
          std::min(blocks, want),
          smem <= static_cast<size_t>(optin) / 2 ? 1.0 : 0.0,
          wide ? static_cast<double>(std::min(tile * item, 128)) : 0.0,
          -static_cast<double>(cluster), -std::fabs(std::log2(staged / aim))};
      bool better = out[0] == 0;
      for (int k = 0; k < 5 && !better; ++k) {
        if (key[k] != best[k]) {
          better = key[k] > best[k];
          break;
        }
      }
      if (!better) continue;
      for (int k = 0; k < 5; ++k) best[k] = key[k];
      out[0] = lanes;
      out[1] = cluster;
      out[2] = rows;
      out[3] = static_cast<int>(smem);
      out[4] = static_cast<int>(blocks);
    }
  }
}

template <typename T>
int launch_staged(const void* x, const void* w, const void* a, const void* b,
                  void* out, int n, int hw, int c, int lanes, int cluster,
                  size_t smem, int optin, float eps, float corr,
                  cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        selfnorm_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const int tile = lanes * Lane16<T>::V;
  const int rows_blk = (hw + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (c / tile), n, 1);
  cfg.blockDim = dim3(kStThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, selfnorm_staged_kernel<T>, static_cast<const T*>(x),
      static_cast<const float*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(out), hw, c, lanes,
      rows_blk, eps, corr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- v1 kernel -------------------------------------------------------------

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

// The staged kernel's plan for (n, hw, c) of dtype (0 = float32, 1 =
// bfloat16) on the current device (staged_plan): out[0..4] = lanes (0
// where the kernel cannot stage these planes), cluster, rows a block
// stages, its dynamic shared memory in bytes, blocks.  Returns the
// cudaError_t of the device queries.
extern "C" int cnsn_selfnorm_plan(int dtype, int n, int hw, int c,
                                  int* out) {
  int f[2];
  if (n < 1 || hw < 1 || c < 1 || (dtype != 0 && dtype != 1) || !card(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  staged_plan(dtype == 0 ? 4 : 2, n, hw, c, f[0], f[1], out);
  return 0;
}

// path: 0 = v1, 1 = staged; dtype: 0 = float32, 1 = bfloat16.  x and out
// are NHWC-contiguous (n, hw, c); w is (c, 2) fp32; a, b are (c,) fp32.
// A staged call takes the plan (lanes = 0) or the forced (lanes, cluster)
// of a sweep; one that the shape, the addresses or the card do not allow
// is refused before any launch.  Returns the cudaError_t of the launch (0
// on success).
extern "C" int cnsn_selfnorm_infer(int dtype, int path, int lanes,
                                   int cluster, const void* x, const void* w,
                                   const void* a, const void* b, void* out,
                                   int n, int hw, int c, float eps,
                                   void* stream) {
  if (n < 1 || n > 65535 || hw < 1 || c < 1 || (dtype != 0 && dtype != 1) ||
      (path != 0 && path != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // unbiased variance (ddof 1), HW / max(HW - 1, 1), as the JAX package
  const float corr =
      static_cast<float>(static_cast<double>(hw) / (hw > 1 ? hw - 1 : 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    return dtype == 0
               ? launch<float>(x, w, a, b, out, n, hw, c, eps, corr, s)
               : launch<__nv_bfloat16>(x, w, a, b, out, n, hw, c, eps, corr,
                                       s);
  }
  const int item = dtype == 0 ? 4 : 2;
  int f[2];
  if (!card(f)) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) {
    int plan[5];
    staged_plan(item, n, hw, c, f[0], f[1], plan);
    lanes = plan[0];
    cluster = plan[1];
  }
  const size_t smem = staged_smem(item, hw, c, lanes, cluster, f[1]);
  if (smem == 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dtype == 0
             ? launch_staged<float>(x, w, a, b, out, n, hw, c, lanes, cluster,
                                    smem, f[1], eps, corr, s)
             : launch_staged<__nv_bfloat16>(x, w, a, b, out, n, hw, c, lanes,
                                            cluster, smem, f[1], eps, corr, s);
}
