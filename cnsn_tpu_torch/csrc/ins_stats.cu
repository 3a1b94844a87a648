// Instance statistics (K1) for Hopper (sm_90a), forward and backward.
//
// Replaces cnsn_tpu/ops/pallas/ins_stats.py: ins_stats_pallas (v1, :78),
// ins_stats_v2 (:140) and the jnp backward of ins_stats_diff (:179-190).
// Per (sample n, channel c) of an NHWC tensor x with HW = H*W rows:
//   forward   mean = S1 / HW,  var = (S2 / HW - mean^2) * HW / max(HW - ddof, 1)
//             std  = sqrt(var + eps)      (one pass, no clamp, as JAX)
//   backward  dx   = gm / HW + gs * (x - mean) / (max(HW - ddof, 1) * std)
//             in x's type, from the fp32 (N, C) mean, std and cotangents.
//
// Bound: bytes.  The forward reads x once (its (N, C) outputs are noise); the
// backward reads x and writes dx.  ResNet-50's 16 SelfNorm sites at b=128
// bf16 hold 5,519,360 elements per image: 1.41 GB, so >= 0.42 ms forward and
// >= 0.84 ms backward per step at 3.35 TB/s.  The image CrossNorm statistics
// (128 x 224 x 224 x 3 fp32) read 77 MB: >= 0.023 ms.  WRN-40-2's 18 sites
// at b=128 32x32 bf16 read 2-8 MB a call: 0.6-2.5 us forward and 1.3-5 us
// backward, about what one launch costs (~5 us, PERF.md).
//
// Forward design: one launch, no scratch.  The TPU
// kernels hold one sample's (HW, 128) plane in VMEM (v2) or carry running
// sums along a sequential HW grid (v1); Hopper blocks have neither the room
// nor the order.  The first port took two launches (fp32 partials per
// (sample, tile, HW chunk) into a scratch buffer, then one thread per
// (n, c) adding its chunks); at WRN's shapes that cost ~9.4 us a call
// against a 1.5 us bound.  Here a block owns a (sample, channel tile,
// chunk of rows): `lanes` threads (a power of two up to the whole block,
// as few as span C: one tile holds every channel of both models' sites)
// cover the tile's row segment with 16-byte evict-first loads (one element
// where C or x's alignment allows no vector: C = 3 images, unaligned
// views), and each thread keeps kUnroll (vectors) or kUnrollOne (elements)
// loads in flight over its rows.  A wide tile leaves little to add across
// threads: at 7x7x2048 each of 256 lanes owns 8 channels over every row,
// so no sum crosses a thread before the cluster's.  The plan
// (ops/kernels/ins_stats.py::ins_stats_plan, a pure function of the shape
// and the card) splits a plane over `split` blocks only where that pays:
// on the card each doubling of a plane's blocks cost ~1.4 us at WRN's
// shapes (stats_sweep's ms_by_split; PERF.md), more than the load
// time it saves, so every WRN-40-2 plane and ResNet-50's 28x28 to 7x7 ones
// take one block, and only planes whose block would take >= 32 unrolled
// steps a thread (56x56x256: 49; the 224x224x3 image: 49) split in two,
// or further while the card holds fewer blocks than SMs (a few images),
// up to one cluster of 8 blocks.  Deeper unrolls at fewer blocks per SM
// ran no faster (--k1-constants).  The blocks of a plane are one
// thread-block cluster and add their sums without a second launch: rank 0
// adds the ranks' sums in rank order over distributed shared memory and
// writes mean and std.  No sum takes an atomic, so the bits are the same
// run to run.
//
// Rounding.  Each thread sums its rows' x and x*x (each square rounded on
// its own: no FMA, as the plain version) in fp32, in row order.  The
// threads' sums are then added in fp64: a fixed butterfly of shuffles over
// the row groups of a warp (lanes < 32), the row groups in order through
// shared memory, then the cluster's ranks in order, and rounded once to
// fp32 S1 and S2.  The finishing arithmetic is the first port's:
// mean = S1 / HW, the square of the mean with __fmul_rn (an FMA's exact
// m^2 would leave the negative rounding error of S2/HW as the variance of
// a constant plane and sqrt gives NaN at HW = 1), the HW/(HW - ddof)
// correction, eps inside the sqrt, no clamp.
//
// Backward design: a one-wave streaming pass, the form of bn_stats.cu's
// backward with per-(sample, channel) statistics.  The first port's kernel
// ran on a grid of row chunks sized to about 8 blocks per SM: one or two
// 16-byte loads a thread at WRN's shapes, `#pragma unroll 4` over ~50 row
// steps at the flagship's; 61% of its bound at the flagship, 24% at WRN.
// Here the plan (ops/kernels/ins_stats.py::ins_bwd_plan, a pure function of
// the shape and the card) gives `lanes` threads (a power of two up to the
// whole block, as few as span C) a tile of lanes * V channels, so one tile
// holds every channel where C <= 256 * V (C = 16 bf16: 2 lanes, 128 rows a
// block step; C = 2048: 256 lanes, one row), and cuts each (sample, tile)
// plane's rows into contiguous chunks: as many as fill one wave of the
// kernel's residency, each at least one unrolled step a thread, none empty.
// Each thread loads its V channels' mean, std, gm and gs once, forms
// a = gm / HW and den = max(HW - ddof, 1) * std once, keeps kBwdUnroll
// evict-first 16-byte loads of x in flight and writes dx with plain stores
// (evict-first stores ran 0-2.5% slower for K2's backward: PERF.md).  Its
// first step's loads of x go out before the statistics are waited on, so
// the two reads' latencies overlap (0.3-0.6 us a call at WRN's shapes on
// the H100).  The statistics take 4 V registers a thread, 32 at V = 8: with
// 4 loads in flight the bf16 kernel spilled at 4 blocks an SM (64
// registers) and ran ~40% slower at 56x56x256 on the H100; 2 loads at 4
// blocks an SM, 4 at 3 and 8 at 2 ran alike (stats_sweep --k1-constants).
//
// Rounding: per element a + (gs * (x - mean)) / den, each operation rounded
// on its own (IEEE divisions, no reciprocal, no FMA contraction), then one
// round-to-nearest-even cast to x's type: the plain version's operations in
// its order, and the same bits as the first port's kernel
// (utils/stats_sweep.py --only k1bwd --baseline checks it at every model
// shape).  On the card torch divides gm by the number HW with a rounded
// reciprocal, so the plain version gives the same bits where HW is a power
// of two (WRN-40-2's sites) and may differ by a last bit elsewhere.
#include <cooperative_groups.h>
#include <limits.h>

#include "row_pass.cuh"

namespace {

namespace cg = cooperative_groups;
using row_pass::kThreads;

constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;          // blocks of a cluster, at most
constexpr int kFwdBlocksPerSm = 4;   // residency the registers are held to
constexpr int kUnroll = 8;           // 16-byte loads in flight per thread
constexpr int kUnrollOne = 16;       // one-element loads in flight per thread
constexpr int kBwdUnroll = 2;        // the backward's loads in flight
constexpr int kBwdBlocksPerSm = 4;   // the backward's residency, at least
// The type of a thread's sums over its rows, and of the sums across
// threads (see Rounding above).
using Acc = float;
using Sum = double;

// Grid (split, ctiles, n) in clusters of (split, 1, 1), kThreads threads:
// block (k, t, b) sums rows [k * chunk_rows, (k + 1) * chunk_rows) of
// channel tile t (lanes * V channels, lanes a power of two up to kThreads)
// of sample b, and rank 0 of the cluster finishes the plane.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
ins_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ std_out, int hw, int c,
                         int lanes, int chunk_rows, float eps, float corr) {
  using L = row_pass::XLoad<T, V>;
  constexpr int kRed = kThreads * V;  // one sum per thread and channel
  constexpr int kU = V == 1 ? kUnrollOne : kUnroll;
  // red[s][slot * tile + col]: the row groups' sums, s = 0 of x, 1 of x*x;
  // after the block's add, red[s][col] holds the block's sums (its
  // cluster reads them there)
  __shared__ Sum red[2][kRed];
  const int t = threadIdx.x;
  const int lane = t & (lanes - 1);
  const int step = kThreads / lanes;
  const int tile = lanes * V;
  const int cbase = blockIdx.y * tile;
  const int c0 = cbase + lane * V;
  const int b = blockIdx.z;
  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = r_begin + chunk_rows < hw ? r_begin + chunk_rows : hw;

  Acc s1[V];
  Acc s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[i] = 0;
    s2[i] = 0;
  }
  if (c0 < c) {
    const T* xs = x + static_cast<size_t>(b) * hw * c + c0;
    // kU loads in flight (the tail's predicated off), then their sums in
    // row order
    for (int r = r_begin + t / lanes; r < r_end; r += kU * step) {
      typename L::Raw raw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * step < r_end) {
          raw[u] = L::load(xs + static_cast<size_t>(r + u * step) * c);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * step < r_end) {
          float v[V];
          L::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s1[i] += static_cast<Acc>(v[i]);
            s2[i] += static_cast<Acc>(__fmul_rn(v[i], v[i]));
          }
        }
      }
    }
  }

  // Narrow tiles (lanes < 32): a warp holds 32 / lanes row groups, added
  // by a butterfly over the lane bits above `lanes` into its first `lanes`
  // threads.  Then each slot of `span` threads (a warp, or the lanes / 32
  // warps of one row group) holds one row group's sums, added in slot
  // order.
  Sum a[V];
  Sum q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = s1[i];
    q[i] = s2[i];
  }
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
    }
  }
  const int span = lanes < 32 ? 32 : lanes;
  const int slots = kThreads / span;
  if (t % span < lanes) {
    const int o = (t / span) * tile + lane * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][o + i] = a[i];
      red[1][o + i] = q[i];
    }
  }
  __syncthreads();
  if (slots > 1) {
    // each (s, col) by one thread, into slot 0 of its own column
    for (int i = t; i < 2 * tile; i += kThreads) {
      const int s = i / tile;
      const int col = i - s * tile;
      Sum acc = 0;
      for (int k = 0; k < slots; ++k) acc += red[s][k * tile + col];
      red[s][col] = acc;
    }
  }

  // the cluster's ranks, in rank order, by rank 0
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (cluster.block_rank() == 0) {
    const int cols = c - cbase < tile ? c - cbase : tile;
    const float count = static_cast<float>(hw);
    const size_t out = static_cast<size_t>(b) * c + cbase;
    for (int col = t; col < cols; col += kThreads) {
      Sum t1 = 0;
      Sum t2 = 0;
      for (int rk = 0; rk < ranks; ++rk) {
        const Sum* o = ranks > 1 ? cluster.map_shared_rank(&red[0][0], rk)
                                 : &red[0][0];
        t1 += o[col];
        t2 += o[kRed + col];
      }
      const float m = static_cast<float>(t1) / count;
      const float var =
          (static_cast<float>(t2) / count - __fmul_rn(m, m)) * corr;
      mean[out + col] = m;
      std_out[out + col] = sqrtf(var + eps);
    }
  }
  // no block leaves while rank 0 may still read its sums
  if (ranks > 1) cluster.sync();
}

cudaLaunchConfig_t cluster_config(dim3 grid, int ranks, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  return cfg;
}

template <typename T, int V>
struct InsStatsFwd {
  static void run(const void* x, float* mean, float* std_out, int n, int hw,
                  int c, int lanes, int split, int chunk_rows, float eps,
                  float corr, cudaStream_t stream, cudaError_t* err) {
    const int tile = lanes * V;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        dim3(split, (c + tile - 1) / tile, n), split, stream, &attr);
    *err = cudaLaunchKernelEx(&cfg, ins_stats_cluster_kernel<T, V>,
                              static_cast<const T*>(x), mean, std_out, hw, c,
                              lanes, chunk_rows, eps, corr);
  }
};

// What one wave of the forward kernel for <T, V> holds: out[0] resident
// blocks per SM, out[1] resident clusters of kCluster blocks on the card.
template <typename T, int V>
struct InsStatsOccupancy {
  static void run(int* out) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(kCluster, 1, 1), kCluster, nullptr, &attr);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[0], ins_stats_cluster_kernel<T, V>, kThreads, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(
            &out[1], ins_stats_cluster_kernel<T, V>, &cfg) != cudaSuccess) {
      out[0] = out[1] = 0;
    }
  }
};

// Grid (chunks, ctiles, n), kThreads threads: block (k, t, b) writes dx
// over rows [k * chunk_rows, (k + 1) * chunk_rows) of channel tile t (lanes
// * V channels; `lanes`, a power of two up to kThreads, span the tile's row
// segment, so a block step reads and writes kThreads / lanes whole rows of
// the tile) of sample b, kBwdUnroll loads in flight per thread.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
ins_bwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ std_in,
                      const float* __restrict__ gm,
                      const float* __restrict__ gs, T* __restrict__ dx,
                      int hw, int c, int lanes, int chunk_rows, float denom) {
  using L = row_pass::XLoad<T, V>;
  const int t = threadIdx.x;
  const int step = kThreads / lanes;
  const int rin = t / lanes;
  const int c0 = blockIdx.y * lanes * V + (t - rin * lanes) * V;
  if (c0 >= c) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * hw * c + c0;
  const T* xs = x + plane;
  T* ds = dx + plane;
  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = r_begin + chunk_rows < hw ? r_begin + chunk_rows : hw;
  int r = r_begin + rin;
  typename L::Raw raw[kBwdUnroll];
  auto load_step = [&]() {
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * step < r_end) {
        raw[u] = L::load(xs + static_cast<size_t>(r + u * step) * c);
      }
    }
  };
  load_step();  // before the statistics are waited on
  const size_t stat = static_cast<size_t>(blockIdx.z) * c + c0;
  float m[V];
  float a[V];
  float k[V];
  float den[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = mean[stat + i];
    a[i] = __fdiv_rn(gm[stat + i], static_cast<float>(hw));
    k[i] = gs[stat + i];
    den[i] = __fmul_rn(denom, std_in[stat + i]);
  }
  while (r < r_end) {
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * step < r_end) {
        float v[V];
        L::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          // a + (k (x - m)) / den with each step rounded: no FMA
          // contraction, no reciprocal
          v[i] = __fadd_rn(
              a[i], __fdiv_rn(__fmul_rn(k[i], __fsub_rn(v[i], m[i])), den[i]));
        }
        row_pass::store_x<false, T, V>(
            ds + static_cast<size_t>(r + u * step) * c, v);
      }
    }
    r += kBwdUnroll * step;
    load_step();
  }
}

template <typename T, int V>
struct InsBwd {
  static void run(const void* x, const void* mean, const void* std_in,
                  const void* gm, const void* gs, void* dx, int n, int hw,
                  int c, int lanes, int chunks, int chunk_rows, float denom,
                  cudaStream_t stream) {
    const int tile = lanes * V;
    const dim3 grid(chunks, (c + tile - 1) / tile, n);
    ins_bwd_stream_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(std_in), static_cast<const float*>(gm),
        static_cast<const float*>(gs), static_cast<T*>(dx), hw, c, lanes,
        chunk_rows, denom);
  }
};

// The backward kernel's resident blocks per SM for <T, V>.
template <typename T, int V>
struct InsBwdOccupancy {
  static void run(int* out) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, ins_bwd_stream_kernel<T, V>, kThreads, 0) != cudaSuccess) {
      *out = 0;
    }
  }
};

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// The forward kernel's residency for (dtype, vec): out[0] blocks per SM,
// out[1] clusters of 8 on the card.  Returns 0, or cudaErrorInvalidValue
// for a (dtype, vec) without a kernel or a failed query.
extern "C" int cnsn_ins_stats_occupancy(int dtype, int vec, int* out) {
  if (!row_pass::dispatch<InsStatsOccupancy>(dtype, vec, out) ||
      out[0] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The forward, one launch.  dtype: 0 = float32, 1 = bfloat16; vec: 1, or
// 4 (fp32) / 8 (bf16) when c is a multiple of it and x is 16-byte aligned.
// x is NHWC-contiguous (n, hw, c); mean and std are (n, c) fp32.  The plan
// (ops/kernels/ins_stats.py::ins_stats_plan): `lanes` (1..256, a power of
// two) threads across a tile of lanes * vec channels, `split` blocks per
// (sample, tile) of `chunk_rows` rows each (split * chunk_rows >= hw), one
// cluster of split (1, 2, 4 or 8) blocks a plane.  Returns the cudaError_t
// of the launch (0 on success), cudaErrorInvalidValue for a plan or
// arguments it does not take.
extern "C" int cnsn_ins_stats(int dtype, int vec, const void* x, void* mean,
                              void* std_out, int n, int hw, int c, int lanes,
                              int split, int chunk_rows, float eps, int ddof,
                              void* stream) {
  if (!row_pass::valid_pass(dtype, n, hw, c, vec, x, nullptr) || ddof < 0 ||
      static_cast<long long>(n) * c > INT_MAX || !power_of_two(lanes) ||
      lanes > kThreads || !power_of_two(split) || split > kCluster ||
      chunk_rows < 1 || static_cast<long long>(split) * chunk_rows < hw ||
      (c + lanes * vec - 1) / (lanes * vec) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // HW / max(HW - ddof, 1), as the JAX package corrects the variance
  const float corr = static_cast<float>(
      static_cast<double>(hw) / (hw - ddof > 1 ? hw - ddof : 1));
  cudaError_t err = cudaSuccess;
  if (!row_pass::dispatch<InsStatsFwd>(
          dtype, vec, x, static_cast<float*>(mean),
          static_cast<float*>(std_out), n, hw, c, lanes, split, chunk_rows,
          eps, corr, static_cast<cudaStream_t>(stream), &err)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's resident blocks per SM for (dtype, vec) in *out.
// Returns 0, or cudaErrorInvalidValue for a (dtype, vec) without a kernel
// or a failed query.
extern "C" int cnsn_ins_stats_bwd_occupancy(int dtype, int vec, int* out) {
  if (!row_pass::dispatch<InsBwdOccupancy>(dtype, vec, out) || *out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// dx = gm / hw + gs * (x - mean) / (max(hw - ddof, 1) * std), written in x's
// type.  x and dx are NHWC-contiguous (n, hw, c) of one dtype; mean, std, gm
// and gs are (n, c) fp32.  The plan (ops/kernels/ins_stats.py::
// ins_bwd_plan): `lanes` (1..256, a power of two) threads across a tile of
// lanes * vec channels, `chunks` blocks per (sample, tile) of `chunk_rows`
// rows each (chunks * chunk_rows >= hw).  Returns the cudaError_t of the
// launch, cudaErrorInvalidValue for a plan or arguments it does not take.
extern "C" int cnsn_ins_stats_bwd(int dtype, int vec, const void* x,
                                  const void* mean, const void* std_in,
                                  const void* gm, const void* gs, void* dx,
                                  int n, int hw, int c, int ddof, int lanes,
                                  int chunks, int chunk_rows, void* stream) {
  if (!row_pass::valid_pass(dtype, n, hw, c, vec, x, dx) || ddof < 0 ||
      static_cast<long long>(n) * c > INT_MAX || !power_of_two(lanes) ||
      lanes > kThreads || chunks < 1 || chunk_rows < 1 ||
      static_cast<long long>(chunks) * chunk_rows < hw ||
      (c + lanes * vec - 1) / (lanes * vec) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float denom = static_cast<float>(hw - ddof > 1 ? hw - ddof : 1);
  if (!row_pass::dispatch<InsBwd>(dtype, vec, x, mean, std_in, gm, gs, dx, n,
                                  hw, c, lanes, chunks, chunk_rows, denom,
                                  static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
