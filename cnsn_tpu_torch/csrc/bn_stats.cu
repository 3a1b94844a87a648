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
// backward per step at 3.35 TB/s.  Half of the 53 sites are at 14x14 or
// 7x7, where the bound is 2-15 us, so a fixed cost per call weighs as much
// as the bandwidth.
//
// Forward design: one launch.  The TPU kernel carries the sums in VMEM
// scratch along a sequential grid of row chunks; Hopper blocks run in no
// order.  The first port took two launches: blocks over (channel tile, row
// chunk) wrote partials, then a second launch of ceil(C/32) blocks walked
// up to 1,024 of them per thread in series, ~15 us a call, most of the time
// at the 14x14 and 7x7 sites.  Here the grid is one wave, the kernel's own
// occupancy times the SM count, split into channel tiles x row chunks
// (fwd_plan).  A block owns one tile of 64 bf16 or 32 fp32 channels (8
// lanes of 16-byte loads span a 128-byte row segment; a warp reads four)
// and sweeps its chunk's contiguous rows with kUnroll loads in flight per
// thread.  x is read once, so the loads are evict-first: they leave the
// L2's other lines, clean or dirty, where they are.  The block adds its
// threads' sums through shared memory.  Where a tile has kClusterMin
// chunks or more (the 112x112 and 56x56 sites at C = 64), its blocks run
// in clusters of 8 and rank 0 adds the cluster's sums in rank order over
// distributed shared memory, so the final add below reads 8x fewer
// partials.  Each block (or cluster) writes one (s1, s2) partial, then
// takes a ticket: __threadfence() and an atomicAdd on its tile's counter.
// The one that draws the last ticket adds the tile's partials in a fixed
// order (contiguous groups of partials per thread, then the groups in
// order through shared memory), writes s1 and s2 and puts the counter
// back to 0.
// The atomic only chooses which block adds; the sums take no atomics.
// Narrow tiles keep the final add short: wide C makes more tiles, each with
// fewer chunks, added by different blocks at once.  A chunk holds at least
// kMinSteps row steps per thread, so a small input runs fewer blocks and
// leaves less to add.  The counters are a small int32 buffer the caller
// keeps per (device, stream), zeroed once when it is made: calls on one
// stream run in order, and two streams never share one.
//
// Rounding: each difference x - m0 and each square is rounded to fp32 on
// its own, as the plain version forms them (no FMA contraction), and every
// sum from the thread's rows to the final add is taken in fp64, then
// rounded once to fp32.  Up to 1.6M fp32 terms add in fp64 with an error
// far below half an fp32 ulp of the sum, so s1 and s2 are the correctly
// rounded sums (unless the exact sum lies within that fp64 error of an
// fp32 rounding midpoint): the same bits whatever the plan, the SM count
// or the order, and the same as
// cnsn_tpu_torch.train.rounding.exact_bn_sums.  An fp32 sum's rounding
// depends on its order, and a float32 training run carries that into
// later steps (PERF.md, PR 7).  The fp64 work is two fp32-to-fp64
// conversions and two adds per element.  At 16 conversions a clock per SM
// the conversions alone take about as long as the memory (~3.7 TB/s of
// bf16 against 3.35), so the main pass is co-limited by them: ~5% slower
// than with fp32 sums.  The accumulators take 32 registers at V = 8; three
// blocks of 256 threads per SM (80 registers) ran faster than four (64,
// spilling) or five.
//
// Backward design: a one-wave streaming pass.  The first port's kernel ran
// on a grid of row chunks sized to about 8 blocks per SM (one or two
// 16-byte loads a thread at WRN's shapes, `#pragma unroll 4` over ~50 row
// steps at the flagship's), 66% of HBM's rate at the flagship and 30% at
// WRN.  Here the
// plan (ops/kernels/bn_stats.py::bn_bwd_plan, a pure function of the shape
// and the card) sizes the grid to one wave of the kernel's residency: a
// tile spans up to a whole block of 16-byte lanes (C = 64 bf16: 8 lanes,
// a block step covers 32 rows; C = 2048: one row), so one tile holds every
// channel where C <= 256 * V, and the tile's rows go to contiguous chunks
// of at least one unrolled step per thread.  Each thread loads its
// channels' m0, g1 and g2 once, keeps kBwdUnroll evict-first 16-byte loads
// of x in flight, and writes dx with plain stores.  Evict-first stores
// (st.global.cs, kBwdStreamStores = 1) ran 0-2.5% slower at every model
// shape (stats_sweep --k2-constants kBwdStreamStores=1 times them).
// Every product and sum is rounded on its own,
// as the plain version and the first port's kernel compute them
// (__fadd_rn(g1, __fmul_rn(__fmul_rn(2, x - m0), g2))): the same bits as
// the first port's kernel (utils/stats_sweep.py --baseline checks it at
// every model shape).
#include <cooperative_groups.h>

#include "row_pass.cuh"

namespace {

namespace cg = cooperative_groups;
using row_pass::kThreads;

constexpr int kUnroll = 4;       // 16-byte loads in flight per thread
constexpr int kMinSteps = 8;     // row steps per thread in a chunk, at least
constexpr int kFwdLanes = 8;     // 16-byte lanes across a forward row segment
constexpr int kMaxTile = 64;     // channels of a forward tile, at most
constexpr int kCluster = 8;      // blocks of a cluster over row chunks
constexpr int kClusterMin = 256; // chunks a tile needs before it clusters
constexpr int kFwdBlocksPerSm = 3;  // residency the registers are held to
constexpr int kBwdUnroll = 4;    // the backward's 16-byte loads in flight
constexpr int kBwdBlocksPerSm = 4;  // the backward's residency, at least
constexpr int kBwdStreamStores = 0;  // 1: dx stored evict-first
// The type of every sum: fp64, so s1 and s2 come out correctly rounded
// (see the note above).  utils/stats_sweep.py --k2-constants builds copies
// with other constants, float sums among them, to time them beside it.
using Sum = double;

struct Geometry {
  int lanes;          // threads across one row segment of the tile
  int rows_per_iter;  // rows a block advances per step: kThreads / lanes
  int tile;           // channels per block: lanes * vec
  int ctiles;         // channel tiles: ceil(c / tile)
};

// The forward's tiles: 8 lanes of 16 bytes, or up to 32 one-element lanes
// where x takes no 16-byte loads.
__host__ __device__ inline Geometry fwd_geometry(int c, int vec) {
  Geometry g;
  const int per_row = (c + vec - 1) / vec;
  const int most = vec == 1 ? 32 : kFwdLanes;
  g.lanes = per_row < most ? per_row : most;
  g.rows_per_iter = kThreads / g.lanes;
  g.tile = g.lanes * vec;
  g.ctiles = (c + g.tile - 1) / g.tile;
  return g;
}

template <int VF>
__device__ __forceinline__ void load_part(const Sum* p, Sum (&v)[VF]) {
  if constexpr (VF == 2) {
    using Pair = typename std::conditional<std::is_same<Sum, double>::value,
                                           double2, float2>::type;
    const Pair q = __ldcg(reinterpret_cast<const Pair*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

// The last block of channel tile blockIdx.x adds the tile's `parts`
// partials: thread i takes one (sum, VF channels) pair over a contiguous
// group of partials, in order; then the groups are added in order through
// `red` (kThreads * VF sums at most) and each sum is rounded once to
// fp32.  Reads with __ldcg: the partials were written by other SMs.
template <int VF>
__device__ void add_partials(const Sum* __restrict__ part,
                             Sum* __restrict__ red, float* __restrict__ s1,
                             float* __restrict__ s2, int parts, int c,
                             int cbase, int cols) {
  const int ncv = cols / VF;
  const int pairs = 2 * ncv;
  int groups = kThreads / pairs;
  if (groups < 1) groups = 1;
  if (groups > parts) groups = parts;
  for (int i = threadIdx.x; i < pairs * groups; i += kThreads) {
    const int pair = i % pairs;
    const int grp = i / pairs;
    const int s = pair / ncv;
    const int cv = pair % ncv;
    const int k0 = grp * parts / groups;
    const int k1 = (grp + 1) * parts / groups;
    const Sum* p =
        part + static_cast<size_t>(s) * parts * c + cbase + cv * VF;
    Sum acc[VF];
#pragma unroll
    for (int j = 0; j < VF; ++j) acc[j] = 0;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      Sum v[VF];
      load_part<VF>(p + static_cast<size_t>(k) * c, v);
#pragma unroll
      for (int j = 0; j < VF; ++j) acc[j] += v[j];
    }
#pragma unroll
    for (int j = 0; j < VF; ++j) {
      red[(grp * 2 + s) * cols + cv * VF + j] = acc[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * cols; i += kThreads) {
    const int s = i / cols;
    const int col = i % cols;
    Sum tot = 0;
    for (int grp = 0; grp < groups; ++grp) {
      tot += red[(grp * 2 + s) * cols + col];
    }
    (s == 0 ? s1 : s2)[cbase + col] = static_cast<float>(tot);
  }
}

// Grid (ctiles, chunks) in clusters of 1 x ranks x 1, kThreads threads:
// block (t, k) sums rows [k * chunk_rows, (k + 1) * chunk_rows) of channel
// tile t; a cluster's blocks add their sums in rank order over distributed
// shared memory, and rank 0 writes them as partial k / ranks, part[0][.]
// of x - m0 and part[1][.] of its squares.  With `finish`, the last
// cluster of each tile adds the tile's partials into s1 and s2 (without it
// the call stops at the partials: the main pass alone, for sweeps).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
bn_sums_persistent_kernel(const T* __restrict__ x,
                          const float* __restrict__ m0,
                          Sum* __restrict__ part,
                          unsigned int* __restrict__ tickets,
                          float* __restrict__ s1, float* __restrict__ s2,
                          int rows, int c, int chunk_rows, int finish) {
  using L = row_pass::XLoad<T, V>;
  constexpr int kPlane = kThreads * (V > 2 ? V : 2);
  __shared__ Sum red[2 * kPlane];
  __shared__ Sum mine[2 * kMaxTile];  // this block's sums, for its cluster
  __shared__ bool last;
  const Geometry g = fwd_geometry(c, V);
  const int t = threadIdx.x;
  const int lane = t % g.lanes;
  const int rin = t / g.lanes;
  const int cbase = blockIdx.x * g.tile;
  const int c0 = cbase + lane * V;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
  const bool live = rin < g.rows_per_iter && c0 < c;

  Sum a[V];
  Sum q[V];
  float m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0;
    q[i] = 0;
    m[i] = live ? m0[c0 + i] : 0.f;
  }
  if (live) {
    const T* xs = x + c0;
    const int rstep = g.rows_per_iter;
    int r = r_begin + rin;
    // kUnroll loads in flight, then their sums in row order
    for (; r + (kUnroll - 1) * rstep < r_end; r += kUnroll * rstep) {
      typename L::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        raw[u] = L::load(xs + static_cast<size_t>(r + u * rstep) * c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[V];
        L::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = v[i] - m[i];
          a[i] += static_cast<Sum>(d);
          q[i] += static_cast<Sum>(__fmul_rn(d, d));
        }
      }
    }
    for (; r < r_end; r += rstep) {
      float v[V];
      L::unpack(L::load(xs + static_cast<size_t>(r) * c), v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - m[i];
        a[i] += static_cast<Sum>(d);
        q[i] += static_cast<Sum>(__fmul_rn(d, d));
      }
    }
  }
  if (rin < g.rows_per_iter) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[rin * g.tile + lane * V + i] = a[i];
      red[kPlane + rin * g.tile + lane * V + i] = q[i];
    }
  }
  __syncthreads();

  const int cols = c - cbase < g.tile ? c - cbase : g.tile;
  for (int col = t; col < cols; col += kThreads) {
    Sum sa = 0;
    Sum sq = 0;
    for (int k = 0; k < g.rows_per_iter; ++k) {
      sa += red[k * g.tile + col];
      sq += red[kPlane + k * g.tile + col];
    }
    mine[col] = sa;
    mine[kMaxTile + col] = sq;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int parts = gridDim.y / ranks;
  const int k = blockIdx.y / ranks;
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (cluster.block_rank() == 0) {
    for (int col = t; col < cols; col += kThreads) {
      Sum sa = 0;
      Sum sq = 0;
      for (int rk = 0; rk < ranks; ++rk) {
        const Sum* o =
            ranks > 1 ? cluster.map_shared_rank(mine, rk) : mine;
        sa += o[col];
        sq += o[kMaxTile + col];
      }
      part[static_cast<size_t>(k) * c + cbase + col] = sa;
      part[static_cast<size_t>(parts + k) * c + cbase + col] = sq;
    }
  }
  // no block leaves while rank 0 may still read its sums
  if (ranks > 1) cluster.sync();
  if (!finish || cluster.block_rank() != 0) return;

  // the ticket: every writer's partials are visible before it is drawn
  __threadfence();
  __syncthreads();
  if (t == 0) {
    last = atomicAdd(&tickets[blockIdx.x], 1u) ==
           static_cast<unsigned>(parts - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (c % 2 == 0) {
    add_partials<2>(part, red, s1, s2, parts, c, cbase, cols);
  } else {
    add_partials<1>(part, red, s1, s2, parts, c, cbase, cols);
  }
  if (t == 0) tickets[blockIdx.x] = 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
    }
  }
  return sms;
}

cudaLaunchConfig_t fwd_config(dim3 grid, int ranks, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = ranks;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  return cfg;
}

// What one wave of the forward kernel for <T, V> holds, queried once:
// out[0] resident blocks per SM, out[1] resident clusters of kCluster
// blocks on the card.
template <typename T, int V>
struct FwdOccupancy {
  static void run(int* out) {
    static int n[2] = {0, 0};
    if (n[0] == 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          fwd_config(dim3(1, kCluster, 1), kCluster, nullptr, &attr);
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n[0], bn_sums_persistent_kernel<T, V>, kThreads, 0) !=
              cudaSuccess ||
          cudaOccupancyMaxActiveClusters(
              &n[1], bn_sums_persistent_kernel<T, V>, &cfg) != cudaSuccess) {
        n[0] = n[1] = 0;
      }
    }
    out[0] = n[0];
    out[1] = n[1];
  }
};

// The forward's plan: {row chunks per channel tile, channel tiles,
// resident blocks per SM, channels per tile, blocks per cluster}.  Chunks
// fill one wave of resident blocks over the tiles and hold at least
// kMinSteps row steps per thread; where a tile has kClusterMin chunks or
// more, they run in clusters of kCluster (a multiple of it, within the
// card's resident clusters), so the final add reads 8x fewer partials.
// forced > 0 replaces the chunk count (sweeps).  False if the device
// cannot be queried.
bool fwd_plan(int dtype, int vec, int rows, int c, int forced, int* out) {
  const Geometry g = fwd_geometry(c, vec);
  int occ[2] = {0, 0};
  const int sms = sm_count();
  if (!row_pass::dispatch<FwdOccupancy>(dtype, vec, occ) || occ[0] < 1 ||
      sms < 1) {
    return false;
  }
  const long long steps = (rows + g.rows_per_iter - 1) / g.rows_per_iter;
  long long chunks = forced;
  if (chunks < 1) {
    const long long fill = static_cast<long long>(occ[0]) * sms / g.ctiles;
    const long long deep = (steps + kMinSteps - 1) / kMinSteps;
    chunks = fill < deep ? fill : deep;
    const long long clustered =
        static_cast<long long>(occ[1]) / g.ctiles * kCluster;
    if (chunks >= kClusterMin && clustered >= kClusterMin) {
      chunks = (chunks < clustered ? chunks : clustered) / kCluster * kCluster;
    }
  }
  const long long most = 65535 / kCluster * kCluster;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  out[0] = static_cast<int>(chunks);
  out[1] = g.ctiles;
  out[2] = occ[0];
  out[3] = g.tile;
  out[4] = chunks >= kClusterMin && chunks % kCluster == 0 ? kCluster : 1;
  return true;
}

template <typename T, int V>
struct BnSums {
  static void run(const void* x, const void* m0, Sum* part,
                  unsigned int* tickets, float* s1, float* s2, int rows,
                  int c, int chunks, int ranks, int finish,
                  cudaStream_t stream, cudaError_t* err) {
    const Geometry g = fwd_geometry(c, V);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        fwd_config(dim3(g.ctiles, chunks, 1), ranks, stream, &attr);
    *err = cudaLaunchKernelEx(
        &cfg, bn_sums_persistent_kernel<T, V>, static_cast<const T*>(x),
        static_cast<const float*>(m0), part, tickets, s1, s2, rows, c,
        row_pass::chunk_rows(rows, chunks), finish);
  }
};

// Grid (chunks, ctiles), kThreads threads: block (k, t) writes dx over rows
// [k * chunk_rows, (k + 1) * chunk_rows) of channel tile t (lanes * V
// channels; `lanes` threads span the tile's row segment, up to all
// kThreads, so a block step reads and writes kThreads / lanes whole rows
// of the tile), kBwdUnroll 16-byte loads in flight per thread.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
bn_bwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ m0,
                     const float* __restrict__ g1,
                     const float* __restrict__ g2, T* __restrict__ dx,
                     int rows, int c, int lanes, int chunk_rows) {
  using L = row_pass::XLoad<T, V>;
  const int t = threadIdx.x;
  const int step = kThreads / lanes;
  const int rin = t / lanes;
  const int c0 = blockIdx.y * lanes * V + (t - rin * lanes) * V;
  if (rin >= step || c0 >= c) return;
  float m[V];
  float a[V];
  float k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = m0[c0 + i];
    a[i] = g1[c0 + i];
    k[i] = g2[c0 + i];
  }
  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
  for (int r = r_begin + rin; r < r_end; r += kBwdUnroll * step) {
    typename L::Raw raw[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * step < r_end) {
        raw[u] = L::load(x + static_cast<size_t>(r + u * step) * c + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * step < r_end) {
        float v[V];
        L::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          // g1 + (2 d) g2 with each step rounded: no FMA contraction
          v[i] = __fadd_rn(a[i],
                           __fmul_rn(__fmul_rn(2.f, v[i] - m[i]), k[i]));
        }
        row_pass::store_x<kBwdStreamStores != 0, T, V>(
            dx + static_cast<size_t>(r + u * step) * c + c0, v);
      }
    }
  }
}

template <typename T, int V>
struct BnBwd {
  static void run(const void* x, const void* m0, const void* g1,
                  const void* g2, void* dx, int rows, int c, int lanes,
                  int chunks, int chunk_rows, cudaStream_t stream) {
    const int tile = lanes * V;
    const dim3 grid(chunks, (c + tile - 1) / tile, 1);
    bn_bwd_stream_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(m0),
        static_cast<const float*>(g1), static_cast<const float*>(g2),
        static_cast<T*>(dx), rows, c, lanes, chunk_rows);
  }
};

// The backward kernel's resident blocks per SM for <T, V>.
template <typename T, int V>
struct BwdOccupancy {
  static void run(int* out) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, bn_bwd_stream_kernel<T, V>, kThreads, 0) != cudaSuccess) {
      *out = 0;
    }
  }
};

}  // namespace

// The forward's plan for a call (fwd_plan): out[0..4] = row chunks per
// channel tile, channel tiles, resident blocks per SM, channels per tile,
// blocks per cluster.  The caller allocates a (2, chunks / cluster, c)
// fp64 partials buffer and a counter buffer of at least `channel tiles`
// zeroed int32.  chunks > 0 forces the chunk count (sweeps).  Returns the
// cudaError_t of the device queries.
extern "C" int cnsn_bn_sums_plan(int dtype, int vec, int rows, int c,
                                 int chunks, int* out) {
  if (rows < 1 || c < 1 || (vec > 1 && c % vec != 0) ||
      !fwd_plan(dtype, vec, rows, c, chunks, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; vec: 1, or 4 (fp32) / 8 (bf16) when c is
// a multiple of it and x is 16-byte aligned.  x is row-major (rows, c); m0,
// s1 and s2 are (c,) fp32; part, tickets, chunks and cluster as the plan
// above says (the tickets are left zeroed).  finish = 0 stops after the
// partials (s1, s2 untouched; sweeps only).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cnsn_bn_sums(int dtype, int vec, const void* x, const void* m0,
                            void* part, void* tickets, int n_tickets,
                            void* s1, void* s2, int rows, int c, int chunks,
                            int cluster, int finish, void* stream) {
  if (!row_pass::valid_pass(dtype, 1, rows, c, vec, x, nullptr) ||
      chunks < 1 || chunks > 65535 || (cluster != 1 && cluster != kCluster) ||
      chunks % cluster != 0 || fwd_geometry(c, vec).ctiles > n_tickets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (!row_pass::dispatch<BnSums>(dtype, vec, x, m0,
                                  static_cast<Sum*>(part),
                                  static_cast<unsigned int*>(tickets),
                                  static_cast<float*>(s1),
                                  static_cast<float*>(s2), rows, c, chunks,
                                  cluster, finish,
                                  static_cast<cudaStream_t>(stream), &err)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's resident blocks per SM for (dtype, vec) in *out.
// Returns 0, or cudaErrorInvalidValue for a (dtype, vec) without a kernel
// or a failed query.
extern "C" int cnsn_bn_sums_bwd_occupancy(int dtype, int vec, int* out) {
  if (!row_pass::dispatch<BwdOccupancy>(dtype, vec, out) || *out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// dx = g1 + 2 (x - m0) g2 per channel, written in x's type.  x and dx are
// row-major (rows, c) of one dtype; m0, g1, g2 are (c,) fp32.  The plan
// (ops/kernels/bn_stats.py::bn_bwd_plan): `lanes` (1..256) threads across a
// tile of lanes * vec channels, `chunks` blocks per tile of `chunk_rows`
// rows each (chunks * chunk_rows >= rows).
// Returns the cudaError_t of the launch, cudaErrorInvalidValue for a plan
// or arguments it does not take.
extern "C" int cnsn_bn_sums_bwd(int dtype, int vec, const void* x,
                                const void* m0, const void* g1,
                                const void* g2, void* dx, int rows, int c,
                                int lanes, int chunks, int chunk_rows,
                                void* stream) {
  if (!row_pass::valid_pass(dtype, 1, rows, c, vec, x, dx) || lanes < 1 ||
      lanes > kThreads || chunks < 1 || chunk_rows < 1 ||
      static_cast<long long>(chunks) * chunk_rows < rows ||
      (c + lanes * vec - 1) / (lanes * vec) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!row_pass::dispatch<BnBwd>(dtype, vec, x, m0, g1, g2, dx, rows, c,
                                 lanes, chunks, chunk_rows,
                                 static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
