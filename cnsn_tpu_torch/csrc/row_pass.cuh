// Shared machinery of the statistics kernels (ins_stats.cu, bn_stats.cu):
// passes over the rows of a row-major (batch, rows, c) matrix, the channel c
// being the fastest axis, as in an NHWC activation (rows = H*W per sample for
// instance statistics, rows = N*H*W with batch 1 for BatchNorm).
//
// Geometry.  A block of kThreads threads covers a tile of channels and a chunk
// of rows.  Each thread owns V consecutive channels (V = 8 bf16 or 4 fp32: one
// 16-byte load; V = 1 where c is not a multiple of V or x is not 16-byte
// aligned) and strides over the rows of its chunk.  `lanes` threads span one
// row segment of the tile, so neighbouring threads read neighbouring bytes
// and a warp reads 32 * 16 B contiguous where c is wide, and several whole
// rows where c is narrow (c = 64 bf16: 8 lanes, a warp reads 4 rows of 128 B).
// The grid is (channel tiles, row chunks, batch); the number of chunks is
// chosen so that the grid holds about kBlocksPerSm blocks per SM.
//
// The K1 backward runs on this geometry; the one-launch forward kernels
// of ins_stats.cu and bn_stats.cu (and K2's backward) set their own tiles
// and share the loads below.  No pass takes float atomics, so a result
// does not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace row_pass {

constexpr int kThreads = 256;     // threads per block of a row pass
constexpr int kBlocksPerSm = 8;   // grid size the chunk count aims at
constexpr int kMaxChunks = 1024;  // bounds the grid's row chunks

struct Geometry {
  int lanes;          // threads across one row segment of the tile
  int rows_per_iter;  // rows a block advances per step: kThreads / lanes
  int tile;           // channels per block: lanes * vec
  int ctiles;         // channel tiles: ceil(c / tile)
};

__host__ __device__ inline Geometry geometry(int c, int vec) {
  Geometry g;
  const int per_row = (c + vec - 1) / vec;
  g.lanes = per_row < 32 ? per_row : 32;
  g.rows_per_iter = kThreads / g.lanes;
  g.tile = g.lanes * vec;
  g.ctiles = (c + g.tile - 1) / g.tile;
  return g;
}

// Row chunks per (batch item, channel tile): enough blocks to fill the card,
// at least one block step of rows per chunk.
inline int plan_chunks(int batch, int rows, int c, int vec) {
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
  const Geometry g = geometry(c, vec);
  const long long per_block = static_cast<long long>(g.ctiles) * batch;
  long long chunks = (static_cast<long long>(kBlocksPerSm) * sms +
                      per_block - 1) / per_block;
  const long long most = (rows + g.rows_per_iter - 1) / g.rows_per_iter;
  if (chunks > most) chunks = most;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

inline int chunk_rows(int rows, int chunks) {
  return (rows + chunks - 1) / chunks;
}

// Valid arguments of a pass over x (dtype 0 = float32, 1 = bfloat16): sizes
// in range, vec 1 or one 16-byte load dividing c, and the vector pointers
// x and y (y may be null) 16-byte aligned.
inline bool valid_pass(int dtype, int batch, int rows, int c, int vec,
                       const void* x, const void* y) {
  if (dtype != 0 && dtype != 1) return false;
  if (batch < 1 || batch > 65535 || rows < 1 || c < 1) return false;
  if (vec == 1) return true;
  if (vec != (dtype == 0 ? 4 : 8) || c % vec != 0) return false;
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "fp32 vectors are 4 wide");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// Rounds to nearest even, as PyTorch's and XLA's casts do.
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      p[0] = v[0];
    } else {
      p[0] = __float2bfloat16(v[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "fp32 vectors are 4 wide");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// Where a thread sits in a block of a row pass.
struct Place {
  int c0;       // first of its V channels
  int r_begin;  // first row of its block's chunk (before its own offset)
  int r_end;    // one past the chunk's last row
  int rin;      // its row offset within a block step
  bool live;    // owns channels and a row offset
};

__device__ __forceinline__ Place place(const Geometry& g, int rows, int c,
                                       int vec, int chunk_rows) {
  Place p;
  const int t = threadIdx.x;
  const int lane = t % g.lanes;
  p.rin = t / g.lanes;
  p.c0 = blockIdx.x * g.tile + lane * vec;
  p.r_begin = blockIdx.y * chunk_rows;
  const int end = p.r_begin + chunk_rows;
  p.r_end = end < rows ? end : rows;
  p.live = p.rin < g.rows_per_iter && p.c0 < c;
  return p;
}

// One load of x, kept raw until it is used: 16 bytes (V = 8 bf16 or 4
// fp32) or one element.  A pass that reads x once loads evict-first
// (ld.global.cs): it leaves the L2's other lines in place.
template <typename T, int V>
struct XLoad {
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
  __device__ static Raw load(const T* p) {
    if constexpr (V == 1) {
      return __ldcs(p);
    } else {
      return __ldcs(reinterpret_cast<const uint4*>(p));
    }
  }
  __device__ static void unpack(const Raw& r, float (&v)[V]) {
    if constexpr (V == 1) {
      v[0] = to_f32(r);
    } else if constexpr (std::is_same<T, float>::value) {
      v[0] = __uint_as_float(r.x);
      v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z);
      v[3] = __uint_as_float(r.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
};

// Dispatch on (dtype, vec): dtype 0 = float32, 1 = bfloat16.  `Launch` is a
// class template on <T, V> with a static run(args...).  Returns false on a
// pair that has no kernel.
template <template <typename, int> class Launch, typename... Args>
inline bool dispatch(int dtype, int vec, Args... args) {
  if (dtype == 0 && vec == 1) {
    Launch<float, 1>::run(args...);
  } else if (dtype == 0 && vec == 4) {
    Launch<float, 4>::run(args...);
  } else if (dtype == 1 && vec == 1) {
    Launch<__nv_bfloat16, 1>::run(args...);
  } else if (dtype == 1 && vec == 8) {
    Launch<__nv_bfloat16, 8>::run(args...);
  } else {
    return false;
  }
  return true;
}

}  // namespace row_pass
