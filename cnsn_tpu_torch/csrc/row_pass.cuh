// Shared machinery of the statistics kernels (ins_stats.cu, bn_stats.cu):
// passes over the rows of a row-major (batch, rows, c) matrix, the channel c
// being the fastest axis, as in an NHWC activation (rows = H*W per sample for
// instance statistics, rows = N*H*W with batch 1 for BatchNorm).
//
// Each kernel sets its own tiles: a block of kThreads threads covers a tile
// of channels and a chunk of rows, each thread owning V consecutive channels
// (V = 8 bf16 or 4 fp32: one 16-byte load; V = 1 where c is not a multiple
// of V or x is not 16-byte aligned), so neighbouring threads read
// neighbouring bytes.  This header holds what they share: the argument
// checks, the loads of x, the stores of a result in x's type and the
// dispatch on (dtype, V).  No pass takes float atomics, so a result does not
// change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace row_pass {

constexpr int kThreads = 256;  // threads per block of a row pass

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

template <bool kStream, typename R>
__device__ __forceinline__ void store_raw(R* p, R v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// V fp32 results stored in x's type, each rounded to nearest even (as
// PyTorch's casts round): one 16-byte store or one element.  kStream stores
// evict-first (st.global.cs): the lines of a result the pass never reads
// again.
template <bool kStream, typename T, int V>
__device__ __forceinline__ void store_x(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      store_raw<kStream>(p, v[0]);
    } else {
      store_raw<kStream>(reinterpret_cast<unsigned short*>(p),
                         __bfloat16_as_ushort(__float2bfloat16(v[0])));
    }
  } else {
    uint4 q;
    if constexpr (std::is_same<T, float>::value) {
      static_assert(V == 4, "fp32 vectors are 4 wide");
      q = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      static_assert(V == 8, "bf16 vectors are 8 wide");
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      }
    }
    store_raw<kStream>(reinterpret_cast<uint4*>(p), q);
  }
}

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
