// Vector loads and stores shared by the kernels: V consecutive elements of an
// f32 or bf16 row, widened to (or narrowed from) f32 registers. V == 1 is a
// scalar access; V == 4 (f32) and V == 8 (bf16) are one 16-byte access, so the
// pointer must be 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace psp {

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    } else {
      v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    }
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are float4");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 x bf16 (16 bytes)");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 1) {
      *reinterpret_cast<float*>(p) = v[0];
    } else {
      float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
    }
  } else {
    if constexpr (V == 1) {
      *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
    } else {
      static_assert(V == 8, "bf16 vectors are 8 x bf16 (16 bytes)");
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(p) = u;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_scalar(T* p, float v) {
  const float one[1] = {v};
  store_vec<T, 1>(p, one);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace psp
