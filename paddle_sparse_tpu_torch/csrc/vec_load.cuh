// Vector loads and stores shared by the kernels: V consecutive elements of an
// f32, bf16, f16 or f64 row, widened to (or narrowed from) registers of type
// R: float for the 16- and 32-bit types, double for f64 (a widening load of
// bf16 or f16 into double goes through float, which holds them exactly); or
// of an int32 or int64 row, widened to long long (K1's integer sums, exact
// mod 2**64, so a store that truncates to int32 wraps as an int32 sum at
// every add would).
// The types are told apart by the type itself, never by its size (bf16 and
// f16 are both 2 bytes).
//
// A load or store of V elements is one access of V * sizeof(T) bytes when
// that is 4, 8 or 16 (at most 16: V = 4 for f32, 8 for bf16/f16, 2 for f64),
// several 16-byte accesses when it is a multiple of 16, and V scalar accesses
// otherwise; the pointer must be aligned to the access. V == 1 is a scalar
// access.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace psp {

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;
template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool is_f64 = std::is_same<T, double>::value;
template <typename T>
constexpr bool is_i32 = std::is_same<T, int>::value;
template <typename T>
constexpr bool is_i64 = std::is_same<T, long long>::value;

// The register type a kernel sums T in: double for f64, long long for int32
// and int64, else float.
template <typename T>
using acc_t = typename std::conditional<
    is_f64<T>, double,
    typename std::conditional<std::is_integral<T>::value, long long,
                              float>::type>::type;

// One element, widened to R.
template <typename R, typename T>
__device__ __forceinline__ R widen(T v) {
  if constexpr (is_bf16<T>) {
    return static_cast<R>(__bfloat162float(v));
  } else if constexpr (is_f16<T>) {
    return static_cast<R>(__half2float(v));
  } else {
    return static_cast<R>(v);
  }
}

// One element, rounded from R to T once (round to nearest even).
template <typename T, typename R>
__device__ __forceinline__ T narrow(R v) {
  if constexpr (is_bf16<T>) {
    return __float2bfloat16_rn(static_cast<float>(v));
  } else if constexpr (is_f16<T>) {
    return __float2half_rn(static_cast<float>(v));
  } else {
    return static_cast<T>(v);
  }
}

template <typename T>
__device__ __forceinline__ T load1(const T* p) {
  return __ldg(p);
}

// N elements of 2-byte T in one 4-, 8- or 16-byte read-only load, widened
// pairwise as the bf16 path always did (__bfloat1622float2).
template <typename T, int N, typename R>
__device__ __forceinline__ void load_pairs(const T* p, R* v) {
  using Pair = typename std::conditional<is_bf16<T>, __nv_bfloat162,
                                         __half2>::type;
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else {
    static_assert(N == 2, "2-byte vectors are 2, 4 or 8 elements");
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    Pair h;
    static_assert(sizeof(h) == 4, "a pair is 4 bytes");
    memcpy(&h, &w[i], 4);
    float2 f;
    if constexpr (is_bf16<T>) {
      f = __bfloat1622float2(h);
    } else {
      f = __half22float2(h);
    }
    v[2 * i] = static_cast<R>(f.x);
    v[2 * i + 1] = static_cast<R>(f.y);
  }
}

template <typename T, int V, typename R>
__device__ __forceinline__ void load_vec(const T* p, R (&v)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (V == 1) {
    v[0] = widen<R>(load1(p));
  } else if constexpr (is_f32<T> && (kBytes == 8 || kBytes % 16 == 0)) {
    if constexpr (kBytes == 8) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = f.x; v[1] = f.y;
    } else {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
        v[4 * q] = f.x; v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
      }
    }
  } else if constexpr (is_f64<T> && kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const double2 d = __ldg(reinterpret_cast<const double2*>(p) + q);
      v[2 * q] = static_cast<R>(d.x);
      v[2 * q + 1] = static_cast<R>(d.y);
    }
  } else if constexpr (is_i32<T> && kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const int4 d = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = static_cast<R>(d.x); v[4 * q + 1] = static_cast<R>(d.y);
      v[4 * q + 2] = static_cast<R>(d.z); v[4 * q + 3] = static_cast<R>(d.w);
    }
  } else if constexpr (is_i64<T> && kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const longlong2 d = __ldg(reinterpret_cast<const longlong2*>(p) + q);
      v[2 * q] = static_cast<R>(d.x);
      v[2 * q + 1] = static_cast<R>(d.y);
    }
  } else if constexpr ((is_bf16<T> || is_f16<T>) &&
                       (kBytes == 4 || kBytes == 8 || kBytes % 16 == 0)) {
    if constexpr (kBytes <= 16) {
      load_pairs<T, V>(p, v);
    } else {
#pragma unroll
      for (int q = 0; q < V / 8; ++q) load_pairs<T, 8>(p + 8 * q, v + 8 * q);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = widen<R>(load1(p + i));
  }
}

// N elements of 2-byte T from registers, rounded pairwise, in one 4-, 8- or
// 16-byte store.
template <typename T, int N, typename R>
__device__ __forceinline__ void store_pairs(T* p, const R* v) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float a = static_cast<float>(v[2 * i]);
    const float b = static_cast<float>(v[2 * i + 1]);
    if constexpr (is_bf16<T>) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      memcpy(&w[i], &h, 4);
    } else {
      const __half2 h = __floats2half2_rn(a, b);
      memcpy(&w[i], &h, 4);
    }
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    static_assert(N == 2, "2-byte vectors are 2, 4 or 8 elements");
    *reinterpret_cast<unsigned int*>(p) = w[0];
  }
}

template <typename T, int V, typename R>
__device__ __forceinline__ void store_vec(T* p, const R (&v)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (V == 1) {
    *p = narrow<T>(v[0]);
  } else if constexpr (is_f32<T> && kBytes % 16 == 0) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      q[i] = make_float4(static_cast<float>(v[4 * i]),
                         static_cast<float>(v[4 * i + 1]),
                         static_cast<float>(v[4 * i + 2]),
                         static_cast<float>(v[4 * i + 3]));
    }
  } else if constexpr (is_f64<T> && kBytes % 16 == 0) {
    double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      q[i] = make_double2(static_cast<double>(v[2 * i]),
                          static_cast<double>(v[2 * i + 1]));
    }
  } else if constexpr (is_i32<T> && kBytes % 16 == 0) {
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      q[i] = make_int4(narrow<T>(v[4 * i]), narrow<T>(v[4 * i + 1]),
                       narrow<T>(v[4 * i + 2]), narrow<T>(v[4 * i + 3]));
    }
  } else if constexpr (is_i64<T> && kBytes % 16 == 0) {
    longlong2* q = reinterpret_cast<longlong2*>(p);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      q[i] = make_longlong2(narrow<T>(v[2 * i]), narrow<T>(v[2 * i + 1]));
    }
  } else if constexpr ((is_bf16<T> || is_f16<T>) &&
                       (kBytes == 4 || kBytes == 8 || kBytes % 16 == 0)) {
    if constexpr (kBytes <= 16) {
      store_pairs<T, V>(p, v);
    } else {
#pragma unroll
      for (int q = 0; q < V / 8; ++q) store_pairs<T, 8>(p + 8 * q, v + 8 * q);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = narrow<T>(v[i]);
  }
}

template <typename T, typename R>
__device__ __forceinline__ void store_scalar(T* p, R v) {
  *p = narrow<T>(v);
}

// The dtype codes of the C entry points (ops/kernels/_build.py::DTYPE_CODE).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3, kI32 = 4,
                   kI64 = 5 };

// One element of a per-edge array (value, d value) whose dtype is a launch
// argument, not a template parameter: the code is the same for the whole
// launch, so the branch costs a uniform jump per edge, and the kernels need
// no instantiation per value dtype.
template <typename R>
__device__ __forceinline__ R load_any(const void* p, long long i, int code) {
  switch (code) {
    case kBF16:
      return widen<R>(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
    case kF16:
      return widen<R>(__ldg(static_cast<const __half*>(p) + i));
    case kF64:
      return static_cast<R>(__ldg(static_cast<const double*>(p) + i));
    default:
      return static_cast<R>(__ldg(static_cast<const float*>(p) + i));
  }
}

template <typename R>
__device__ __forceinline__ void store_any(void* p, long long i, int code,
                                          R v) {
  switch (code) {
    case kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = narrow<__nv_bfloat16>(v);
      break;
    case kF16:
      static_cast<__half*>(p)[i] = narrow<__half>(v);
      break;
    case kF64:
      static_cast<double*>(p)[i] = static_cast<double>(v);
      break;
    default:
      static_cast<float*>(p)[i] = static_cast<float>(v);
  }
}

// One element of an int32 or int64 per-edge array (K1's integer values),
// widened to R; the code is kI32 or kI64 for the whole launch.
template <typename R>
__device__ __forceinline__ R load_int(const void* p, long long i, int code) {
  if (code == kI64) {
    return static_cast<R>(__ldg(static_cast<const long long*>(p) + i));
  }
  return static_cast<R>(__ldg(static_cast<const int*>(p) + i));
}

// Fused multiply-add in R: fmaf for float, fma for double; for long long a
// multiply and an add mod 2**64 (unsigned, so an overflow wraps and is
// defined).
__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ long long fma_acc(long long a, long long b,
                                             long long c) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                    static_cast<unsigned long long>(b) +
                                static_cast<unsigned long long>(c));
}

// a + b in R; mod 2**64 for long long, as fma_acc.
template <typename R>
__device__ __forceinline__ R add_acc(R a, R b) {
  if constexpr (std::is_integral<R>::value) {
    return static_cast<R>(static_cast<unsigned long long>(a) +
                          static_cast<unsigned long long>(b));
  } else {
    return a + b;
  }
}

// Elements of T in one 16-byte access.
template <typename T>
constexpr int vec16 = 16 / static_cast<int>(sizeof(T));

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & static_cast<uintptr_t>(bytes - 1))
         == 0;
}

inline bool aligned16(const void* p) { return aligned(p, 16); }

}  // namespace psp
