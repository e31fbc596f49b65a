// The fused CSC backward (K2') as paddle_sparse_tpu_torch/csrc/
// spmm_sddmm_csc.cu ran it before its redesign, in variants, for `python3
// chip_probe.py fused`, which builds and runs this file to split the
// kernel's time into parts; and its span form (K2'', seg2's backward) with
// the same dot reductions. It is no part of the package.
//
// Former kernel, f32 g, x, d x and value, CSC form, no piece table: one warp
// a column c of the CSC view (colptr, col_t, perm), x[c, :] in registers,
// its edges 32 at a time; lane j loads edge j's g row index, perm[e] and
// value[perm[e]]; for each edge the warp broadcasts (row, value) by two
// shuffles, every lane gathers its columns of the g row into d x and its
// share of the dot, a 5-step __shfl_xor_sync butterfly sums the dot and
// lane j stores edge j's dot at d value[perm[e]]. MODE is a set of bits:
//   1 value at e:   value read at the CSC position (the caller passes the
//                   values in CSC order, value[perm]);
//   16 d value at e: d value written at the CSC position (the caller reads
//                   it back through the inverse permutation); 1 and 16
//                   together: no scattered access;
//   2 nodots:  no dot, no butterfly, no d value (d x alone);
//   4 batch:   the per-edge butterfly replaced by one halving exchange per
//              batch of 32 edges, incremental: edges in groups of 4,
//              partials merged at lane offsets 16 and 8 within a group and
//              4, 2, 1 across groups as they complete (31 shuffles a full
//              batch, 5 partials live; lane L ends with edge
//              bitreverse5(L));
//   32 batch32: the same exchange on a full batch held whole: part[j] for
//              the 32 edges in registers (unrolled), then 16 shuffles at
//              offset 16, 8 at 8, ... 1 at 1, lane j ending with edge j;
//              a partial batch keeps the per-edge butterfly;
//   8 smem:    the broadcast shuffles replaced by a shared-memory stage of
//              the batch's (row, value), read back by each edge as a
//              broadcast;
//   64 occupancy: __launch_bounds__ asking for 8 blocks of 4 warps an SM
//              (at most 64 registers a thread);
//   256 blocks7: __launch_bounds__ asking for 7 blocks (at most 72);
//   128 unroll2: the per-edge loop unrolled 2 times, not 4.
// Every other variant is compiled as the package's kernels are, with the
// block size alone, ptxas choosing its registers (which set how many
// blocks an SM holds: 80 registers, 6 blocks of 4 warps; 88, 5).
// Every variant writes d x as the former kernel does, and each one that
// takes the dots writes the same d value bits (the batch exchange pairs the
// same lanes in the same order as the butterfly).

#include <cuda_runtime.h>
#include <stdint.h>

#include "paddle_sparse_tpu_torch/csrc/spans.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block, one column each
constexpr int kV = 4;      // f32 elements a lane load

constexpr int kValueAtE = 1;
constexpr int kNoDots = 2;
constexpr int kBatch = 4;
constexpr int kSmem = 8;
constexpr int kDvAtE = 16;
constexpr int kBatch32 = 32;
constexpr int kOccupancy = 64;
constexpr int kUnroll2 = 128;
constexpr int kBlocks7 = 256;

// the per-edge loop's unroll: 2 with kUnroll2, else 4 (the package's)
template <int MODE>
constexpr int kUnroll = (MODE & kUnroll2) ? 2 : 4;

__device__ __forceinline__ float halve(float lo, float hi, int h, int lane) {
  const bool up = lane & h;
  return (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, h);
}

// One edge: g row r with value v into acc (columns c0 + (t * 32 + lane) *
// 4), and the lane's share of its dot with x[c] (registers, then x_row past
// them when `dots`).
template <int NV>
__device__ __forceinline__ float edge(int r, float v, const float* g,
                                      const float* x_row,
                                      const float (&xr)[NV][kV],
                                      float (&acc)[NV][kV], bool dots, int c0,
                                      int K, int lane) {
  constexpr int kCols = 32 * kV * NV;
  const float* g_row = g + static_cast<int64_t>(r) * K;
  float part = 0.0f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int k = c0 + (t * 32 + lane) * kV;
    if (k < K) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(g_row + k));
      const float gv[kV] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        acc[t][i] = fmaf(v, gv[i], acc[t][i]);
        part = fmaf(xr[t][i], gv[i], part);
      }
    }
  }
  if (dots) {
    for (int k = kCols + lane * kV; k < K; k += 32 * kV) {
      const float4 xq = __ldg(reinterpret_cast<const float4*>(x_row + k));
      const float4 gq = __ldg(reinterpret_cast<const float4*>(g_row + k));
      part = fmaf(xq.x, gq.x, part);
      part = fmaf(xq.y, gq.y, part);
      part = fmaf(xq.z, gq.z, part);
      part = fmaf(xq.w, gq.w, part);
    }
  }
  return part;
}

template <int MODE>
__device__ __forceinline__ void edge_src(int j, int my_src, float my_val,
                                         const int* s_src, const float* s_val,
                                         int& r, float& v) {
  if (MODE & kSmem) {
    r = s_src[j];
    v = s_val[j];
  } else {
    r = __shfl_sync(kFull, my_src, j);
    v = __shfl_sync(kFull, my_val, j);
  }
}

template <int NV, int MODE>
__device__ __forceinline__ void former_body(
    const int* __restrict__ colptr, const int* __restrict__ col_t,
    const int* __restrict__ perm, const float* __restrict__ value,
    const float* __restrict__ g, const float* __restrict__ x,
    float* __restrict__ dx, float* __restrict__ dv, int N, int K) {
  __shared__ int s_src_all[kWarps][32];
  __shared__ float s_val_all[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int wl = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + wl;
  if (c >= N) return;
  int* s_src = s_src_all[wl];
  float* s_val = s_val_all[wl];
  constexpr int kCols = 32 * kV * NV;
  const float* x_row = x + static_cast<int64_t>(c) * K;
  float* dx_row = dx + static_cast<int64_t>(c) * K;
  float xr[NV][kV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int k = (t * 32 + lane) * kV;
    const float4 q = k < K ? __ldg(reinterpret_cast<const float4*>(x_row + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    xr[t][0] = q.x; xr[t][1] = q.y; xr[t][2] = q.z; xr[t][3] = q.w;
  }
  const long long e0 = __ldg(colptr + c);
  const long long len = max(0LL, __ldg(colptr + c + 1) - e0);
  for (int c0 = 0; c0 < K; c0 += kCols) {
    const bool dots = c0 == 0 && !(MODE & kNoDots);
    float acc[NV][kV];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[t][i] = 0.0f;
    }
    for (long long eb = 0; eb < len; eb += 32) {
      const int n = static_cast<int>(min(32LL, len - eb));
      int my_src = 0, my_dst = 0;
      float my_val = 1.0f;
      if (lane < n) {
        const long long e = e0 + eb + lane;
        my_src = __ldg(col_t + e);
        const int p = ((MODE & kValueAtE) && (MODE & kDvAtE))
                          ? 0 : __ldg(perm + e);
        my_dst = (MODE & kDvAtE) ? static_cast<int>(e) : p;
        if (value != nullptr) {
          my_val = __ldg(value + ((MODE & kValueAtE) ? e : p));
        }
      }
      if (MODE & kSmem) {
        s_src[lane] = my_src;
        s_val[lane] = my_val;
        __syncwarp();
      }
      if ((MODE & kBatch32) && n == 32) {
        float part[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          int r;
          float v;
          edge_src<MODE>(j, my_src, my_val, s_src, s_val, r, v);
          part[j] = edge<NV>(r, v, g, x_row, xr, acc, dots, c0, K, lane);
        }
        if (dots) {
#pragma unroll
          for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
            for (int i = 0; i < h; ++i) part[i] = halve(part[i], part[i + h],
                                                        h, lane);
          }
          dv[my_dst] = part[0];
        }
      } else if (!(MODE & kBatch)) {
        float my_out = 0.0f;
#pragma unroll(kUnroll<MODE>)
        for (int j = 0; j < n; ++j) {
          int r;
          float v;
          edge_src<MODE>(j, my_src, my_val, s_src, s_val, r, v);
          float part =
              edge<NV>(r, v, g, x_row, xr, acc, dots, c0, K, lane);
          if (dots) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              part += __shfl_xor_sync(kFull, part, off);
            }
            if (lane == j) my_out = part;
          }
        }
        if (dots && lane < n) dv[my_dst] = my_out;
      } else {
        // groups of 4 edges, each merged at lane offsets 16 and 8, the
        // groups merged at 4, 2 and 1; fewer groups reduce the rest by xor
        const int q4 = (n + 3) >> 2;
        const int groups = q4 <= 1 ? 1 : q4 <= 2 ? 2 : q4 <= 4 ? 4 : 8;
        const int ng = dots ? groups : q4;
        float p2 = 0.0f, p3 = 0.0f, p4 = 0.0f, dot = 0.0f;
        for (int gi = 0; gi < ng; ++gi) {
          float q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            q[i] = 0.0f;
            const int j = gi * 4 + i;
            if (j < n) {
              int r;
              float v;
              edge_src<MODE>(j, my_src, my_val, s_src, s_val, r, v);
              q[i] = edge<NV>(r, v, g, x_row, xr, acc, dots, c0, K, lane);
            }
          }
          if (!dots) continue;
          float m = halve(halve(q[0], q[1], 16, lane),
                          halve(q[2], q[3], 16, lane), 8, lane);
          if (gi & 1) {
            m = halve(p2, m, 4, lane);
            if (gi & 2) {
              m = halve(p3, m, 2, lane);
              if (gi & 4) {
                m = halve(p4, m, 1, lane);
              } else {
                p4 = m;
              }
            } else {
              p3 = m;
            }
          } else {
            p2 = m;
          }
          dot = m;
        }
        if (dots) {
          for (int h = 4 / groups; h > 0; h >>= 1) {
            dot += __shfl_xor_sync(kFull, dot, h);
          }
          const int j = static_cast<int>(__brev(lane) >> 27);
          const int dst = __shfl_sync(kFull, my_dst, j);
          if ((lane & (8 / groups - 1)) == 0 && j < n) dv[dst] = dot;
        }
      }
      if (MODE & kSmem) __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int k = c0 + (t * 32 + lane) * kV;
      if (k < K) {
        *reinterpret_cast<float4*>(dx_row + k) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      }
    }
  }
}

#define PSP_FORMER_ARGS                                                   \
  const int *__restrict__ colptr, const int *__restrict__ col_t,          \
      const int *__restrict__ perm, const float *__restrict__ value,      \
      const float *__restrict__ g, const float *__restrict__ x,           \
      float *__restrict__ dx, float *__restrict__ dv, int N, int K

template <int NV, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
former_fused_kernel(PSP_FORMER_ARGS) {
  former_body<NV, MODE>(colptr, col_t, perm, value, g, x, dx, dv, N, K);
}

template <int NV, int MODE>
__global__ void __launch_bounds__(kWarps * 32, (MODE & kOccupancy) ? 8 : 7)
former_fused_kernel_occupancy(PSP_FORMER_ARGS) {
  former_body<NV, MODE>(colptr, col_t, perm, value, g, x, dx, dv, N, K);
}

template <int NV, int MODE>
void launch_nv(dim3 grid, dim3 block, cudaStream_t s, PSP_FORMER_ARGS) {
  if constexpr ((MODE & (kOccupancy | kBlocks7)) != 0) {
    former_fused_kernel_occupancy<NV, MODE><<<grid, block, 0, s>>>(
        colptr, col_t, perm, value, g, x, dx, dv, N, K);
  } else {
    former_fused_kernel<NV, MODE><<<grid, block, 0, s>>>(
        colptr, col_t, perm, value, g, x, dx, dv, N, K);
  }
}

template <int MODE>
int launch_mode(cudaStream_t s, PSP_FORMER_ARGS) {
  const dim3 grid((N + kWarps - 1) / kWarps), block(kWarps * 32);
  const int lanes = (K + kV - 1) / kV;
  if (lanes <= 32) {
    launch_nv<1, MODE>(grid, block, s, colptr, col_t, perm, value, g, x, dx,
                       dv, N, K);
  } else if (lanes <= 64) {
    launch_nv<2, MODE>(grid, block, s, colptr, col_t, perm, value, g, x, dx,
                       dv, N, K);
  } else {
    launch_nv<4, MODE>(grid, block, s, colptr, col_t, perm, value, g, x, dx,
                       dv, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
#undef PSP_FORMER_ARGS

// The span form (kSpans): one batch of n <= 32 edges, lane j < n holding
// edge j's g row, position and value; MODE's reduction bits as above.
template <int NV, int MODE>
__device__ __forceinline__ void spans_batch(
    int n, int my_src, int my_dst, float my_val,
    const float* __restrict__ g, const float* __restrict__ x_row,
    const float (&xr)[NV][kV], float (&acc)[NV][kV], bool dots, int c0,
    int K, int lane, float* __restrict__ dv) {
  if ((MODE & kBatch32) && n == 32) {
    float part[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      part[j] = edge<NV>(__shfl_sync(kFull, my_src, j),
                         __shfl_sync(kFull, my_val, j), g, x_row, xr, acc,
                         dots, c0, K, lane);
    }
    if (dots) {
#pragma unroll
      for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
        for (int i = 0; i < h; ++i) {
          part[i] = halve(part[i], part[i + h], h, lane);
        }
      }
      dv[my_dst] = part[0];
    }
  } else if (!(MODE & kBatch)) {
    float my_out = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float part = edge<NV>(__shfl_sync(kFull, my_src, j),
                            __shfl_sync(kFull, my_val, j), g, x_row, xr, acc,
                            dots, c0, K, lane);
      if (dots) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          part += __shfl_xor_sync(kFull, part, off);
        }
        if (lane == j) my_out = part;
      }
    }
    if (dots && lane < n) dv[my_dst] = my_out;
  } else {
    const int q4 = (n + 3) >> 2;
    const int groups = q4 <= 1 ? 1 : q4 <= 2 ? 2 : q4 <= 4 ? 4 : 8;
    const int ng = dots ? groups : q4;
    float p2 = 0.0f, p3 = 0.0f, p4 = 0.0f, dot = 0.0f;
    for (int gi = 0; gi < ng; ++gi) {
      float q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = 0.0f;
        const int j = gi * 4 + i;
        if (j < n) {
          q[i] = edge<NV>(__shfl_sync(kFull, my_src, j),
                          __shfl_sync(kFull, my_val, j), g, x_row, xr, acc,
                          dots, c0, K, lane);
        }
      }
      if (!dots) continue;
      float m = halve(halve(q[0], q[1], 16, lane),
                      halve(q[2], q[3], 16, lane), 8, lane);
      if (gi & 1) {
        m = halve(p2, m, 4, lane);
        if (gi & 2) {
          m = halve(p3, m, 2, lane);
          if (gi & 4) {
            m = halve(p4, m, 1, lane);
          } else {
            p4 = m;
          }
        } else {
          p3 = m;
        }
      } else {
        p2 = m;
      }
      dot = m;
    }
    if (dots) {
      for (int h = 4 / groups; h > 0; h >>= 1) {
        dot += __shfl_xor_sync(kFull, dot, h);
      }
      const int j = static_cast<int>(__brev(lane) >> 27);
      const int dst = __shfl_sync(kFull, my_dst, j);
      if ((lane & (8 / groups - 1)) == 0 && j < n) dv[dst] = dot;
    }
  }
}

template <int NV, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
former_spans_kernel(const int* __restrict__ start,
                    const int* __restrict__ end, long long stride, int S,
                    const int* __restrict__ col_t,
                    const int* __restrict__ base,
                    const float* __restrict__ value,
                    const float* __restrict__ g, const float* __restrict__ x,
                    float* __restrict__ dx, float* __restrict__ dv, int N,
                    int K) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= N) return;
  constexpr int kCols = 32 * kV * NV;
  const float* x_row = x + static_cast<int64_t>(c) * K;
  float* dx_row = dx + static_cast<int64_t>(c) * K;
  float xr[NV][kV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int k = (t * 32 + lane) * kV;
    const float4 q = k < K ? __ldg(reinterpret_cast<const float4*>(x_row + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    xr[t][0] = q.x; xr[t][1] = q.y; xr[t][2] = q.z; xr[t][3] = q.w;
  }
  for (int c0 = 0; c0 < K; c0 += kCols) {
    const bool dots = c0 == 0;
    float acc[NV][kV];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[t][i] = 0.0f;
    }
    for (int s0 = 0; s0 < S; s0 += 32) {
      const psp::SpanChunk chunk =
          psp::load_span_chunk(start, end, base, stride, s0, S, c, lane);
      for (long long eb = 0; eb < chunk.total; eb += 32) {
        const int n = static_cast<int>(min(32LL, chunk.total - eb));
        const psp::SpanEdge se = psp::span_edge(chunk, eb + lane);
        int my_src = 0, my_dst = 0;
        float my_val = 1.0f;
        if (lane < n) {
          my_src = se.base + __ldg(col_t + se.e);
          my_dst = se.e;
          if (value != nullptr) my_val = __ldg(value + se.e);
        }
        spans_batch<NV, MODE>(n, my_src, my_dst, my_val, g, x_row, xr, acc,
                              dots, c0, K, lane, dv);
      }
    }
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int k = c0 + (t * 32 + lane) * kV;
      if (k < K) {
        *reinterpret_cast<float4*>(dx_row + k) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      }
    }
  }
}

template <int MODE>
int launch_spans(cudaStream_t s, const int* start, const int* end,
                 long long stride, int S, const int* col_t, const int* base,
                 const float* value, const float* g, const float* x,
                 float* dx, float* dv, int N, int K) {
  const dim3 grid((N + kWarps - 1) / kWarps), block(kWarps * 32);
  const int lanes = (K + kV - 1) / kV;
  if (lanes <= 32) {
    former_spans_kernel<1, MODE><<<grid, block, 0, s>>>(
        start, end, stride, S, col_t, base, value, g, x, dx, dv, N, K);
  } else if (lanes <= 64) {
    former_spans_kernel<2, MODE><<<grid, block, 0, s>>>(
        start, end, stride, S, col_t, base, value, g, x, dx, dv, N, K);
  } else {
    former_spans_kernel<4, MODE><<<grid, block, 0, s>>>(
        start, end, stride, S, col_t, base, value, g, x, dx, dv, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the variant `mode` (a sum of the MODE bits above; 0 the
// former kernel whole) on `stream`: value (NULL: ones) in COO order, or in
// CSC order with bit 1, and d value written in COO order, or in CSC order
// with bit 16. K must be a multiple of 4 and every pointer 16-byte aligned.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a mode that is not built.
extern "C" int psp_fused_former(int mode, const void* colptr,
                                const void* col_t, const void* perm,
                                const void* value, const void* g,
                                const void* x, void* dx, void* dv, long long N,
                                long long K, void* stream) {
  const int* cp = static_cast<const int*>(colptr);
  const int* ct = static_cast<const int*>(col_t);
  const int* pm = static_cast<const int*>(perm);
  const float* v = static_cast<const float*>(value);
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  float* dxp = static_cast<float*>(dx);
  float* dvp = static_cast<float*>(dv);
  const int n = static_cast<int>(N), k = static_cast<int>(K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % kV != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
#define PSP_MODE(m)                                                       \
  case m:                                                                 \
    return launch_mode<m>(s, cp, ct, pm, v, gp, xp, dxp, dvp, n, k);
    PSP_MODE(0)
    PSP_MODE(1)
    PSP_MODE(2)
    PSP_MODE(3)
    PSP_MODE(4)
    PSP_MODE(8)
    PSP_MODE(16)
    PSP_MODE(17)
    PSP_MODE(21)
    PSP_MODE(25)
    PSP_MODE(32)
    PSP_MODE(49)
    PSP_MODE(64)
    PSP_MODE(81)
    PSP_MODE(85)
    PSP_MODE(145)
    PSP_MODE(273)
    PSP_MODE(401)
    PSP_MODE(209)
#undef PSP_MODE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The span form of the former kernel (f32, no piece table): mode 0 with the
// per-edge butterfly, 4 with the incremental batch exchange, 32 with the
// whole-batch one; start and end the (S, N) bounds read at s * stride + c,
// base (S,) or NULL, value (NULL: ones) and d value in the bounds' edge
// order.
extern "C" int psp_fused_former_spans(int mode, const void* start,
                                      const void* end, long long stride,
                                      long long S, const void* col_t,
                                      const void* base, const void* value,
                                      const void* g, const void* x, void* dx,
                                      void* dv, long long N, long long K,
                                      void* stream) {
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  const int* ct = static_cast<const int*>(col_t);
  const int* bs = static_cast<const int*>(base);
  const float* v = static_cast<const float*>(value);
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  float* dxp = static_cast<float*>(dx);
  float* dvp = static_cast<float*>(dv);
  const int n = static_cast<int>(N), k = static_cast<int>(K);
  const int s_n = static_cast<int>(S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % kV != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
#define PSP_MODE(m)                                                        \
  case m:                                                                  \
    return launch_spans<m>(s, st, en, stride, s_n, ct, bs, v, gp, xp, dxp, \
                           dvp, n, k);
    PSP_MODE(0)
    PSP_MODE(4)
    PSP_MODE(32)
#undef PSP_MODE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
