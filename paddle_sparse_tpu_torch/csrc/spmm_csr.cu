// CSR sparse @ dense product (sum) for Hopper (sm_90a).
//
//   out[m, :] = sum_{rowptr[m] <= e < rowptr[m+1]} value[e] * x[col[e], :]
//
// Replaces the TPU kernel paddle_sparse_tpu/ops/kernels/spmm_pallas.py::
// _reduce_kernel (launched by _reduce_call). On the TPU, XLA first writes the
// scaled product stream P = value[:, None] * x[col] of shape (nnz, K) to device
// memory, and the Pallas kernel row-sums P with a 0/1 selection matrix on the
// MXU. Here the gather, the scale and the row-sum are one kernel, so P never
// exists in device memory.
//
// What bounds it on the H100: the random row gather of x, about
// nnz * K * sizeof(x) bytes, plus 8 bytes of col/value per edge and one write
// of the (M, K) output. It does two flops per gathered element, so it is
// memory-bound by a wide margin. The design reads each gathered x row once per
// edge that uses it, keeps the row's sum in f32 registers, and writes each
// output row once.
//
// Design (simple and correct first; wgmma, TMA and long-row splitting are later
// work): one warp per output row; the lanes span K with 16-byte vector loads
// when K and the x pointer allow it (K % 4 == 0 for f32, K % 8 == 0 for bf16)
// and scalar loads otherwise. The warp loads 32 (col, value) pairs at a time and
// broadcasts them with shuffles. A row's edges are summed by one warp in edge
// order, without atomics, so the result is the same from run to run. A row with
// many edges is walked by its one warp: correct, but slow.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// rowptr is a canonical CSR pointer (rowptr[0] == 0) of M+1 int32 entries,
// every col[e] for e < rowptr[M] lies in [0, N), and x is a contiguous (N, K)
// array. Offsets into x and out are computed in 64 bits.

#include "vec_load.cuh"

namespace {

using psp::aligned16;
using psp::load_vec;

constexpr int kWarpsPerBlock = 4;  // one output row per warp

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

// TX: element type of x; TO: element type of out; V: elements per lane load;
// NV: vectors per lane held in registers, so one pass over a row's edges
// covers 32 * V * NV columns.
template <typename TX, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                const float* __restrict__ value, const TX* __restrict__ x,
                TO* __restrict__ out, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warp leaves together
  const int e_begin = rowptr[row];
  const int e_end = rowptr[row + 1];
  TO* out_row = out + static_cast<int64_t>(row) * K;
  constexpr int kCols = 32 * V * NV;

  for (int c0 = 0; c0 < K; c0 += kCols) {
    float acc[NV][V];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.f;
    }

    for (int eb = e_begin; eb < e_end; eb += 32) {
      const int n = min(32, e_end - eb);  // the same for every lane
      int my_col = 0;
      float my_val = 1.f;
      if (lane < n) {
        my_col = __ldg(col + eb + lane);
        if (value != nullptr) my_val = __ldg(value + eb + lane);
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int c = __shfl_sync(0xffffffffu, my_col, j);
        const float v = __shfl_sync(0xffffffffu, my_val, j);
        const TX* x_row = x + static_cast<int64_t>(c) * K;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int k = c0 + (t * 32 + lane) * V;
          if (k < K) {
            float xv[V];
            load_vec<TX, V>(x_row + k, xv);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[t][i] = fmaf(v, xv[i], acc[t][i]);
          }
        }
      }
    }

#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int k = c0 + (t * 32 + lane) * V;
      if (k < K) store_vec<TO, V>(out_row + k, acc[t]);
    }
  }
}

template <typename TX, typename TO, int V>
void launch(const int* rowptr, const int* col, const float* value,
            const TX* x, TO* out, int M, int K, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int lanes_needed = (K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    spmm_csr_kernel<TX, TO, V, 1><<<grid, block, 0, stream>>>(
        rowptr, col, value, x, out, M, K);
  } else if (lanes_needed <= 64) {
    spmm_csr_kernel<TX, TO, V, 2><<<grid, block, 0, stream>>>(
        rowptr, col, value, x, out, M, K);
  } else {
    spmm_csr_kernel<TX, TO, V, 4><<<grid, block, 0, stream>>>(
        rowptr, col, value, x, out, M, K);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. value may be NULL (implicit ones).
// x_bf16 / out_bf16 select bf16 (1) or f32 (0) for x and out. Launches on
// `stream` and returns cudaGetLastError(); 0 means the launch was accepted.
extern "C" int psp_spmm_csr(const void* rowptr, const void* col,
                            const void* value, const void* x, void* out,
                            long long M, long long K, int x_bf16, int out_bf16,
                            void* stream) {
  const int m = static_cast<int>(M);
  const int k = static_cast<int>(K);
  const int* rp = static_cast<const int*>(rowptr);
  const int* cl = static_cast<const int*>(col);
  const float* vl = static_cast<const float*>(value);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(x) && aligned16(out);

  if (!x_bf16) {
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    if (aligned && k % 4 == 0) {
      launch<float, float, 4>(rp, cl, vl, xp, op, m, k, st);
    } else {
      launch<float, float, 1>(rp, cl, vl, xp, op, m, k, st);
    }
  } else {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const bool vec = aligned && k % 8 == 0;
    if (out_bf16) {
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
      if (vec) {
        launch<__nv_bfloat16, __nv_bfloat16, 8>(rp, cl, vl, xp, op, m, k, st);
      } else {
        launch<__nv_bfloat16, __nv_bfloat16, 1>(rp, cl, vl, xp, op, m, k, st);
      }
    } else {
      float* op = static_cast<float*>(out);
      if (vec) {
        launch<__nv_bfloat16, float, 8>(rp, cl, vl, xp, op, m, k, st);
      } else {
        launch<__nv_bfloat16, float, 1>(rp, cl, vl, xp, op, m, k, st);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
