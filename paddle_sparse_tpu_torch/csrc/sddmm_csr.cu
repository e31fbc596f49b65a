// CSR sampled dense-dense product (SDDMM) for Hopper (sm_90a).
//
//   dv[e] = sum_k g[m, k] * x[col[e], k]   for rowptr[m] <= e < rowptr[m+1]
//
// This is the value gradient of the CSR SpMM out = A @ x: with g = d out,
// d value[e] = g[row[e]] . x[col[e]].
//
// Replaces the TPU kernel paddle_sparse_tpu/ops/kernels/spmm_pallas.py::
// _mulreduce_kernel (launched by mul_rowsum_call): the per-row dot of two
// (L, K) streams that XLA first gathers into device memory, a = g[row] and
// b = x[col]. Here both gathers are fused into the kernel, so neither stream
// exists in device memory. With rowptr = arange(L + 1) and col = arange(L) the
// kernel is exactly mul_rowsum_call(g, x).
//
// What bounds it on the H100: the random row gather of x, nnz * K * sizeof(x)
// bytes. On the ogbn-products graph (122,451,450 edges) that is 125.39 GB at
// K=256 and 48.98 GB at K=100 in f32, so about 38 ms and 15 ms at the
// published 3.35 TB/s. The g rows are read once each (rows are walked in
// order), plus 4 bytes of col and one output value per edge. Two flops per
// gathered element: memory-bound by a wide margin. Measured on an H100 80GB
// HBM3 (700 W) at that size: 43.5 ms at K=256 (88% of the bound) and 21.8 ms
// at K=100 (70%).
//
// Design (simple and correct first): one warp per CSR row m. The warp loads
// g[m, :] once into registers (the first 32 * V * NV columns; wider rows read
// the rest from g, where it stays in L1), then walks the row's edges. For each
// edge the lanes gather x[col[e], :] with 16-byte loads when K and alignment
// allow it (K % 4 == 0 for f32, K % 8 == 0 for bf16), each lane sums its
// share of the dot in f32, and a __shfl_xor_sync butterfly reduces across
// lanes. Lane j keeps the dot of the j-th edge of each batch of 32, so the
// outputs are stored as one coalesced write per batch. No atomics: the result
// is the same from run to run.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// rowptr has M+1 int32 entries, every col[e] for rowptr[0] <= e < rowptr[M]
// lies in [0, N), g is a contiguous (M, K) and x a contiguous (N, K) array of
// the same dtype. Entries outside [rowptr[0], rowptr[M]) are not written: the
// wrapper zeroes them. Offsets into g and x are computed in 64 bits.

#include "vec_load.cuh"

namespace {

using psp::aligned16;
using psp::load_vec;

constexpr int kWarpsPerBlock = 4;  // one CSR row per warp

template <typename T>
__device__ __forceinline__ void store_scalar(T* p, float v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = v;
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
  }
}

// TX: element type of g and x; TO: element type of dv; V: elements per lane
// load; NV: vectors of the g row each lane holds in registers, so registers
// cover 32 * V * NV columns.
template <typename TX, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_csr_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                 const TX* __restrict__ g, const TX* __restrict__ x,
                 TO* __restrict__ dv, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warp leaves together
  const int e_begin = rowptr[row];
  const int e_end = rowptr[row + 1];
  if (e_begin >= e_end) return;
  constexpr int kCols = 32 * V * NV;
  const TX* g_row = g + static_cast<int64_t>(row) * K;

  float gr[NV][V];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int k = (t * 32 + lane) * V;
    if (k < K) {
      load_vec<TX, V>(g_row + k, gr[t]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gr[t][i] = 0.f;
    }
  }

  for (int eb = e_begin; eb < e_end; eb += 32) {
    const int n = min(32, e_end - eb);  // the same for every lane
    const int my_col = lane < n ? __ldg(col + eb + lane) : 0;
    float my_out = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int c = __shfl_sync(0xffffffffu, my_col, j);
      const TX* x_row = x + static_cast<int64_t>(c) * K;
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int k = (t * 32 + lane) * V;
        if (k < K) {
          float xv[V];
          load_vec<TX, V>(x_row + k, xv);
#pragma unroll
          for (int i = 0; i < V; ++i) part = fmaf(gr[t][i], xv[i], part);
        }
      }
      for (int k = kCols + lane * V; k < K; k += 32 * V) {  // past registers
        float gv[V], xv[V];
        load_vec<TX, V>(g_row + k, gv);
        load_vec<TX, V>(x_row + k, xv);
#pragma unroll
        for (int i = 0; i < V; ++i) part = fmaf(gv[i], xv[i], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == j) my_out = part;
    }
    if (lane < n) store_scalar<TO>(dv + eb + lane, my_out);
  }
}

template <typename TX, typename TO, int V>
void launch(const int* rowptr, const int* col, const TX* g, const TX* x,
            TO* dv, int M, int K, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int lanes_needed = (K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    sddmm_csr_kernel<TX, TO, V, 1><<<grid, block, 0, stream>>>(
        rowptr, col, g, x, dv, M, K);
  } else if (lanes_needed <= 64) {
    sddmm_csr_kernel<TX, TO, V, 2><<<grid, block, 0, stream>>>(
        rowptr, col, g, x, dv, M, K);
  } else {
    sddmm_csr_kernel<TX, TO, V, 4><<<grid, block, 0, stream>>>(
        rowptr, col, g, x, dv, M, K);
  }
}

template <typename TX, typename TO>
void dispatch(const int* rowptr, const int* col, const void* g, const void* x,
              void* dv, int M, int K, cudaStream_t stream) {
  constexpr int kVec = sizeof(TX) == 4 ? 4 : 8;  // elements in 16 bytes
  const TX* gp = static_cast<const TX*>(g);
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(dv);
  if (aligned16(g) && aligned16(x) && K % kVec == 0) {
    launch<TX, TO, kVec>(rowptr, col, gp, xp, op, M, K, stream);
  } else {
    launch<TX, TO, 1>(rowptr, col, gp, xp, op, M, K, stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. in_bf16 selects bf16 (1) or f32 (0)
// for g and x, out_bf16 the same for dv. Launches on `stream` and returns
// cudaGetLastError(); 0 means the launch was accepted.
extern "C" int psp_sddmm_csr(const void* rowptr, const void* col,
                             const void* g, const void* x, void* dv,
                             long long M, long long K, int in_bf16,
                             int out_bf16, void* stream) {
  const int m = static_cast<int>(M);
  const int k = static_cast<int>(K);
  const int* rp = static_cast<const int*>(rowptr);
  const int* cl = static_cast<const int*>(col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16) {
    if (out_bf16) {
      dispatch<float, __nv_bfloat16>(rp, cl, g, x, dv, m, k, st);
    } else {
      dispatch<float, float>(rp, cl, g, x, dv, m, k, st);
    }
  } else {
    if (out_bf16) {
      dispatch<__nv_bfloat16, __nv_bfloat16>(rp, cl, g, x, dv, m, k, st);
    } else {
      dispatch<__nv_bfloat16, float>(rp, cl, g, x, dv, m, k, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
