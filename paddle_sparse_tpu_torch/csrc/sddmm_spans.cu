// Multi-span sampled dense-dense product (SDDMM) for Hopper (sm_90a).
//
//   dv[e] = sum_k g[m, k] * x[base[s] + col[e], k]
//       for every edge position e with start[s, m] <= e < end[s, m], s < S
//
// with base = NULL meaning 0. start and end are int32 arrays read at
// s * stride + m, as in spmm_spans.cu. This is the value gradient of an SpMM
// out = A @ x: with g = d out, d value[e] = g[row of e] . x[col of e]. With
// S = 1 and start = rowptr, end = rowptr + 1 it is the CSR SDDMM
// (ops/kernels/sddmm_cuda.py::sddmm_csr_cuda); with the forward layout's row
// pointers of a packed-layout SpMM (ops/spmm_seg2.py, ops/spmm_seg3.py) it
// writes d value directly in the packed order.
//
// Replaces the TPU kernel paddle_sparse_tpu/ops/kernels/spmm_pallas.py::
// _mulreduce_kernel (K2, :877, launched by mul_rowsum_call :883), whose one
// call site in the JAX package is ops/spmm_seg2.py::_sddmm_pass (:559): there
// XLA first gathers the (window, K) streams x[sbase + col] and g[row] of each
// sub-window into device memory and the kernel takes their row-wise dots.
// Here both gathers are fused in, so neither stream exists. With rowptr =
// arange(L + 1) and col = arange(L) the kernel is exactly mul_rowsum_call.
//
// What bounds it on the H100: the random row gather of x, nnz * K *
// sizeof(x) bytes (at full scale, K = 256: 125 GB in f32, about 37 ms at the
// published 3.35 TB/s). g is read once per row, plus the span bounds, 4 bytes
// of col and one output value per edge. Two flops per gathered element:
// memory-bound by a wide margin.
//
// Design (simple and correct first): one warp per row m. The warp loads
// g[m, :] once into registers (the first 32 * V * NV columns; wider rows read
// the rest from g, where it stays in L1), then flattens the row's spans 32 at
// a time (spans.cuh) and walks the flat edges 32 at a time. For each edge the
// lanes gather x[base + col[e], :] with 16-byte loads when K and alignment
// allow it, each lane sums its share of the dot in f32, and a
// __shfl_xor_sync butterfly reduces across lanes. Lane j keeps the dot of the
// j-th edge of each batch and stores it at that edge's position. No atomics:
// the result is the same from run to run.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// every position e in a span indexes col and dv, every base[s] + col[e] lies
// in [0, N), g is a contiguous (M, K) and x a contiguous (N, K) array of the
// same dtype. Positions outside every span are not written: the wrapper
// zeroes them. Offsets into g and x are computed in 64 bits.

#include "spans.cuh"
#include "vec_load.cuh"

namespace {

using psp::aligned16;
using psp::kFullMask;
using psp::load_span_chunk;
using psp::load_vec;
using psp::span_edge;
using psp::SpanChunk;
using psp::SpanEdge;
using psp::store_scalar;

constexpr int kWarpsPerBlock = 4;  // one row per warp

// TX: element type of g and x; TO: element type of dv; V: elements per lane
// load; NV: vectors of the g row each lane holds in registers, so registers
// cover 32 * V * NV columns.
template <typename TX, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_spans_kernel(const int* __restrict__ start, const int* __restrict__ end,
                   long long stride, const int* __restrict__ col,
                   const int* __restrict__ base, const TX* __restrict__ g,
                   const TX* __restrict__ x, TO* __restrict__ dv, int S, int M,
                   int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warp leaves together
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

  for (int s0 = 0; s0 < S; s0 += 32) {
    const SpanChunk chunk =
        load_span_chunk(start, end, base, stride, s0, S, row, lane);
    for (long long eb = 0; eb < chunk.total; eb += 32) {
      const int n = static_cast<int>(min(32LL, chunk.total - eb));
      const SpanEdge se = span_edge(chunk, eb + lane);
      const int my_col = lane < n ? se.base + __ldg(col + se.e) : 0;
      float my_out = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int c = __shfl_sync(kFullMask, my_col, j);
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
          part += __shfl_xor_sync(kFullMask, part, off);
        }
        if (lane == j) my_out = part;
      }
      if (lane < n) store_scalar<TO>(dv + se.e, my_out);
    }
  }
}

template <typename TX, typename TO, int V>
void launch(const int* start, const int* end, long long stride,
            const int* col, const int* base, const TX* g, const TX* x, TO* dv,
            int S, int M, int K, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int lanes_needed = (K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    sddmm_spans_kernel<TX, TO, V, 1><<<grid, block, 0, stream>>>(
        start, end, stride, col, base, g, x, dv, S, M, K);
  } else if (lanes_needed <= 64) {
    sddmm_spans_kernel<TX, TO, V, 2><<<grid, block, 0, stream>>>(
        start, end, stride, col, base, g, x, dv, S, M, K);
  } else {
    sddmm_spans_kernel<TX, TO, V, 4><<<grid, block, 0, stream>>>(
        start, end, stride, col, base, g, x, dv, S, M, K);
  }
}

template <typename TX, typename TO>
void dispatch(const int* start, const int* end, long long stride,
              const int* col, const int* base, const void* g, const void* x,
              void* dv, int S, int M, int K, cudaStream_t stream) {
  constexpr int kVec = sizeof(TX) == 4 ? 4 : 8;  // elements in 16 bytes
  const TX* gp = static_cast<const TX*>(g);
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(dv);
  if (aligned16(g) && aligned16(x) && K % kVec == 0) {
    launch<TX, TO, kVec>(start, end, stride, col, base, gp, xp, op, S, M, K,
                         stream);
  } else {
    launch<TX, TO, 1>(start, end, stride, col, base, gp, xp, op, S, M, K,
                      stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. base may be NULL (0). in_bf16
// selects bf16 (1) or f32 (0) for g and x, out_bf16 the same for dv.
// Launches on `stream` and returns cudaGetLastError(); 0 means the launch was
// accepted.
extern "C" int psp_sddmm_spans(const void* start, const void* end,
                               long long stride, const void* col,
                               const void* base, const void* g, const void* x,
                               void* dv, long long S, long long M, long long K,
                               int in_bf16, int out_bf16, void* stream) {
  const int s = static_cast<int>(S);
  const int m = static_cast<int>(M);
  const int k = static_cast<int>(K);
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  const int* cl = static_cast<const int*>(col);
  const int* bs = static_cast<const int*>(base);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!in_bf16) {
    if (out_bf16) {
      dispatch<float, __nv_bfloat16>(st, en, stride, cl, bs, g, x, dv, s, m, k,
                                     cs);
    } else {
      dispatch<float, float>(st, en, stride, cl, bs, g, x, dv, s, m, k, cs);
    }
  } else if (out_bf16) {
    dispatch<__nv_bfloat16, __nv_bfloat16>(st, en, stride, cl, bs, g, x, dv, s,
                                           m, k, cs);
  } else {
    dispatch<__nv_bfloat16, float>(st, en, stride, cl, bs, g, x, dv, s, m, k,
                                   cs);
  }
  return static_cast<int>(cudaGetLastError());
}
