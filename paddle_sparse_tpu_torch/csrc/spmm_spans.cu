// Multi-span sparse @ dense row-sum (SpMM) for Hopper (sm_90a).
//
//   out[m, :] = sum_{s < S} sum_{start[s, m] <= e < end[s, m]}
//                   v[e] * src[base[s] + idx[e], :]
//
// with v = NULL meaning ones, base = NULL meaning 0, and idx = NULL meaning
// src[base[s] + e] (the stream form: src is an edge-ordered product stream).
// start and end are int32 arrays read at s * stride + m, so the (S, M+1) row
// pointers rp of a packed layout pass as start = rp, end = rp + 1 without a
// copy, and with S = 1 a CSR pointer passes as start = rowptr,
// end = rowptr + 1.
//
// Replaces three TPU kernels of paddle_sparse_tpu/ops/kernels/spmm_pallas.py,
// which compute this one function over a product stream that XLA has written
// to device memory:
// - _reduce_kernel (:45, launched by _reduce_call :137), the CSR row-sum
//   (K1): here S = 1, through ops/kernels/spmm_cuda.py::spmm_csr_cuda;
// - _tilespan_kernel (:708, launched by tilespan_call :769): per 128-row output
//   tile, all S segment spans of the tile are staged into VMEM by DMA and
//   folded with one one-hot MXU product (ops/spmm_seg3.py's reduction);
// - _band_reduce_kernel (:601, launched by band_reduce_call :649): the same sum
//   with a whole output band resident in VMEM and the band's stream walked
//   chunk by chunk.
// It also stands for the S x W windowed _reduce_call passes of
// ops/spmm_seg2.py::_seg_pass (:439-500), which accumulate into the whole
// output in place once per segment window. A CSR kernel could only do that
// with S launches that each read and write the whole (M, K) output: at full
// ogbn-products scale in f32 that is 38 segments and about 190 GB of
// accumulator traffic. Here the gather, the scale and the sum over all spans
// are one kernel, and each output row is written once.
//
// What bounds it on the H100: the random row gather of src, about
// nnz * K * sizeof(src) bytes (at full scale, K = 256: 125 GB in f32, 63 GB
// in bf16, so about 37 ms and 19 ms at the published 3.35 TB/s), plus the
// (S, M) span bounds and 8 bytes of idx/value per edge, and one write of the
// output. Two flops per gathered element: memory-bound by a wide margin.
//
// Design (simple and correct first): one warp per output row, written once,
// no atomics, so the result is the same from run to run. The warp does not
// walk span by span (a row's ~50 edges lie in 19-38 spans of 1-3 edges): it
// flattens 32 spans at a time (spans.cuh) and walks the flat edges 32 at a
// time: shuffle-broadcast source row and value, lanes across K with 16-byte
// loads when K and alignment allow, fmaf in edge order. With S = 1 that is a
// CSR row walked in edge order. A row with very many edges is walked by its
// one warp: correct, but slow.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// every position e in a span indexes idx and v, every source row
// base[s] + idx[e] (or base[s] + e) lies in [0, N) of the contiguous (N, K)
// src, and out is a contiguous (M, K) array. Offsets into src and out are
// computed in 64 bits.

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
using psp::store_vec;

constexpr int kWarpsPerBlock = 4;  // one output row per warp

// TX: element type of src; TO: element type of out; V: elements per lane
// load; NV: vectors per lane held in registers, so one pass over a row's
// edges covers 32 * V * NV columns.
template <typename TX, typename TO, int V, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_spans_kernel(const int* __restrict__ start, const int* __restrict__ end,
                  long long stride, const int* __restrict__ idx,
                  const float* __restrict__ value,
                  const int* __restrict__ base, const TX* __restrict__ src,
                  TO* __restrict__ out, int S, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warp leaves together
  TO* out_row = out + static_cast<int64_t>(row) * K;
  constexpr int kCols = 32 * V * NV;

  for (int c0 = 0; c0 < K; c0 += kCols) {
    float acc[NV][V];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.f;
    }

    for (int s0 = 0; s0 < S; s0 += 32) {
      const SpanChunk chunk =
          load_span_chunk(start, end, base, stride, s0, S, row, lane);
      for (long long eb = 0; eb < chunk.total; eb += 32) {
        const int n = static_cast<int>(min(32LL, chunk.total - eb));
        const SpanEdge se = span_edge(chunk, eb + lane);
        int my_row = 0;
        float my_val = 1.f;
        if (lane < n) {
          my_row = se.base + (idx != nullptr ? __ldg(idx + se.e) : se.e);
          if (value != nullptr) my_val = __ldg(value + se.e);
        }
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const int r = __shfl_sync(kFullMask, my_row, j);
          const float v = __shfl_sync(kFullMask, my_val, j);
          const TX* src_row = src + static_cast<int64_t>(r) * K;
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const int k = c0 + (t * 32 + lane) * V;
            if (k < K) {
              float xv[V];
              load_vec<TX, V>(src_row + k, xv);
#pragma unroll
              for (int i = 0; i < V; ++i) acc[t][i] = fmaf(v, xv[i], acc[t][i]);
            }
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
void launch(const int* start, const int* end, long long stride,
            const int* idx, const float* value, const int* base, const TX* src,
            TO* out, int S, int M, int K, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int lanes_needed = (K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    spmm_spans_kernel<TX, TO, V, 1><<<grid, block, 0, stream>>>(
        start, end, stride, idx, value, base, src, out, S, M, K);
  } else if (lanes_needed <= 64) {
    spmm_spans_kernel<TX, TO, V, 2><<<grid, block, 0, stream>>>(
        start, end, stride, idx, value, base, src, out, S, M, K);
  } else {
    spmm_spans_kernel<TX, TO, V, 4><<<grid, block, 0, stream>>>(
        start, end, stride, idx, value, base, src, out, S, M, K);
  }
}

// The vector width when K and both pointers allow 16-byte accesses, else 1.
template <typename TX, typename TO, int VEC>
void dispatch(const int* start, const int* end, long long stride,
              const int* idx, const float* value, const int* base,
              const void* src, void* out, int S, int M, int K,
              cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(src);
  TO* op = static_cast<TO*>(out);
  if (aligned16(src) && aligned16(out) && K % VEC == 0) {
    launch<TX, TO, VEC>(start, end, stride, idx, value, base, xp, op, S, M, K,
                        stream);
  } else {
    launch<TX, TO, 1>(start, end, stride, idx, value, base, xp, op, S, M, K,
                      stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. idx, value and base may be NULL
// (see above). src_bf16 / out_bf16 select bf16 (1) or f32 (0); f32 src takes
// an f32 out only. Launches on `stream` and returns cudaGetLastError(); 0
// means the launch was accepted.
extern "C" int psp_spmm_spans(const void* start, const void* end,
                              long long stride, const void* idx,
                              const void* value, const void* base,
                              const void* src, void* out, long long S,
                              long long M, long long K, int src_bf16,
                              int out_bf16, void* stream) {
  const int s = static_cast<int>(S);
  const int m = static_cast<int>(M);
  const int k = static_cast<int>(K);
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  const int* ix = static_cast<const int*>(idx);
  const float* vl = static_cast<const float*>(value);
  const int* bs = static_cast<const int*>(base);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!src_bf16) {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    dispatch<float, float, 4>(st, en, stride, ix, vl, bs, src, out, s, m, k,
                              cs);
  } else if (out_bf16) {
    dispatch<__nv_bfloat16, __nv_bfloat16, 8>(st, en, stride, ix, vl, bs, src,
                                              out, s, m, k, cs);
  } else {
    dispatch<__nv_bfloat16, float, 8>(st, en, stride, ix, vl, bs, src, out, s,
                                      m, k, cs);
  }
  return static_cast<int>(cudaGetLastError());
}
