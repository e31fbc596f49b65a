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
// CSR row walked in edge order.
//
// Long rows (ops/kernels/row_split.py): on a power-law graph one row can hold
// most of the edges, and its one warp then does most of the launch's work.
// Given a piece table, the launch gives one warp to each piece instead: a
// run of at most `cap` flat edges of one row, [piece * cap, (piece+1) * cap)
// in the row's (span, position) order. The warp skips whole 32-span chunks
// before its first edge by their totals and starts mid-chunk. A row of one
// piece is written to out as before; a piece of a split row writes its f32
// partial to workspace row `slot`, and fold_pieces_kernel then sums each
// split row's partials in a fixed order: still no atomics, so still the same
// bits from run to run. Without a table (NULL) the launch is one warp per
// row, each walking its whole row, through an instantiation that has no
// piece bookkeeping at all: no workspace and no second pass.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// every position e in a span indexes idx and v, every source row
// base[s] + idx[e] (or base[s] + e) lies in [0, N) of the contiguous (N, K)
// src, and out is a contiguous (M, K) array. A piece table holds P entries
// of rows in [0, M), covering every row's flat edges once, and slots in
// [0, W) of the contiguous (W, K) f32 workspace. Offsets into src, out and
// the workspace are computed in 64 bits.

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
using psp::store_vec;

constexpr int kWarpsPerBlock = 4;  // one output row (or piece) per warp
constexpr int kFoldWarps = 8;      // warps of a fold block, one per group

// TX: element type of src; TO: element type of out; V: elements per lane
// load; NV: vectors per lane held in registers, so one pass over a row's
// edges covers 32 * V * NV columns. kPieces false: warp w walks row w (the
// table is not read, and the loop compiles as if it did not exist); true:
// warp w walks piece w of the table (p_row, p_piece, p_slot, cap).
template <typename TX, typename TO, int V, int NV, bool kPieces>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_spans_kernel(const int* __restrict__ start, const int* __restrict__ end,
                  long long stride, const int* __restrict__ idx,
                  const float* __restrict__ value,
                  const int* __restrict__ base, const TX* __restrict__ src,
                  TO* __restrict__ out, int S, int units, int K,
                  const int* __restrict__ p_row,
                  const int* __restrict__ p_piece,
                  const int* __restrict__ p_slot, long long cap,
                  float* __restrict__ ws) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= units) return;  // whole warp leaves together
  int row = w;
  long long f0 = 0, f1 = 0;  // a piece's flat edges [f0, f1)
  float* part = nullptr;     // non-NULL: a piece of a split row
  if constexpr (kPieces) {
    row = __ldg(p_row + w);
    f0 = static_cast<long long>(__ldg(p_piece + w)) * cap;
    f1 = f0 + cap;
    const int slot = __ldg(p_slot + w);
    if (slot >= 0) part = ws + static_cast<int64_t>(slot) * K;
  }
  TO* out_row = out + static_cast<int64_t>(row) * K;
  constexpr int kCols = 32 * V * NV;

  for (int c0 = 0; c0 < K; c0 += kCols) {
    float acc[NV][V];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.f;
    }

    long long before = 0;  // a piece: flat edges in the chunks passed
    for (int s0 = 0; s0 < S; s0 += 32) {
      if (kPieces && before >= f1) break;
      const SpanChunk chunk =
          load_span_chunk(start, end, base, stride, s0, S, row, lane);
      long long lo = 0, hi = chunk.total;
      if constexpr (kPieces) {
        lo = max(0LL, f0 - before);
        hi = min(chunk.total, f1 - before);
        before += chunk.total;
      }
      for (long long eb = lo; eb < hi; eb += 32) {
        const int n = static_cast<int>(min(32LL, hi - eb));
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
      if (k < K) {
        if (kPieces && part != nullptr) {
          store_vec<float, V>(part + k, acc[t]);
        } else {
          store_vec<TO, V>(out_row + k, acc[t]);
        }
      }
    }
  }
}

// The second pass over a split launch's workspace: block (r, y) writes the
// columns y * 32 + lane (+ gridDim.y * 32 ...) of out row fold_row[r], the
// sum of workspace rows fold_ptr[r] .. fold_ptr[r+1]-1. Warp g adds every
// kFoldWarps-th partial from g on, in order, and warp 0 adds the kFoldWarps
// sums in order: a fixed tree, so the bits do not depend on timing.
template <typename TO>
__global__ void __launch_bounds__(kFoldWarps * 32)
fold_pieces_kernel(const int* __restrict__ fold_row,
                   const int* __restrict__ fold_ptr,
                   const float* __restrict__ ws, TO* __restrict__ out, int K) {
  __shared__ float sums[kFoldWarps][32];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int r = blockIdx.x;
  const int p0 = __ldg(fold_ptr + r), p1 = __ldg(fold_ptr + r + 1);
  TO* out_row = out + static_cast<int64_t>(__ldg(fold_row + r)) * K;
  for (int c0 = blockIdx.y * 32; c0 < K; c0 += gridDim.y * 32) {
    const int k = c0 + lane;
    float acc = 0.f;
    if (k < K) {
#pragma unroll 4
      for (int p = p0 + g; p < p1; p += kFoldWarps) {
        acc += __ldg(ws + static_cast<int64_t>(p) * K + k);
      }
    }
    sums[g][lane] = acc;
    __syncthreads();
    if (g == 0 && k < K) {
      float total = sums[0][lane];
#pragma unroll
      for (int i = 1; i < kFoldWarps; ++i) total += sums[i][lane];
      store_scalar<TO>(out_row + k, total);
    }
    __syncthreads();
  }
}

// The kernel's arguments past its template parameters, passed through.
struct Args {
  const int* start;
  const int* end;
  long long stride;
  const int* idx;
  const float* value;
  const int* base;
  int S, units, K;
  const int* p_row;
  const int* p_piece;
  const int* p_slot;
  long long cap;
  float* ws;
};

template <typename TX, typename TO, int V, int NV>
void launch_nv(const Args& a, const TX* src, TO* out, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.units + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (a.p_row != nullptr) {
    spmm_spans_kernel<TX, TO, V, NV, true><<<grid, block, 0, stream>>>(
        a.start, a.end, a.stride, a.idx, a.value, a.base, src, out, a.S,
        a.units, a.K, a.p_row, a.p_piece, a.p_slot, a.cap, a.ws);
  } else {
    spmm_spans_kernel<TX, TO, V, NV, false><<<grid, block, 0, stream>>>(
        a.start, a.end, a.stride, a.idx, a.value, a.base, src, out, a.S,
        a.units, a.K, nullptr, nullptr, nullptr, 0, nullptr);
  }
}

template <typename TX, typename TO, int V>
void launch(const Args& a, const TX* src, TO* out, cudaStream_t stream) {
  const int lanes_needed = (a.K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    launch_nv<TX, TO, V, 1>(a, src, out, stream);
  } else if (lanes_needed <= 64) {
    launch_nv<TX, TO, V, 2>(a, src, out, stream);
  } else {
    launch_nv<TX, TO, V, 4>(a, src, out, stream);
  }
}

// The vector width when K and the pointers allow 16-byte accesses, else 1.
template <typename TX, typename TO, int VEC>
void dispatch(const Args& a, const void* src, void* out,
              cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(src);
  TO* op = static_cast<TO*>(out);
  if (aligned16(src) && aligned16(out) && aligned16(a.ws) && a.K % VEC == 0) {
    launch<TX, TO, VEC>(a, xp, op, stream);
  } else {
    launch<TX, TO, 1>(a, xp, op, stream);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. idx, value and base may be NULL
// (see above). src_bf16 / out_bf16 select bf16 (1) or f32 (0); f32 src takes
// an f32 out only. p_row == NULL launches one warp per row; else one per
// piece of the P-piece table (p_row, p_piece, p_slot, cap), pieces of split
// rows writing to the (W, K) f32 workspace ws, which psp_fold_pieces then
// folds into out. Each launches on `stream` and returns cudaGetLastError();
// 0 means the launch was accepted.
extern "C" int psp_spmm_spans(const void* start, const void* end,
                              long long stride, const void* idx,
                              const void* value, const void* base,
                              const void* src, void* out, long long S,
                              long long M, long long K, int src_bf16,
                              int out_bf16, const void* p_row,
                              const void* p_piece, long long P, long long cap,
                              const void* p_slot, void* ws, void* stream) {
  Args a;
  a.start = static_cast<const int*>(start);
  a.end = static_cast<const int*>(end);
  a.stride = stride;
  a.idx = static_cast<const int*>(idx);
  a.value = static_cast<const float*>(value);
  a.base = static_cast<const int*>(base);
  a.S = static_cast<int>(S);
  a.units = static_cast<int>(p_row != nullptr ? P : M);
  a.K = static_cast<int>(K);
  a.p_row = static_cast<const int*>(p_row);
  a.p_piece = static_cast<const int*>(p_piece);
  a.p_slot = static_cast<const int*>(p_slot);
  a.cap = cap;
  a.ws = static_cast<float*>(ws);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!src_bf16) {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    dispatch<float, float, 4>(a, src, out, cs);
  } else if (out_bf16) {
    dispatch<__nv_bfloat16, __nv_bfloat16, 8>(a, src, out, cs);
  } else {
    dispatch<__nv_bfloat16, float, 8>(a, src, out, cs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psp_fold_pieces(const void* fold_row, const void* fold_ptr,
                               const void* ws, void* out, long long R,
                               long long K, int out_bf16, void* stream) {
  const int* fr = static_cast<const int*>(fold_row);
  const int* fp = static_cast<const int*>(fold_ptr);
  const float* w = static_cast<const float*>(ws);
  const int k = static_cast<int>(K);
  const dim3 block(kFoldWarps * 32);
  const long long col_blocks = (K + 31) / 32;
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>(col_blocks < 65535 ? col_blocks
                                                           : 65535));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    fold_pieces_kernel<__nv_bfloat16><<<grid, block, 0, cs>>>(
        fr, fp, w, static_cast<__nv_bfloat16*>(out), k);
  } else {
    fold_pieces_kernel<float><<<grid, block, 0, cs>>>(
        fr, fp, w, static_cast<float*>(out), k);
  }
  return static_cast<int>(cudaGetLastError());
}
