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
// Long rows (ops/kernels/row_split.py): given a piece table, the launch
// gives one warp to each piece, a run of at most `cap` flat edges of one row
// ([piece * cap, (piece+1) * cap) in the row's (span, position) order), as
// spmm_spans.cu does. The warp loads its row of g, skips whole 32-span
// chunks before its first edge and writes the dots of its own edges. Pieces
// own disjoint edges, so there is no second pass and the bits stay the same
// from run to run. Without a table (NULL) the launch is one warp per row,
// through an instantiation that has no piece bookkeeping at all.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// every position e in a span indexes col and dv, every base[s] + col[e] lies
// in [0, N), g is a contiguous (M, K) and x a contiguous (N, K) array of the
// same dtype. A piece table holds P entries of rows in [0, M) that cover
// every row's flat edges once. Positions outside every span are not
// written: the wrapper zeroes them. Offsets into g and x are computed in 64
// bits.

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
// cover 32 * V * NV columns. kPieces false: warp w walks row w (the table
// is not read, and the loop compiles as if it did not exist); true: warp w
// walks piece w of the table (p_row, p_piece, cap).
template <typename TX, typename TO, int V, int NV, bool kPieces>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_spans_kernel(const int* __restrict__ start, const int* __restrict__ end,
                   long long stride, const int* __restrict__ col,
                   const int* __restrict__ base, const TX* __restrict__ g,
                   const TX* __restrict__ x, TO* __restrict__ dv, int S,
                   int units, int K, const int* __restrict__ p_row,
                   const int* __restrict__ p_piece, long long cap) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= units) return;  // whole warp leaves together
  int row = w;
  long long f0 = 0, f1 = 0;  // a piece's flat edges [f0, f1)
  if constexpr (kPieces) {
    row = __ldg(p_row + w);
    f0 = static_cast<long long>(__ldg(p_piece + w)) * cap;
    f1 = f0 + cap;
  }
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

// The kernel's arguments past its template parameters, passed through.
struct Args {
  const int* start;
  const int* end;
  long long stride;
  const int* col;
  const int* base;
  int S, units, K;
  const int* p_row;
  const int* p_piece;
  long long cap;
};

template <typename TX, typename TO, int V, int NV>
void launch_nv(const Args& a, const TX* g, const TX* x, TO* dv,
               cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.units + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (a.p_row != nullptr) {
    sddmm_spans_kernel<TX, TO, V, NV, true><<<grid, block, 0, stream>>>(
        a.start, a.end, a.stride, a.col, a.base, g, x, dv, a.S, a.units,
        a.K, a.p_row, a.p_piece, a.cap);
  } else {
    sddmm_spans_kernel<TX, TO, V, NV, false><<<grid, block, 0, stream>>>(
        a.start, a.end, a.stride, a.col, a.base, g, x, dv, a.S, a.units,
        a.K, nullptr, nullptr, 0);
  }
}

template <typename TX, typename TO, int V>
void launch(const Args& a, const TX* g, const TX* x, TO* dv,
            cudaStream_t stream) {
  const int lanes_needed = (a.K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    launch_nv<TX, TO, V, 1>(a, g, x, dv, stream);
  } else if (lanes_needed <= 64) {
    launch_nv<TX, TO, V, 2>(a, g, x, dv, stream);
  } else {
    launch_nv<TX, TO, V, 4>(a, g, x, dv, stream);
  }
}

template <typename TX, typename TO>
void dispatch(const Args& a, const void* g, const void* x, void* dv,
              cudaStream_t stream) {
  constexpr int kVec = sizeof(TX) == 4 ? 4 : 8;  // elements in 16 bytes
  const TX* gp = static_cast<const TX*>(g);
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(dv);
  if (aligned16(g) && aligned16(x) && a.K % kVec == 0) {
    launch<TX, TO, kVec>(a, gp, xp, op, stream);
  } else {
    launch<TX, TO, 1>(a, gp, xp, op, stream);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. base may be NULL (0). in_bf16
// selects bf16 (1) or f32 (0) for g and x, out_bf16 the same for dv.
// p_row == NULL launches one warp per row; else one per piece of the
// P-piece table (p_row, p_piece, cap). Launches on `stream` and returns
// cudaGetLastError(); 0 means the launch was accepted.
extern "C" int psp_sddmm_spans(const void* start, const void* end,
                               long long stride, const void* col,
                               const void* base, const void* g, const void* x,
                               void* dv, long long S, long long M, long long K,
                               int in_bf16, int out_bf16, const void* p_row,
                               const void* p_piece, long long P,
                               long long cap, void* stream) {
  Args a;
  a.start = static_cast<const int*>(start);
  a.end = static_cast<const int*>(end);
  a.stride = stride;
  a.col = static_cast<const int*>(col);
  a.base = static_cast<const int*>(base);
  a.S = static_cast<int>(S);
  a.units = static_cast<int>(p_row != nullptr ? P : M);
  a.K = static_cast<int>(K);
  a.p_row = static_cast<const int*>(p_row);
  a.p_piece = static_cast<const int*>(p_piece);
  a.cap = cap;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!in_bf16) {
    if (out_bf16) {
      dispatch<float, __nv_bfloat16>(a, g, x, dv, cs);
    } else {
      dispatch<float, float>(a, g, x, dv, cs);
    }
  } else if (out_bf16) {
    dispatch<__nv_bfloat16, __nv_bfloat16>(a, g, x, dv, cs);
  } else {
    dispatch<__nv_bfloat16, float>(a, g, x, dv, cs);
  }
  return static_cast<int>(cudaGetLastError());
}
