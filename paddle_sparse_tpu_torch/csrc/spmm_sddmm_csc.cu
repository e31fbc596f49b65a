// Fused backward of an SpMM out = A @ x for Hopper (sm_90a): d x and d value
// from one gather of g = d out, over the transpose of A's layout.
//
//   d_x[c, :]    = sum_{s < S} sum_{start[s, c] <= e < end[s, c]}
//                      value[e] * g[base[s] + col_t[e], :]
//   d_value[e]   = g[base[s] + col_t[e], :] . x[c, :]   for the same e
//
// with value = NULL meaning ones and base = NULL meaning 0. value and
// d value are in the transpose's own edge order in both forms: the caller
// relays them (one gather before, one after). Two forms of the same kernel:
// - the CSC form (S = 1): colptr (N+1) is the CSC pointer of A's real
//   entries and col_t = row[perm] their rows in column order, as
//   ops/spmm.py::spmm_structure builds them; value is value[perm] (CSC
//   order) and d value comes back in CSC order, which the wrapper reads
//   back into COO order through the inverse permutation;
// - the span form: the (S, N) span bounds of a packed layout's transpose
//   (ops/spmm_seg2.py: rp_t's start and end views, read at s * stride + c),
//   col_t the slice-local g rows, base = sbase_t; the packed backward relays
//   the values (relay_ft before, relay_tf after).
//
// Replaces the pair that an SpMM backward ran when it needed both grads:
// K2 for d value (sddmm_spans.cu: over the CSR at S = 1, over the forward
// layout in the span form), then the values relayed into transpose order
// (value[perm] materialised) and the multi-span SpMM over the transpose
// (spmm_spans.cu: K1 over the CSC view at S = 1, K3's counterpart in the
// span form) for d x. Each of those passes gathers one random row per edge
// (x for d value, g for d x). Here one warp owns an x row c: it holds x[c, :]
// in registers and gathers g's row once per edge for both outputs. It is K2
// redesigned for this card: the counterpart of the JAX package's fused
// chunked backward, paddle_sparse_tpu/ops/kernels/spmm_pallas.py::
// spmm_sddmm_chunked (:481), whose only pallas_call is K1's _reduce_kernel
// (:45, through _reduce_call :137), there too sharing the g[col_t] gather
// between d x and d value; and, in the span form, of seg2's backward
// (paddle_sparse_tpu/ops/spmm_seg2.py::_spmm_seg2_bwd :601), whose d x is a
// _seg_pass (:439) of K1's pallas_call over the transpose layout.
//
// What bounds it on the H100: the random row gather of g, nnz * K *
// sizeof(g) bytes (at full ogbn-products scale, K = 256 f32: 125 GB, about
// 37 ms at the published 3.35 TB/s), where the pair gathered that twice.
// Each byte once is about 9.5 GB (g, x, d x, and the index, value and
// d value arrays; the span form adds its (S, N) bounds): 2.8-2.9 ms. Four
// flops per gathered element: memory-bound.
//
// Design:
// - One warp per x row (or per piece of a long one). The warp loads x[c, :]
//   into registers in K2's lane layout: lane l holds the V-vectors
//   (t * 32 + l) * V for t < NV, so registers cover 32 * V * NV columns;
//   past that the dots read x[c, :] again, where it stays in L1.
// - The edges go 32 at a time: a CSC column's contiguous range, or the span
//   form's spans flattened 32 at a time (spans.cuh), as spmm_spans.cu walks
//   them, so a row's edges come in span order and, within a span, in
//   position order. Lane j loads the g row and the value of edge j of the
//   batch, in the CSC form from consecutive positions (one coalesced load).
//   For each edge the lanes gather the row of g once, with 16-byte
//   read-only loads where K and alignment allow, and take from it
//     acc  = fmaf(v, g_row, acc)     K1's order: d x in edge order;
//     part = fmaf(x_c, g_row, part)  K2's order, then K2's __shfl_xor_sync
//                                    butterfly: the edge's dot.
//   fmaf is symmetric in its first two operands, so both outputs equal the
//   pair's bit for bit. Lane j keeps edge j's dot, and the batch writes its
//   dots (write-through, no atomics) into a buffer the wrapper zeroes, so
//   positions no column reaches read 0.
// - No scattered access in the CSC form: it once read value[perm[e]] and
//   wrote d value[perm[e]] here, a 4-byte access to its own 32-byte sector
//   each, which cost 7.5 ms of a 54.4 ms pass at full ogbn-products scale,
//   K = 256 f32 (overlapped with the gather: 13.3 ms alone). Now lane j
//   reads value_t[e0 + j] and the batch's dots leave as one coalesced store
//   at e0 .. e0 + n - 1: 45.1 ms at 7 blocks an SM (kTight), against K1's
//   42.1 over the same rows. The wrapper relays the values (one gather,
//   4.2 ms, which its caller keeps for the other passes of a backward on
//   the same values) and reads d value back through the inverse
//   permutation (one gather, 3.9 ms): 53.3 ms routed with both, 49.0 with
//   the values kept, against the former kernel's 54.6 (PERF.md, section 6).
// - The dots are reduced per edge, as K2 does. One halving exchange per
//   batch (each lane's partials of the batch's edges merged at lane offsets
//   16, 8, 4, 2, 1: 31 shuffles a batch for 32 x 5, the same lane pairs in
//   the same order, so the same bits) measured slower: +0.5 ms with the
//   partials merged in groups of 4 as they come, +5.1 ms with the batch's
//   32 partials held in registers; a shared-memory stage of the batch's
//   (row, value) in place of the broadcast shuffles saved 0.05 ms. The
//   gather, not the shuffles, bounds the pass (PERF.md, section 5;
//   chip_probe_fused.cu keeps those variants).
// - The lanes' own loads, not a staging ring: a ring of bulk async copies
//   per warp in shared memory (cp.async.bulk, one row per copy, completing
//   on mbarriers) took 5% less at K = 256 f32 on the uniform graph but
//   3.3x longer on the power-law one (bench.py's zipf at 1/8, where 64% of
//   the edges read the hub's row: each copy of it is served by L2, where
//   these loads hit L1) and 11x longer at K = 47, its per-row issue cost no
//   longer hidden (PERF.md, section 6). It was measured and removed.
// - Rows wider than the registers' 32 * V * NV columns: the first pass over
//   the edges takes every column of the dots and the first block of d x;
//   each further block of d x walks the edges again, as K1 does.
// - Long x rows (ops/kernels/row_split.py): given the piece table of the
//   bounds, one warp per piece of at most `cap` edges of the row's flat
//   order. A piece of a split row writes its f32 d x partial to workspace
//   row `slot`, which fold_pieces_kernel (spmm_spans.cu) folds in a fixed
//   order: the table and the fold of the SpMM over the transpose, so the
//   bits match there too. A piece owns its edges' d value, so that output
//   needs no second pass.
// - The S = 1 CSC form is its own instantiation (kSpans false): no span
//   bookkeeping, a column's edges read straight from colptr.
//
// Dtypes: g and x are read in their own dtypes (no cast copy of either), g
// of x's dtype or wider, as K2 takes them: f32 or bf16 in both forms; the
// CSC form also f16 and f64, f32 g over f16 x, and f64 g over any x (the
// grads of a product in the promoted dtype). d x and the dots are summed in
// f32 registers, or in f64 when g is f64, and rounded once on the store; V is
// the narrower 16-byte width of g's and x's types. d x is written in f32
// (from an f32 g), in g's own dtype or f32 (from bf16 or f16 g), or in f64
// (from an f64 g). value and d value are in the value's own dtype, read and
// written through its dtype code (a launch argument: the per-edge access
// takes a uniform branch, and no instantiation per value dtype).
//
// Contract (the Python wrapper, ops/kernels/spmm_sddmm_cuda.py, checks
// shapes, dtypes, devices and contiguity): the bounds are non-decreasing
// (CSC) or any int32 spans (span form); every edge position e indexes col_t,
// value and d value, and every g row base[s] + col_t[e] lies in [0, M) of the
// contiguous (M, K) g; x and d x are contiguous (N, K). A piece table covers
// every row's edges once with slots in [0, W) of the contiguous (W, K)
// workspace of the sum's type. Offsets into g, x, d x and the workspace are
// 64-bit.

#include "spans.cuh"
#include "vec_load.cuh"

namespace {

using psp::acc_t;
using psp::aligned;
using psp::fma_acc;
using psp::kFullMask;
using psp::load_any;
using psp::load_span_chunk;
using psp::load_vec;
using psp::span_edge;
using psp::SpanChunk;
using psp::SpanEdge;
using psp::store_any;
using psp::store_vec;

constexpr int kWarpsPerBlock = 4;  // one x row (or piece) per warp

// The CSC form with sums of 4 bytes and at most 8 columns a lane (f32 to
// K = 256, bf16 and f16 to K = 256 at 8 a load) is compiled for 7 blocks of
// 4 warps an SM (at most 72 registers) with the edge loop unrolled 2 times,
// where ptxas alone chose 80 registers (6 blocks) and an unroll of 4: the
// pass is bound by how many row gathers are in flight, so more warps with
// fewer loads each win (PERF.md, section 5). Wider rows and f64 sums would
// spill and keep the compiler's choice, as does the span form, whose span
// bookkeeping spilled at 64 registers and ran 0.7 ms slower.
template <typename R, int V, int NV, bool kSpans>
constexpr bool kTight = !kSpans && sizeof(R) == 4 && V * NV <= 8;
constexpr int kTightBlocks = 7;

// One batch of n <= 32 edges of the warp's x row: lane j < n holds edge j's
// g row (my_src), its value (my_val) and its d value position (my_dst).
// Each g row is gathered once: into acc, columns c0 + (t * 32 + lane) * V,
// and, when `dots`, into the edge's dot with x[c, :] (xr in registers, the
// rest of the row from x_row), which lane j stores at d value[my_dst] in
// dtype code dv_code.
template <typename TG, typename TX, int V, int NV, bool kSpans, typename R>
__device__ __forceinline__ void take_batch(
    int n, int my_src, int my_dst, R my_val, const TG* __restrict__ g,
    const TX* __restrict__ x_row, const R (&xr)[NV][V], R (&acc)[NV][V],
    bool dots, int c0, int K, int lane, void* __restrict__ dv, int dv_code) {
  constexpr int kCols = 32 * V * NV;
  constexpr int kUnroll = kTight<R, V, NV, kSpans> ? 2 : 4;
  R my_out = R(0);
#pragma unroll(kUnroll)
  for (int j = 0; j < n; ++j) {
    const int r = __shfl_sync(kFullMask, my_src, j);
    const R v = __shfl_sync(kFullMask, my_val, j);
    const TG* g_row = g + static_cast<int64_t>(r) * K;
    R part = R(0);
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int k = c0 + (t * 32 + lane) * V;
      if (k < K) {
        R gv[V];
        load_vec<TG, V>(g_row + k, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[t][i] = fma_acc(v, gv[i], acc[t][i]);
          part = fma_acc(xr[t][i], gv[i], part);
        }
      }
    }
    if (dots) {
      for (int k = kCols + lane * V; k < K; k += 32 * V) {  // past regs
        R xv[V], gv[V];
        load_vec<TX, V>(x_row + k, xv);
        load_vec<TG, V>(g_row + k, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) part = fma_acc(xv[i], gv[i], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(kFullMask, part, off);
      }
      if (lane == j) my_out = part;
    }
  }
  if (dots && lane < n) store_any(dv, my_dst, dv_code, my_out);
}

// TG, TX: element types of g and x; TO: of d x; R: the sums' type
// (acc_t<TG>); V: elements per lane load; NV: vectors of x[c] each lane
// holds, so registers cover 32 * V * NV columns. kPieces false: warp w walks
// x row w (the table is not read); true: warp w walks piece w of the table
// (p_row, p_piece, p_slot, cap). kSpans false: the CSC form, start = colptr
// (end, stride, S and base unread); true: the span form. value (vcode) and
// dv (dv_code), both in the bounds' edge order, are typed by their dtype
// codes.
template <typename TG, typename TX, typename TO, int V, int NV, bool kPieces,
          bool kSpans, typename R>
__device__ __forceinline__ void fused_body(
    const int* __restrict__ start, const int* __restrict__ end,
    long long stride, int S, const int* __restrict__ col_t,
    const int* __restrict__ base, const void* __restrict__ value, int vcode,
    const TG* __restrict__ g, const TX* __restrict__ x, TO* __restrict__ dx,
    void* __restrict__ dv, int dv_code, int units, int K,
    const int* __restrict__ p_row, const int* __restrict__ p_piece,
    const int* __restrict__ p_slot, long long cap, R* __restrict__ ws) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= units) return;  // whole warp leaves together
  int c = w;
  long long f0 = 0, f1 = 0;   // a piece's flat edges [f0, f1)
  R* part_row = nullptr;      // non-NULL: a piece of a split row
  if constexpr (kPieces) {
    c = __ldg(p_row + w);
    f0 = static_cast<long long>(__ldg(p_piece + w)) * cap;
    f1 = f0 + cap;
    const int slot = __ldg(p_slot + w);
    if (slot >= 0) part_row = ws + static_cast<int64_t>(slot) * K;
  }
  constexpr int kCols = 32 * V * NV;
  const TX* x_row = x + static_cast<int64_t>(c) * K;
  TO* dx_row = dx + static_cast<int64_t>(c) * K;

  R xr[NV][V];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int k = (t * 32 + lane) * V;
    if (k < K) {
      load_vec<TX, V>(x_row + k, xr[t]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) xr[t][i] = R(0);
    }
  }

  for (int c0 = 0; c0 < K; c0 += kCols) {
    const bool dots = c0 == 0;  // the first pass takes the dots whole
    R acc[NV][V];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = R(0);
    }

    if constexpr (!kSpans) {
      // a CSC column: its edges [e0 + lo, e0 + hi)
      const long long e0 = __ldg(start + c);
      const long long len = max(0LL, __ldg(start + c + 1) - e0);
      long long lo = 0, hi = len;
      if constexpr (kPieces) {
        lo = f0;
        hi = min(len, f1);
      }
      for (long long eb = lo; eb < hi; eb += 32) {
        const int n = static_cast<int>(min(32LL, hi - eb));
        int my_src = 0, my_dst = 0;
        R my_val = R(1);
        if (lane < n) {  // consecutive positions: coalesced
          my_dst = static_cast<int>(e0 + eb + lane);
          my_src = __ldg(col_t + my_dst);
          if (value != nullptr) my_val = load_any<R>(value, my_dst, vcode);
        }
        take_batch<TG, TX, V, NV, kSpans>(n, my_src, my_dst, my_val, g,
                                          x_row, xr, acc, dots, c0, K, lane,
                                          dv, dv_code);
      }
    } else {
      long long before = 0;  // a piece: flat edges in the chunks passed
      for (int s0 = 0; s0 < S; s0 += 32) {
        if (kPieces && before >= f1) break;
        const SpanChunk chunk =
            load_span_chunk(start, end, base, stride, s0, S, c, lane);
        long long lo = 0, hi = chunk.total;
        if constexpr (kPieces) {
          lo = max(0LL, f0 - before);
          hi = min(chunk.total, f1 - before);
          before += chunk.total;
        }
        for (long long eb = lo; eb < hi; eb += 32) {
          const int n = static_cast<int>(min(32LL, hi - eb));
          const SpanEdge se = span_edge(chunk, eb + lane);
          int my_src = 0, my_dst = 0;
          R my_val = R(1);
          if (lane < n) {
            my_src = se.base + __ldg(col_t + se.e);
            my_dst = se.e;
            if (value != nullptr) my_val = load_any<R>(value, my_dst, vcode);
          }
          take_batch<TG, TX, V, NV, kSpans>(n, my_src, my_dst, my_val, g,
                                            x_row, xr, acc, dots, c0, K,
                                            lane, dv, dv_code);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int k = c0 + (t * 32 + lane) * V;
      if (k < K) {
        if (kPieces && part_row != nullptr) {
          store_vec<R, V>(part_row + k, acc[t]);
        } else {
          store_vec<TO, V>(dx_row + k, acc[t]);
        }
      }
    }
  }
}

#define PSP_FUSED_PARAMS                                                     \
  const int *__restrict__ start, const int *__restrict__ end,                \
      long long stride, int S, const int *__restrict__ col_t,                \
      const int *__restrict__ base, const void *__restrict__ value,          \
      int vcode, const TG *__restrict__ g, const TX *__restrict__ x,         \
      TO *__restrict__ dx, void *__restrict__ dv, int dv_code, int units,    \
      int K, const int *__restrict__ p_row, const int *__restrict__ p_piece, \
      const int *__restrict__ p_slot, long long cap, R *__restrict__ ws
#define PSP_FUSED_ARGS                                                  \
  start, end, stride, S, col_t, base, value, vcode, g, x, dx, dv, dv_code, \
      units, K, p_row, p_piece, p_slot, cap, ws

// The kernel as ptxas chooses its registers, and (kTight) for
// kTightBlocks blocks an SM.
template <typename TG, typename TX, typename TO, int V, int NV, bool kPieces,
          bool kSpans, typename R = acc_t<TG>>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_sddmm_kernel(PSP_FUSED_PARAMS) {
  fused_body<TG, TX, TO, V, NV, kPieces, kSpans, R>(PSP_FUSED_ARGS);
}

template <typename TG, typename TX, typename TO, int V, int NV, bool kPieces,
          bool kSpans, typename R = acc_t<TG>>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kTightBlocks)
spmm_sddmm_kernel_tight(PSP_FUSED_PARAMS) {
  fused_body<TG, TX, TO, V, NV, kPieces, kSpans, R>(PSP_FUSED_ARGS);
}
#undef PSP_FUSED_PARAMS
#undef PSP_FUSED_ARGS

// The kernel's arguments past its template parameters, passed through.
struct Args {
  const int* start;
  const int* end;
  long long stride;
  int S;
  const int* col_t;
  const int* base;
  const void* value;
  int vcode;
  void* dv;
  int dv_code;
  int units, K;
  const int* p_row;
  const int* p_piece;
  const int* p_slot;
  long long cap;
  void* ws;  // acc_t<TG>
};

template <typename TG, typename TX, typename TO, int V, int NV, bool kSpans>
void launch_nv(const Args& a, const TG* g, const TX* x, TO* dx,
               cudaStream_t stream) {
  using R = acc_t<TG>;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.units + kWarpsPerBlock - 1) / kWarpsPerBlock);
  // one of the two kernels, by kTight, with or without the piece table
  const bool pieces = a.p_row != nullptr;
  const int* p_row = pieces ? a.p_row : nullptr;
  const int* p_piece = pieces ? a.p_piece : nullptr;
  const int* p_slot = pieces ? a.p_slot : nullptr;
  const long long cap = pieces ? a.cap : 0;
  R* ws = pieces ? static_cast<R*>(a.ws) : nullptr;
#define PSP_LAUNCH(kernel, kp)                                               \
  kernel<TG, TX, TO, V, NV, kp, kSpans><<<grid, block, 0, stream>>>(         \
      a.start, a.end, a.stride, a.S, a.col_t, a.base, a.value, a.vcode, g, x, \
      dx, a.dv, a.dv_code, a.units, a.K, p_row, p_piece, p_slot, cap, ws)
  if constexpr (kTight<R, V, NV, kSpans>) {
    if (pieces) {
      PSP_LAUNCH(spmm_sddmm_kernel_tight, true);
    } else {
      PSP_LAUNCH(spmm_sddmm_kernel_tight, false);
    }
  } else {
    if (pieces) {
      PSP_LAUNCH(spmm_sddmm_kernel, true);
    } else {
      PSP_LAUNCH(spmm_sddmm_kernel, false);
    }
  }
#undef PSP_LAUNCH
}

// NV from K as K1 and K2 choose it, so the dots' lane layout is K2's.
template <typename TG, typename TX, typename TO, int V, bool kSpans>
void launch(const Args& a, const TG* g, const TX* x, TO* dx,
            cudaStream_t stream) {
  const int lanes_needed = (a.K + V - 1) / V;  // vectors across one row
  if (lanes_needed <= 32) {
    launch_nv<TG, TX, TO, V, 1, kSpans>(a, g, x, dx, stream);
  } else if (lanes_needed <= 64) {
    launch_nv<TG, TX, TO, V, 2, kSpans>(a, g, x, dx, stream);
  } else {
    launch_nv<TG, TX, TO, V, 4, kSpans>(a, g, x, dx, stream);
  }
}

// The vector width when K and the pointers allow it, else 1: K2's rule on g
// and x, the narrower 16-byte width of their types (d x and the workspace
// are the wrapper's fresh allocations, always aligned).
template <typename TG, typename TX, typename TO, bool kSpans>
void dispatch(const Args& a, const void* g, const void* x, void* dx,
              cudaStream_t stream) {
  constexpr int kVec = psp::vec16<TG> < psp::vec16<TX> ? psp::vec16<TG>
                                                       : psp::vec16<TX>;
  const TG* gp = static_cast<const TG*>(g);
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(dx);
  if (aligned(g, kVec * sizeof(TG)) && aligned(x, kVec * sizeof(TX)) &&
      psp::aligned16(dx) && psp::aligned16(a.ws) && a.K % kVec == 0) {
    launch<TG, TX, TO, kVec, kSpans>(a, gp, xp, op, stream);
  } else {
    launch<TG, TX, TO, 1, kSpans>(a, gp, xp, op, stream);
  }
}

// The dtype combinations (codes of g, x and d x) both forms take: f32 g over
// f32 or bf16 x into f32 d x; bf16 g and x into bf16 or f32 d x. The CSC
// form (kSpans false) also takes f32 g over f16 x, f16 g and x into f16 or
// f32 d x, and f64 g over any x into f64 d x. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (no launch) for any other
// combination.
template <bool kSpans>
int dispatch_types(const Args& a, const void* g, const void* x, void* dx,
                   int g_code, int x_code, int dx_code, cudaStream_t cs) {
  using psp::kBF16;
  using psp::kF16;
  using psp::kF32;
  using psp::kF64;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.vcode < kF32 || a.vcode > kF64 || a.dv_code < kF32 ||
      a.dv_code > kF64) {
    return bad;
  }
  if (g_code == kF32 && dx_code == kF32) {
    if (x_code == kF32) {
      dispatch<float, float, float, kSpans>(a, g, x, dx, cs);
    } else if (x_code == kBF16) {
      dispatch<float, __nv_bfloat16, float, kSpans>(a, g, x, dx, cs);
    } else if (x_code == kF16) {
      if constexpr (kSpans) {
        return bad;
      } else {
        dispatch<float, __half, float, kSpans>(a, g, x, dx, cs);
      }
    } else {
      return bad;
    }
  } else if (g_code == kBF16 && x_code == kBF16) {
    if (dx_code == kBF16) {
      dispatch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, kSpans>(
          a, g, x, dx, cs);
    } else if (dx_code == kF32) {
      dispatch<__nv_bfloat16, __nv_bfloat16, float, kSpans>(a, g, x, dx, cs);
    } else {
      return bad;
    }
  } else if constexpr (!kSpans) {
    if (g_code == kF16 && x_code == kF16 && dx_code == kF16) {
      dispatch<__half, __half, __half, kSpans>(a, g, x, dx, cs);
    } else if (g_code == kF16 && x_code == kF16 && dx_code == kF32) {
      dispatch<__half, __half, float, kSpans>(a, g, x, dx, cs);
    } else if (g_code == kF64 && dx_code == kF64) {
      switch (x_code) {
        case kF32: dispatch<double, float, double, kSpans>(a, g, x, dx, cs);
          break;
        case kBF16:
          dispatch<double, __nv_bfloat16, double, kSpans>(a, g, x, dx, cs);
          break;
        case kF16: dispatch<double, __half, double, kSpans>(a, g, x, dx, cs);
          break;
        case kF64: dispatch<double, double, double, kSpans>(a, g, x, dx, cs);
          break;
        default: return bad;
      }
    } else {
      return bad;
    }
  } else {
    return bad;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. value may be NULL (ones); value
// and d value are in the bounds' edge order (the CSC form: CSC order, the
// wrapper relaying them). g_code, x_code, dx_code, value_code and dv_code are psp::DType codes (0
// f32, 1 bf16, 2 f16, 3 f64) of g, x, d x, value and d value; the (g, x,
// d x) combinations are dispatch_types's, the wrapper rounding an f32 d x
// after where it needs another dtype. p_col == NULL launches one warp per x
// row; else one per piece of the P-piece table (p_col, p_piece, cap,
// p_slot), pieces of split rows writing to the (W, K) workspace ws (f64 from
// an f64 g, else f32), which psp_fold_pieces then folds into dx. Each
// launches on `stream` and returns cudaGetLastError(); 0 means the launch
// was accepted.
extern "C" int psp_spmm_sddmm_csc(const void* colptr, const void* col_t,
                                  const void* value, int value_code, const void* g,
                                  const void* x, void* dx, void* dv,
                                  long long N, long long K, int g_code,
                                  int x_code, int dx_code, int dv_code,
                                  const void* p_col, const void* p_piece,
                                  long long P, long long cap,
                                  const void* p_slot, void* ws,
                                  void* stream) {
  Args a;
  a.start = static_cast<const int*>(colptr);
  a.end = nullptr;
  a.stride = 0;
  a.S = 1;
  a.col_t = static_cast<const int*>(col_t);
  a.base = nullptr;
  a.value = value;
  a.vcode = value_code;
  a.dv = dv;
  a.dv_code = dv_code;
  a.units = static_cast<int>(p_col != nullptr ? P : N);
  a.K = static_cast<int>(K);
  a.p_row = static_cast<const int*>(p_col);
  a.p_piece = static_cast<const int*>(p_piece);
  a.p_slot = static_cast<const int*>(p_slot);
  a.cap = cap;
  a.ws = ws;
  return dispatch_types<false>(a, g, x, dx, g_code, x_code, dx_code,
                               static_cast<cudaStream_t>(stream));
}

// The span form: start and end are the (S, N) bounds read at s * stride + c;
// base (S,) may be NULL (0); value and d value in the bounds' edge order.
extern "C" int psp_spmm_sddmm_spans(const void* start, const void* end,
                                    long long stride, const void* col_t,
                                    const void* base, const void* value,
                                    int value_code, const void* g,
                                    const void* x, void* dx, void* dv,
                                    long long S, long long N, long long K,
                                    int g_code, int x_code, int dx_code,
                                    int dv_code, const void* p_col,
                                    const void* p_piece, long long P,
                                    long long cap, const void* p_slot,
                                    void* ws, void* stream) {
  Args a;
  a.start = static_cast<const int*>(start);
  a.end = static_cast<const int*>(end);
  a.stride = stride;
  a.S = static_cast<int>(S);
  a.col_t = static_cast<const int*>(col_t);
  a.base = static_cast<const int*>(base);
  a.value = value;
  a.vcode = value_code;
  a.dv = dv;
  a.dv_code = dv_code;
  a.units = static_cast<int>(p_col != nullptr ? P : N);
  a.K = static_cast<int>(K);
  a.p_row = static_cast<const int*>(p_col);
  a.p_piece = static_cast<const int*>(p_piece);
  a.p_slot = static_cast<const int*>(p_slot);
  a.cap = cap;
  a.ws = ws;
  return dispatch_types<true>(a, g, x, dx, g_code, x_code, dx_code,
                              static_cast<cudaStream_t>(stream));
}
