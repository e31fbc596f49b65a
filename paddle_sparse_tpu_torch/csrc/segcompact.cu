// Run compaction for Hopper (sm_90a): the compress step of the SpGEMM's
// expand-sort-compress, and of PaddedCOO.coalesce.
//
//   for each run of equal valid (row, col), with slot s the run's index among
//   all runs in (row, col) order:
//     out_row[s] = row, out_col[s] = col, out_val[s] = sum of the run's values
//   for s < out_capacity; slots past the unique count hold the pad (M, N, 0);
//   the unique count is written to *count; optionally seg[e] = the slot of
//   element e's run (-1 for pads and for slots past out_capacity), for the
//   value gradient d value[e] = d out_val[seg[e]].
//
// An element is valid when 0 <= row < M and 0 <= col < N. Two layouts:
//   * an (R, F) grid whose grid row r holds output row rows[r] (spspmm_rowsorted,
//     one row block of spspmm_rowblocked). Runs never cross grid rows. With
//     sort = 1 the grid rows come in any order and the kernel orders each one
//     itself; with sort = 0 each grid row is sorted by col, pads last.
//   * a flat stream sorted by (row, col), pads last (spspmm_padded, coalesce),
//     rows[e] the row of element e. A presorted grid wider than kFMax is also
//     taken as a stream, rows[e / F] the row of element e.
//
// Replaces the TPU kernel paddle_sparse_tpu/ops/kernels/segcompact.py::
// _segcompact_kernel (launched by segcompact_call). That kernel walks a sorted
// stream in sequential chunks, reduces each through a one-hot matrix on the
// MXU, splits values into hi/lo bf16 pairs and coordinates into 8-bit limbs,
// and carries the open run's sum from one grid step to the next. None of that
// carries over: blocks here run in parallel and in no order, coordinates stay
// int32 and values are summed in f32 (f16 and bf16, rounded once per run)
// or in their own type (f32, f64, int32, int64: the ints exact, wrapping as
// torch's do).
//
// What bounds it on the H100: bytes. The inputs are read once and the outputs
// written once: at the 10M-nnz A @ A of chip_smoke.py (a (625,000, 256) grid,
// 160M slots, ~160M runs, 176M output slots) that is 3.4 GB, 1.013 ms at
// 3.35 TB/s. Sorting the grid rows in the kernel adds no bytes: it replaces a
// torch.sort and a gather of the whole grid, which wrote and read it again.
//
// The first version (two passes) lost time in four places: a count pass, a
// torch cumsum and a write pass (the coordinates read twice); the lane at a
// run head walked its run with scalar loads (a second read of the next
// element for every head, one thread for a long run); 32-bit loads and a
// division per element for the grid's row; and a sorted-input contract that
// cost the caller a 160M-element sort and gather (~15 ms, five times K5).
// This version:
//   * row kernel (grids with F <= kFMax = 1024): a warp per grid row (or
//     32 / F rows for F <= 16), 8 warps a block. EPL = P / 32 elements a lane
//     in registers, P = F rounded up to a power of two, loaded with 16-byte
//     loads; the values staged in shared memory in input order. A bitonic
//     network sorts the keys (col, position in the row), pads (col N) last,
//     in 32 bits where (N + 1) * P fits: the keys are unique, so the order is
//     the stable one. Runs are summed in position order, each lane over its
//     own elements and the open run's sum handed from lane to lane (a chain
//     only as long as a run that spans whole lanes), so the sums are bit for
//     bit those of a stable sort and a sequential walk. Both modes of the
//     grid run this kernel, so a sorted and an unsorted grid give equal bits.
//     kFMax is what registers hold: 32 keys a lane (a warp's 1,024 slots).
//   * stream kernel: tiles of 2048 elements, 8 a thread, 16-byte loads; each
//     thread sums its elements in order, then a segmented scan across lanes
//     and warps (a fixed tree) gives the sum of a run that crosses threads. A
//     run that crosses tiles is folded in tile order by the finish kernel from
//     one partial a tile. A run of any length costs its bytes; for one longer
//     than 8 elements the order differs from the stream's, and f32 sums stay
//     within 1e-6 of the run's sum of |terms| (chip_smoke.py phase 6a).
//   * slots: a block's run heads are counted and the blocks scanned in the
//     same pass by a decoupled look-back over tiles taken in ticket order
//     (ws[0] the ticket, ws[1 + t] tile t's count, then its inclusive
//     prefix; warp 0 reads 32 predecessors a step). Nothing sorted is written
//     back, and nothing is read twice.
//   * stores: each block stages its runs' (row, col, sum) in shared memory
//     and writes its slots with lane-consecutive stores (a lane writing
//     its own runs' slots strides 32 bytes: 8 times the write
//     transactions); the finish kernel writes the pads past the unique
//     count and folds the runs that cross stream tiles: every output slot
//     is written once.
//   * trailing dims (coalesce's (capacity, D) values; flat streams only):
//     the stream kernel runs on the structure alone and writes seg, then
//     segcompact_vec_kernel gives each run's first element's thread, one a
//     column, the walk over the run: each run's D-vector summed lane by lane
//     in position order, rounded once. At D = 1 the scalar path above runs.
// No atomics on values: every slot's sum is taken in a fixed order, so two
// launches give equal bits.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// int32 col and rows; value null, or of col's shape (or, on a flat stream,
// (L, D)) in f32, bf16, f16, f64, int32 or int64; out_row, out_col
// out_capacity entries, out_val out_capacity (x D); 0 <= M, N < 2**31,
// out_capacity < 2**31; element offsets 64-bit. ws has 1 + tiles int64s,
// zeroed; meta (tiles int64s) and part (2 * tiles of the sum's type) with
// values at D = 1 on the stream kernel; seg given whenever D > 1.

#include "segcompact.cuh"


// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError(); 0 means the launches were accepted, and an
// unknown value code is refused (cudaErrorInvalidValue) before a launch.

using psp_segcompact::RowsCall;
using psp_segcompact::StreamCall;
using psp_segcompact::VecCall;

extern "C" long long psp_segcompact_f_max() { return kFMax; }

// Tiles of either kernel: the wrapper sizes ws (1 + tiles), meta and part.
extern "C" long long psp_segcompact_tiles(long long R, long long F,
                                          long long L, int rows_kernel) {
  if (!rows_kernel) return (L + kTile - 1) / kTile;
  int Fp, G, epl;
  row_geometry(F, Fp, G, epl);
  const long long per = static_cast<long long>(kRowWarps) * G;
  return (R + per - 1) / per;
}

// A grid of R rows of F <= kFMax slots; sort = 1 orders each row first.
// `value` and `out_val` are null (structure only) or of value_code's type
// (psp_segcompact::ValueCode: 0 f32, 1 bf16, 2 f16, 3 f64, 4 int32,
// 5 int64); `seg` is null or R * F int32s; `count` one int64; `ws` the
// zeroed 1 + tiles int64s.
extern "C" int psp_segcompact_rows(const void* col, const void* rows,
                                   long long R, long long F, long long M,
                                   long long N, const void* value,
                                   int value_code, int sort,
                                   long long out_capacity, void* out_row,
                                   void* out_col, void* out_val, void* seg,
                                   void* count, void* ws, void* stream) {
  if (F < 1 || F > kFMax || R < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowsCall c{col, rows, R, F, M, N, value, sort, out_capacity, out_row,
             out_col, out_val, seg, count, ws,
             psp_segcompact_tiles(R, F, 0, 1)};
  cudaError_t e;
  if (value == nullptr || value_code == psp_segcompact::kF32) {
    e = run_rows<float>(c, st);
  } else if (value_code == psp_segcompact::kF64) {
    e = run_rows<double>(c, st);
  } else {
    e = psp_segcompact::rows_values(value_code, c, st);
  }
  return static_cast<int>(e);
}

// A sorted stream of L elements, the row of element e rows[e / row_div]
// (row_div 1: flat), its values (L, D) of value_code's type or null. At
// D = 1 with values, `meta` holds tiles int64s and `part` 2 * tiles of the
// sum's type (f32 for f16 and bf16); without values they are null. At D > 1
// (row_div 1 only) `seg` must be given (L int32s): the structure pass writes
// it and the trailing-dim pass reads it; meta and part are unread.
extern "C" int psp_segcompact_stream(const void* col, const void* rows,
                                     long long row_div, long long L,
                                     long long M, long long N,
                                     const void* value, int value_code,
                                     long long D, long long out_capacity,
                                     void* out_row, void* out_col,
                                     void* out_val, void* seg, void* count,
                                     void* ws, void* meta, void* part,
                                     void* stream) {
  if (L < 1 || row_div < 1 || D < 1 ||
      (D > 1 && (row_div != 1 || seg == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = value != nullptr && D > 1;
  StreamCall c{col, rows, row_div, L, M, N, vec ? nullptr : value,
               out_capacity, out_row, out_col, vec ? nullptr : out_val, seg,
               count, ws, vec ? nullptr : meta, vec ? nullptr : part,
               psp_segcompact_tiles(0, 0, L, 0)};
  cudaError_t e;
  if (c.value == nullptr || value_code == psp_segcompact::kF32) {
    e = run_stream<float>(c, st);
  } else if (value_code == psp_segcompact::kF64) {
    e = run_stream<double>(c, st);
  } else {
    e = psp_segcompact::stream_values(value_code, c, st);
  }
  if (e != cudaSuccess || !vec) return static_cast<int>(e);
  const VecCall v{value, static_cast<const int*>(seg), L, D, out_val,
                  out_capacity, static_cast<const long long*>(count)};
  return static_cast<int>(psp_segcompact::vec_values(value_code, v, st));
}
