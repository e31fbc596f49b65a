// Run compaction of a sorted (row, col) stream for Hopper (sm_90a): the
// compress step of the SpGEMM's expand-sort-compress.
//
//   for each run of equal valid (row, col) in stream order, with slot s the
//   run's index among all runs:
//     out_row[s] = row, out_col[s] = col, out_val[s] = sum of the run's values
//   for s < out_capacity; the unique count is the number of runs.
//
// An element is valid when 0 <= row < M and 0 <= col < N. The stream is sorted
// so that equal coordinates are adjacent: either a flat stream sorted by
// (row, col) with pads last (spspmm_padded, coalesce), or an (R, F) grid whose
// grid row r holds one output row's columns sorted, pads (col == N) at the
// row's end (spspmm_rowsorted, one row block of spspmm_rowblocked). The row of
// element e is rows[e / row_div]: row_div = 1 for the flat stream, F for the
// grid.
//
// Replaces the TPU kernel paddle_sparse_tpu/ops/kernels/segcompact.py::
// _segcompact_kernel (launched by segcompact_call). That kernel walks the
// stream in sequential chunks, builds a one-hot selection matrix per chunk and
// reduces it on the MXU (O(stream * chunk) work), splits values into Dekker
// hi/lo bf16 pairs and coordinates into three 8-bit bf16 limbs (so ids must be
// below 2**24), writes 128-aligned DMA windows with a head merge, and carries
// the open run's sum in SMEM from one grid step to the next. None of that
// carries over: blocks here run in parallel and in no order, so nothing is
// carried between them. Coordinates stay int32 (no 2**24 limit) and values
// are summed in their own type (f32 or f64).
//
// What bounds it on the H100: bytes. Pass 1 reads the coordinates (8 bytes an
// element with the flat stream's row array, 4 with the grid's per-row array);
// pass 2 reads them again, reads the values, writes 12 (f32) or 16 (f64) bytes
// per run and, for the backward, 4 bytes of seg per element. At the 10M-nnz
// A @ A of chip_smoke.py (160M grid slots, ~160M runs) that is about 3.8 GB,
// 1.2 ms at 3.35 TB/s.
//
// Design (simple and correct first):
//   pass 1 (segcompact_count_kernel): each block takes a tile of kTile
//     elements, each warp 32 consecutive elements a round. A run starts at a
//     valid element whose (row, col) differs from the element before it (the
//     lane below, by shuffle; across rounds the previous round's lane 31). The
//     block writes its number of run heads.
//   an inclusive scan of the per-tile counts (torch.cumsum in the wrapper, as
//     the JAX package leaves its base offsets to XLA) gives each tile's first
//     slot; its last entry is the unique count.
//   pass 2 (segcompact_write_kernel): each block recomputes its heads, keeps
//     the ballots in registers, scans the warps' counts in shared memory and
//     gives each head its slot with a popcount of the lanes below it. The lane
//     at a head walks its run in stream order, summing the values, reading past
//     the round, warp or tile if the run crosses it, and writes (row, col, sum)
//     at its slot if the slot is below out_capacity. Optionally every element
//     writes its run's slot (seg, -1 for pads and for runs past out_capacity)
//     for the value gradient, d value[e] = d out_val[seg[e]].
// No atomics: every slot is written once, by one thread, and the sums are taken
// in stream order, so the result is the same from run to run.
//
// The one known weak case is a very long run: one thread walks it alone. That
// is the hub row of a power-law A @ A (the zipf operand of chip_smoke.py phase
// 6c); a later version may split long runs across a warp.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// col has L int32 entries; rows has ceil(L / row_div) int32 entries; value is
// null or L floats (f32 or f64); ends has ceil(L / kTile) int64 entries, the
// inclusive scan of pass 1's counts; out_row, out_col and out_val have
// out_capacity entries, which the wrapper fills with the pad (M, N, 0) first;
// 0 <= M, N < 2**31 and out_capacity < 2**31. Element offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRounds = 8;                  // 32-element rounds per warp
constexpr int kWarpSpan = 32 * kRounds;     // elements per warp
constexpr int kTile = kWarps * kWarpSpan;   // elements per block: 2048

struct Stream {
  const int* col;
  const int* rows;
  int64_t row_div;
  int64_t L;
  int M;
  int N;

  __device__ __forceinline__ int row_at(int64_t e) const {
    if (row_div == 1) return __ldg(rows + e);
    // 32-bit division when it suffices: it is several times cheaper
    const int64_t q = L <= INT32_MAX
        ? static_cast<int64_t>(static_cast<uint32_t>(e) /
                               static_cast<uint32_t>(row_div))
        : e / row_div;
    return __ldg(rows + q);
  }

  __device__ __forceinline__ bool valid(int r, int c) const {
    return static_cast<unsigned>(r) < static_cast<unsigned>(M) &&
           static_cast<unsigned>(c) < static_cast<unsigned>(N);
  }

  // (row, col) of element e; the pad (M, N) outside [0, L) or where col is
  // out of range (a pad's row is not read)
  __device__ __forceinline__ void load(int64_t e, int& r, int& c) const {
    r = M;
    c = N;
    if (e >= 0 && e < L) {
      c = __ldg(col + e);
      if (static_cast<unsigned>(c) < static_cast<unsigned>(N)) r = row_at(e);
    }
  }
};

// Ballot of the run heads in one round: lane l holds (r, c) of its element;
// (pr, pc) is the element before the round's first and becomes the round's
// last. An element equal to a valid one is valid, so comparing with the
// element before is enough: a valid element after a pad differs from it.
__device__ __forceinline__ unsigned round_heads(const Stream& s, int lane,
                                                int r, int c, int& pr,
                                                int& pc) {
  int up_r = __shfl_up_sync(kFull, r, 1);
  int up_c = __shfl_up_sync(kFull, c, 1);
  if (lane == 0) {
    up_r = pr;
    up_c = pc;
  }
  pr = __shfl_sync(kFull, r, 31);
  pc = __shfl_sync(kFull, c, 31);
  return __ballot_sync(kFull, s.valid(r, c) && (r != up_r || c != up_c));
}

__global__ void __launch_bounds__(kThreads)
segcompact_count_kernel(Stream s, long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     warp * kWarpSpan;
  int pr, pc;
  s.load(w0 - 1, pr, pc);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    int r, c;
    s.load(w0 + j * 32 + lane, r, c);
    n += __popc(round_heads(s, lane, r, c, pr, pc));
  }
  __shared__ int warp_n[kWarps];
  if (lane == 0) warp_n[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_n[w];
    counts[blockIdx.x] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segcompact_write_kernel(Stream s, const T* __restrict__ value,
                        const long long* __restrict__ ends,
                        int64_t out_capacity, int* __restrict__ out_row,
                        int* __restrict__ out_col, T* __restrict__ out_val,
                        int* __restrict__ seg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     warp * kWarpSpan;
  int rr[kRounds], cc[kRounds];
  unsigned heads[kRounds];
  int pr, pc;
  s.load(w0 - 1, pr, pc);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    s.load(w0 + j * 32 + lane, rr[j], cc[j]);
    heads[j] = round_heads(s, lane, rr[j], cc[j], pr, pc);
    n += __popc(heads[j]);
  }
  __shared__ int warp_n[kWarps];
  if (lane == 0) warp_n[warp] = n;
  __syncthreads();
  // slots before this warp: the tiles before this one, then earlier warps
  int64_t base = blockIdx.x == 0 ? 0 : ends[blockIdx.x - 1];
  for (int w = 0; w < warp; ++w) base += warp_n[w];

  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int64_t e = w0 + j * 32 + lane;
    const unsigned h = heads[j];
    const bool is_head = (h >> lane) & 1u;
    // the run of element e: heads up to and including e, counted from 0
    const int64_t slot = base + __popc(h & below) - (is_head ? 0 : 1);
    base += __popc(h);
    if (e >= s.L) continue;
    const int r = rr[j], c = cc[j];
    if (seg != nullptr) {
      seg[e] = s.valid(r, c) && slot < out_capacity
                   ? static_cast<int>(slot) : -1;
    }
    if (!is_head || slot >= out_capacity) continue;
    out_row[slot] = r;
    out_col[slot] = c;
    if (value != nullptr) {
      T acc = value[e];
      for (int64_t e2 = e + 1; e2 < s.L; ++e2) {
        if (__ldg(s.col + e2) != c || s.row_at(e2) != r) break;
        acc += value[e2];
      }
      out_val[slot] = acc;
    }
  }
}

Stream make_stream(const void* col, const void* rows, long long row_div,
                   long long L, long long M, long long N) {
  return Stream{static_cast<const int*>(col), static_cast<const int*>(rows),
                static_cast<int64_t>(row_div), static_cast<int64_t>(L),
                static_cast<int>(M), static_cast<int>(N)};
}

unsigned num_tiles(long long L) {
  return static_cast<unsigned>((L + kTile - 1) / kTile);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError(); 0 means the launch was accepted.

// Elements a block of either pass takes: the wrapper sizes `counts` with it.
extern "C" long long psp_segcompact_tile() { return kTile; }

// Pass 1: counts[t] = run heads in tile t, for ceil(L / kTile) tiles. L > 0.
extern "C" int psp_segcompact_count(const void* col, const void* rows,
                                    long long row_div, long long L,
                                    long long M, long long N, void* counts,
                                    void* stream) {
  segcompact_count_kernel<<<num_tiles(L), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      make_stream(col, rows, row_div, L, M, N),
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: writes the runs, given `ends`, the inclusive scan of pass 1's
// counts. `value` and `out_val` are null for a structure-only stream, f64
// when value_f64 is 1 and f32 when it is 0; `seg` is null or L int32s.
extern "C" int psp_segcompact_write(const void* col, const void* rows,
                                    long long row_div, long long L,
                                    long long M, long long N,
                                    const void* value, int value_f64,
                                    const void* ends, long long out_capacity,
                                    void* out_row, void* out_col,
                                    void* out_val, void* seg, void* stream) {
  const Stream s = make_stream(col, rows, row_div, L, M, N);
  const auto* e = static_cast<const long long*>(ends);
  auto* orow = static_cast<int*>(out_row);
  auto* ocol = static_cast<int*>(out_col);
  auto* sg = static_cast<int*>(seg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_f64) {
    segcompact_write_kernel<double><<<num_tiles(L), kThreads, 0, st>>>(
        s, static_cast<const double*>(value), e, out_capacity, orow, ocol,
        static_cast<double*>(out_val), sg);
  } else {
    segcompact_write_kernel<float><<<num_tiles(L), kThreads, 0, st>>>(
        s, static_cast<const float*>(value), e, out_capacity, orow, ocol,
        static_cast<float*>(out_val), sg);
  }
  return static_cast<int>(cudaGetLastError());
}
