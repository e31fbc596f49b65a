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
// int32 and values are summed in their own type (f32 or f64).
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
// No atomics on values: every slot's sum is taken in a fixed order, so two
// launches give equal bits.
//
// Contract (the Python wrapper checks shapes, dtypes, devices and contiguity):
// int32 col and rows; value null or f32/f64 of col's shape; out_row, out_col,
// out_val out_capacity entries; 0 <= M, N < 2**31, out_capacity < 2**31;
// element offsets 64-bit. ws has 1 + tiles int64s, zeroed; meta and part
// (stream kernel with values) tiles entries each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFMax = 1024;                   // longest grid row sorted here
constexpr int kRowWarps = 8;                  // warps a block, row kernel
constexpr int kRowBlocks = 5;                 // blocks an SM, row kernel,
                                              // for rows of up to 256
constexpr int kThreads = 256;                 // stream kernel
constexpr int kEpt = 8;                       // stream elements a thread
constexpr int kTile = kThreads * kEpt;        // stream elements a block
constexpr int kFinishBlocks = 1056;           // 8 a streaming multiprocessor

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;

template <typename T>
struct Args {
  const int* col;
  const int* rows;
  const T* value;        // null: structure only
  int64_t L;             // elements
  int64_t R;             // grid rows (row kernel)
  int64_t row_div;       // stream: 1 (flat) or F (grid)
  int F, Fp, G;          // row kernel: row width, its power of two, rows/warp
  int M, N;
  int sort;              // row kernel: order each grid row first
  int vec;               // every pointer 16-byte aligned
  int64_t cap;
  int* out_row;
  int* out_col;
  T* out_val;
  int* seg;              // null or L entries
  long long* count;
  unsigned long long* ws;
  long long ntiles;
  long long* meta;       // stream with values: per tile, see finish kernel
  T* part;
};

// ---- decoupled look-back ---------------------------------------------------

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Warp 0 of tile t: publish the tile's head count, add up the tiles before it
// (aggregates back to the first inclusive prefix, 32 tiles a step), publish
// the inclusive prefix; returns the exclusive one to every lane. Tiles are
// taken in ticket order, so each predecessor is running or done and
// publishes without waiting.
__device__ long long tile_exclusive(unsigned long long* ws, long long t,
                                    long long agg, int lane) {
  volatile unsigned long long* st = ws + 1;
  if (lane == 0) {
    st[t] = (t == 0 ? kInclusive : kAggregate) |
            static_cast<unsigned long long>(agg);
  }
  long long excl = 0;
  for (long long u = t - 1 - lane; t > 0; u -= 32) {
    unsigned long long s = kInclusive;          // before tile 0: 0
    if (u >= 0) s = st[u];
    while (__any_sync(kFull, s == 0)) {
      if (s == 0) s = st[u];
    }
    const unsigned inc = __ballot_sync(kFull, (s & kInclusive) != 0);
    const int stop = inc ? __ffs(inc) - 1 : 31;    // the nearest inclusive
    excl += warp_sum(lane <= stop ? static_cast<long long>(s & kValue) : 0);
    if (inc) break;
  }
  if (lane == 0 && t > 0) {
    st[t] = kInclusive | static_cast<unsigned long long>(excl + agg);
  }
  return excl;
}

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Warp 0: the block's first slot from its warps' head counts (warp_n, in
// shared memory, complete): warp_base[w] = the slots before warp w, visible
// to the block after its next barrier.
__device__ __forceinline__ void tile_slots(unsigned long long* ws,
                                           long long tile, long long ntiles,
                                           long long* count, int nwarps,
                                           const int* warp_n,
                                           long long* warp_base) {
  long long agg = 0;
  for (int w = 0; w < nwarps; ++w) agg += warp_n[w];
  long long base = tile_exclusive(ws, tile, agg, threadIdx.x);
  if (threadIdx.x == 0) {
    if (tile == ntiles - 1) *count = base + agg;
    for (int w = 0; w < nwarps; ++w) {
      warp_base[w] = base;
      base += warp_n[w];
    }
  }
}

__device__ __forceinline__ long long take_ticket(unsigned long long* ws) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0) s_tile = static_cast<long long>(atomicAdd(ws, 1ull));
  __syncthreads();
  return s_tile;
}

// ---- row kernel: one warp per grid row, sorted in registers ------------------

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// shared memory of one warp: P values (in, then out), P ints (cols out,
// then seg), P ints (rows out)
template <typename T>
__host__ __device__ constexpr size_t row_smem(int P) {
  return static_cast<size_t>(P) * (sizeof(T) + 2 * sizeof(int));
}

template <typename T, typename Key, int EPL>
__global__ void __launch_bounds__(kRowWarps * 32, EPL <= 8 ? kRowBlocks : 1)
segcompact_rows_kernel(Args<T> a) {
  constexpr int P = 32 * EPL;                   // slots a warp
  // key = (col or N) << kShift | slot
  constexpr int kShift = sizeof(Key) == 4 ? log2i(P) : 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_n[kRowWarps];
  __shared__ long long warp_base[kRowWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = take_ticket(a.ws);

  const int F = a.F, Fp = a.Fp;
  const int lg_fp = __ffs(Fp) - 1;
  const int64_t row0 = (tile * kRowWarps + warp) * a.G;
  const int64_t left = a.R - row0;
  const int nrows = left <= 0 ? 0 : (left < a.G ? static_cast<int>(left) : a.G);
  const int n_el = nrows * F;                   // the warp's elements
  const int64_t e0 = row0 * F;                  // the first of them
  const unsigned N = static_cast<unsigned>(a.N);
  // this lane's grid row: for EPL > 1 a warp holds one row (Fp = P)
  const int g = (lane * EPL) >> lg_fp;
  int row = a.M;
  if (g < nrows) row = __ldg(a.rows + row0 + g);
  const bool row_ok = static_cast<unsigned>(row) < static_cast<unsigned>(a.M);

  unsigned char* mine = smem + warp * row_smem<T>(P);
  T* s_val = reinterpret_cast<T*>(mine);
  int* s_col = reinterpret_cast<int*>(mine + P * sizeof(T));
  int* s_row = s_col + P;

  // values into shared memory, in input order
  const bool has_val = a.value != nullptr;
  if (has_val) {
    constexpr int kVw = 16 / sizeof(T);
    if (a.vec && F % kVw == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(a.value + e0);
      uint4* dst = reinterpret_cast<uint4*>(s_val);
      for (int k = lane; k < n_el / kVw; k += 32) dst[k] = __ldg(src + k);
    } else {
      for (int k = lane; k < n_el; k += 32) s_val[k] = __ldg(a.value + e0 + k);
    }
  }

  // keys (col or N for a pad, slot in the row). Sorted rows are loaded in
  // the blocked order (slot lane * EPL + r in register r); rows to sort in
  // any order, here lane-consecutive 16-byte loads.
  Key key[EPL];
  auto make_key = [&](int c, int i) -> Key {
    const unsigned ck = row_ok && static_cast<unsigned>(c) < N
                            ? static_cast<unsigned>(c) : N;
    return (static_cast<Key>(ck) << kShift) | static_cast<Key>(i);
  };
  bool loaded = false;
  if constexpr (EPL >= 4) {
    if (a.vec && F % 4 == 0) {
#pragma unroll
      for (int q = 0; q < EPL / 4; ++q) {
        const int i0 = a.sort ? 128 * q + 4 * lane : lane * EPL + 4 * q;
        int4 c4 = make_int4(a.N, a.N, a.N, a.N);
        if (i0 < F && nrows > 0) {
          c4 = __ldg(reinterpret_cast<const int4*>(a.col + e0 + i0));
        }
        key[4 * q] = make_key(c4.x, i0);
        key[4 * q + 1] = make_key(c4.y, i0 + 1);
        key[4 * q + 2] = make_key(c4.z, i0 + 2);
        key[4 * q + 3] = make_key(c4.w, i0 + 3);
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int r = 0; r < EPL; ++r) {
      const int i = lane * EPL + r;
      const int f = i & (Fp - 1);
      int c = a.N;
      if (f < F && g < nrows) {
        c = __ldg(a.col + e0 + static_cast<int64_t>(g) * F + f);
      }
      key[r] = make_key(c, i);
    }
  }

  // bitonic sort of each Fp-slot block into the blocked order, ascending.
  // Element i = lane * EPL + r. Stages k < EPL stay in the lane, with their
  // directions known at compile time; from k = EPL on the direction and the
  // partner are functions of the lane.
  if (a.sort) {
#pragma unroll
    for (int k = 2; k < EPL; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
        for (int r = 0; r < EPL; ++r) {
          if (r & j) continue;
          const Key lo = min(key[r], key[r | j]);
          const Key hi = max(key[r], key[r | j]);
          key[r] = (r & k) ? hi : lo;
          key[r | j] = (r & k) ? lo : hi;
        }
      }
    }
    const int i0 = lane * EPL;
    for (int k = EPL > 1 ? EPL : 2; k <= Fp; k <<= 1) {
      const bool asc = k == Fp || !(i0 & k);
      for (int j = k >> 1; j >= EPL; j >>= 1) {      // partner in another lane
        const bool take_min = !(i0 & j) == asc;
        const int lm = j / EPL;
#pragma unroll
        for (int r = 0; r < EPL; ++r) {
          const Key o = __shfl_xor_sync(kFull, key[r], lm);
          key[r] = take_min ? min(key[r], o) : max(key[r], o);
        }
      }
#pragma unroll
      for (int j = EPL >> 1; j > 0; j >>= 1) {       // partner in this lane
#pragma unroll
        for (int r = 0; r < EPL; ++r) {
          if (r & j) continue;
          const Key lo = min(key[r], key[r | j]);
          const Key hi = max(key[r], key[r | j]);
          key[r] = asc ? lo : hi;
          key[r | j] = asc ? hi : lo;
        }
      }
    }
  }

  // run heads and ends
  unsigned ck[EPL];
  int pos[EPL];
#pragma unroll
  for (int r = 0; r < EPL; ++r) {
    ck[r] = static_cast<unsigned>(key[r] >> kShift);
    pos[r] = static_cast<int>(key[r] & static_cast<Key>(P - 1));
  }
  const unsigned prev_ck = __shfl_up_sync(kFull, ck[EPL - 1], 1);
  const unsigned next_ck = __shfl_down_sync(kFull, ck[0], 1);
  unsigned head = 0, end = 0, valid = 0;        // bit r for element r
#pragma unroll
  for (int r = 0; r < EPL; ++r) {
    const int f = (lane * EPL + r) & (Fp - 1);
    const unsigned before = r == 0 ? prev_ck : ck[r - 1];
    const unsigned after = r == EPL - 1 ? next_ck : ck[r + 1];
    if (ck[r] < N) {
      valid |= 1u << r;
      if (f == 0 || ck[r] != before) head |= 1u << r;
      if (f == Fp - 1 || ck[r] != after) end |= 1u << r;
    }
  }
  const int h_lane = __popc(head);
  const int h_incl = warp_inclusive(h_lane, lane);
  if (lane == 31) warp_n[warp] = h_incl;
  __syncthreads();
  // warp 0 looks back over the tiles before this one while the others sum
  if (warp == 0) {
    tile_slots(a.ws, tile, a.ntiles, a.count, kRowWarps, warp_n, warp_base);
  }

  // values in sorted order; the run open at each lane's start, summed in
  // position order: lanes with a head know their open run's sum at once,
  // lanes inside a run take it from the lane before, one step a lane
  T v[EPL];
  T cin = 0;
  if (has_val) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < EPL; ++r) {
      v[r] = (valid >> r) & 1u
                 ? s_val[(pos[r] >> lg_fp) * F + (pos[r] & (Fp - 1))] : T(0);
    }
    const bool first_cont = (valid & 1u) && !(head & 1u);
    T cout = 0;
    bool known = !first_cont || head != 0;
    if (head != 0) {
#pragma unroll
      for (int r = 0; r < EPL; ++r) {
        if ((head >> r) & 1u) {
          cout = v[r];
        } else if ((valid >> r) & 1u) {
          cout += v[r];
        }
      }
    }
    while (!__all_sync(kFull, known)) {
      const T up = __shfl_up_sync(kFull, cout, 1);
      const bool up_known = __shfl_up_sync(kFull, static_cast<int>(known), 1);
      if (!known && up_known) {
        T acc = up;
#pragma unroll
        for (int r = 0; r < EPL; ++r) {
          if ((valid >> r) & 1u) acc += v[r];
        }
        cout = acc;
        known = true;
      }
    }
    cin = __shfl_up_sync(kFull, cout, 1);
  }

  // each run's last element stages (row, col, sum) at the run's slot in the
  // warp, then the warp writes its slots with coalesced stores
  __syncwarp();                                 // s_val read: reuse it
  int ls = h_incl - h_lane - 1;                 // local slot
  T acc = cin;
#pragma unroll
  for (int r = 0; r < EPL; ++r) {
    if ((head >> r) & 1u) {
      ++ls;
      if (has_val) acc = v[r];
    } else if (has_val && ((valid >> r) & 1u)) {
      acc += v[r];
    }
    if ((end >> r) & 1u) {
      s_col[ls] = static_cast<int>(ck[r]);
      if (a.G > 1) s_row[ls] = row;
      if (has_val) s_val[ls] = acc;
    }
  }
  __syncthreads();                              // warp_base, and the stage
  const int64_t wbase = warp_base[warp];
  const int h_warp = warp_n[warp];
  const long long room = static_cast<long long>(a.cap - wbase);
  const int n_out = room <= 0 ? 0 : (room < h_warp ? static_cast<int>(room)
                                                   : h_warp);
  for (int k = lane; k < n_out; k += 32) {
    a.out_row[wbase + k] = a.G > 1 ? s_row[k] : row;
    a.out_col[wbase + k] = s_col[k];
    if (has_val) a.out_val[wbase + k] = s_val[k];
  }
  if (a.seg == nullptr) return;
  // every element's slot, staged in input order, then written coalesced
  __syncwarp();
  ls = h_incl - h_lane - 1;
#pragma unroll
  for (int r = 0; r < EPL; ++r) {
    if ((head >> r) & 1u) ++ls;
    const int f = pos[r] & (Fp - 1);
    if (f < F && g < nrows) {
      const int64_t slot = wbase + ls;
      s_col[(pos[r] >> lg_fp) * F + f] =
          (valid >> r) & 1u && slot < a.cap ? static_cast<int>(slot) : -1;
    }
  }
  __syncwarp();
  for (int k = lane; k < n_el; k += 32) a.seg[e0 + k] = s_col[k];
}

// ---- stream kernel: tiles of a sorted stream ---------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
segcompact_stream_kernel(Args<T> a) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int last_r[kThreads], last_c[kThreads];
  __shared__ int first_r[kThreads], first_c[kThreads];
  __shared__ int warp_n[kWarps];
  __shared__ long long warp_base[kWarps];
  __shared__ T warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  __shared__ int out_r[kTile], out_c[kTile];    // the tile's runs, staged
  __shared__ T out_v[kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tile = take_ticket(a.ws);
  const int64_t e0 = tile * kTile + static_cast<int64_t>(tid) * kEpt;
  const bool has_val = a.value != nullptr;
  const bool grid = a.row_div > 1;

  int rr[kEpt], cc[kEpt];
  bool brk[kEpt];                               // a grid row starts here
  T v[kEpt];
  const bool full = e0 + kEpt <= a.L;
  if (full && a.vec) {
    const int4* c4 = reinterpret_cast<const int4*>(a.col + e0);
#pragma unroll
    for (int q = 0; q < kEpt / 4; ++q) {
      const int4 c = __ldg(c4 + q);
      cc[4 * q] = c.x; cc[4 * q + 1] = c.y; cc[4 * q + 2] = c.z;
      cc[4 * q + 3] = c.w;
    }
    if (!grid) {
      const int4* r4 = reinterpret_cast<const int4*>(a.rows + e0);
#pragma unroll
      for (int q = 0; q < kEpt / 4; ++q) {
        const int4 r = __ldg(r4 + q);
        rr[4 * q] = r.x; rr[4 * q + 1] = r.y; rr[4 * q + 2] = r.z;
        rr[4 * q + 3] = r.w;
      }
    }
    if (has_val) {
      constexpr int kVw = 16 / sizeof(T);
      const uint4* v4 = reinterpret_cast<const uint4*>(a.value + e0);
#pragma unroll
      for (int q = 0; q < kEpt / kVw; ++q) {
        const uint4 u = __ldg(v4 + q);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int k = 0; k < kVw; ++k) v[q * kVw + k] = t[k];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      const int64_t e = e0 + j;
      cc[j] = e < a.L ? __ldg(a.col + e) : a.N;
      rr[j] = (!grid && e < a.L) ? __ldg(a.rows + e) : a.M;
      if (has_val) v[j] = e < a.L ? __ldg(a.value + e) : T(0);
    }
  }
  // the grid's row: one division a thread
  int64_t q = 0, rem = 0;
  if (grid) {
    q = e0 / a.row_div;
    rem = e0 - q * a.row_div;
  }
  int grid_row = grid && e0 < a.L ? __ldg(a.rows + q) : a.M;
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    brk[j] = grid && rem == 0;
    if (grid) {
      rr[j] = e0 + j < a.L ? grid_row : a.M;
      if (++rem == a.row_div && e0 + j + 1 < a.L) {
        rem = 0;
        grid_row = __ldg(a.rows + ++q);
      }
    }
    if (static_cast<unsigned>(rr[j]) < static_cast<unsigned>(a.M) &&
        static_cast<unsigned>(cc[j]) < static_cast<unsigned>(a.N)) {
      valid |= 1u << j;
    } else {
      rr[j] = a.M;
      cc[j] = a.N;
    }
  }
  last_r[tid] = rr[kEpt - 1];
  last_c[tid] = cc[kEpt - 1];
  first_r[tid] = rr[0];
  first_c[tid] = cc[0];
  int pr = a.M, pc = a.N;                       // the element before e0
  if (tid == 0 && e0 > 0 && e0 - 1 < a.L) {
    const int64_t e = e0 - 1;
    const int c = __ldg(a.col + e);
    const int r = grid ? __ldg(a.rows + e / a.row_div) : __ldg(a.rows + e);
    if (static_cast<unsigned>(r) < static_cast<unsigned>(a.M) &&
        static_cast<unsigned>(c) < static_cast<unsigned>(a.N)) {
      pr = r;
      pc = c;
    }
  }
  __syncthreads();
  if (tid > 0) {
    pr = last_r[tid - 1];
    pc = last_c[tid - 1];
  }
  const bool tile_last = tid == kThreads - 1;
  const int nr = tile_last ? a.M : first_r[tid + 1];
  const int nc = tile_last ? a.N : first_c[tid + 1];
  // the break flag of the next thread's first element
  const bool nbrk = __shfl_down_sync(kFull, static_cast<int>(brk[0]), 1) != 0;
  const bool next_brk = lane == 31
      ? (grid && !tile_last && (e0 + kEpt) % a.row_div == 0) : nbrk;

  unsigned head = 0, end = 0;
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    if (!((valid >> j) & 1u)) continue;
    const int br = j == 0 ? pr : rr[j - 1], bc = j == 0 ? pc : cc[j - 1];
    if (brk[j] || rr[j] != br || cc[j] != bc) head |= 1u << j;
    const int ar = j == kEpt - 1 ? nr : rr[j + 1];
    const int ac = j == kEpt - 1 ? nc : cc[j + 1];
    const bool ab = j == kEpt - 1 ? next_brk : brk[j + 1];
    if (tile_last && j == kEpt - 1) {
      end |= 1u << j;                           // the piece ends at the tile
    } else if (ab || ar != rr[j] || ac != cc[j]) {
      end |= 1u << j;
    }
  }
  const int h_thr = __popc(head);
  const int h_incl = warp_inclusive(h_thr, lane);
  if (lane == 31) warp_n[warp] = h_incl;

  // values: each thread in order, then a segmented scan across the block
  T cin = 0;
  int fe = 0;
  if (has_val) {
    T tv = 0;
    bool on = false;
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      if ((head >> j) & 1u) {
        tv = v[j];
        on = true;
      } else if ((valid >> j) & 1u) {
        tv = on ? tv + v[j] : v[j];
        on = true;
      }
    }
    // inclusive segmented scan (flag: a head in the span) over the warp
    int f = head != 0;
    T x = tv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T xu = __shfl_up_sync(kFull, x, d);
      const int fu = __shfl_up_sync(kFull, f, d);
      if (lane >= d) {
        if (!f) x = xu + x;
        f |= fu;
      }
    }
    if (lane == 31) {
      warp_v[warp] = x;
      warp_f[warp] = f;
    }
    cin = __shfl_up_sync(kFull, x, 1);          // the lane before's scan
    fe = __shfl_up_sync(kFull, f, 1);
  }
  __syncthreads();
  if (warp == 0) {
    tile_slots(a.ws, tile, a.ntiles, a.count, kWarps, warp_n, warp_base);
  }
  if (has_val) {
    T wc = 0;                                   // warps before this one
    for (int u = 0; u < warp; ++u) {
      wc = (u == 0 || warp_f[u]) ? warp_v[u] : wc + warp_v[u];
    }
    if (lane == 0) {
      cin = wc;
    } else if (!fe && warp > 0) {
      cin = wc + cin;
    }
  }
  __syncthreads();

  const int64_t tile_base = warp_base[0];
  const int tile_heads = static_cast<int>(warp_base[kWarps - 1] - tile_base) +
                         warp_n[kWarps - 1];
  const int h_before = (h_incl - h_thr) +
                       static_cast<int>(warp_base[warp] - tile_base);
  if (tid == 0 && a.meta != nullptr) {
    const bool open_in = (valid & 1u) && !(head & 1u);
    a.meta[tile] = ((open_in ? tile_base : 0) << 1) | (tile_heads > 0);
  }
  // each run piece's last element stages (row, col, sum) at its slot in
  // the tile; the piece of a run from an earlier tile goes to part[tile]
  T acc = cin;
  bool have = tid > 0;
  int ls = h_before - 1;                        // local slot
#pragma unroll
  for (int j = 0; j < kEpt; ++j) {
    const int64_t e = e0 + j;
    const bool is_valid = (valid >> j) & 1u;
    if ((head >> j) & 1u) {
      ++ls;
      if (has_val) acc = v[j];
      have = true;
    } else if (has_val && is_valid) {
      acc = have ? acc + v[j] : v[j];
      have = true;
    }
    if (e >= a.L) continue;
    if (a.seg != nullptr) {
      const int64_t slot = tile_base + ls;
      a.seg[e] = is_valid && slot < a.cap ? static_cast<int>(slot) : -1;
    }
    if (!((end >> j) & 1u)) continue;
    if (ls < 0) {                               // a run from an earlier tile
      if (has_val && a.part != nullptr) a.part[tile] = acc;
    } else {
      out_r[ls] = rr[j];
      out_c[ls] = cc[j];
      if (has_val) out_v[ls] = acc;
    }
  }
  __syncthreads();
  const long long room = static_cast<long long>(a.cap - tile_base);
  const int n_out = room <= 0 ? 0 : (room < tile_heads ? static_cast<int>(room)
                                                       : tile_heads);
  for (int k = tid; k < n_out; k += kThreads) {
    a.out_row[tile_base + k] = out_r[k];
    a.out_col[tile_base + k] = out_c[k];
    if (has_val) a.out_val[tile_base + k] = out_v[k];
  }
}

// Pads past the unique count, then (stream with values) each run that crosses
// tiles: meta[t] = (open_in ? slot + 1 : 0) << 1 | (tile t has a head), where
// slot is the run open at tile t's start; the run's head tile wrote its first
// partial at out_val[slot], tile t and the tiles after it wrote part[t].
template <typename T>
__global__ void __launch_bounds__(256)
segcompact_finish_kernel(Args<T> a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t me = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int64_t n = *a.count < a.cap ? *a.count : a.cap;
  for (int64_t s = n + me; s < a.cap; s += stride) {
    a.out_row[s] = a.M;
    a.out_col[s] = a.N;
    if (a.out_val != nullptr) a.out_val[s] = T(0);
  }
  if (a.meta == nullptr) return;
  for (int64_t t = 1 + me; t < a.ntiles; t += stride) {
    const long long m = a.meta[t];
    if (!(m >> 1) || !(a.meta[t - 1] & 1)) continue;   // not a run's 2nd tile
    const long long slot = (m >> 1) - 1;
    if (slot >= a.cap) continue;
    T acc = a.out_val[slot];
    for (int64_t u = t;; ++u) {
      acc += a.part[u];
      if ((a.meta[u] & 1) || u + 1 == a.ntiles || !(a.meta[u + 1] >> 1)) {
        break;
      }
    }
    a.out_val[slot] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
Args<T> make_args(const void* col, const void* rows, const void* value,
                  long long L, long long M, long long N,
                  long long out_capacity, void* out_row, void* out_col,
                  void* out_val, void* seg, void* count, void* ws) {
  Args<T> a{};
  a.col = static_cast<const int*>(col);
  a.rows = static_cast<const int*>(rows);
  a.value = static_cast<const T*>(value);
  a.L = L;
  a.M = static_cast<int>(M);
  a.N = static_cast<int>(N);
  a.cap = out_capacity;
  a.out_row = static_cast<int*>(out_row);
  a.out_col = static_cast<int*>(out_col);
  a.out_val = static_cast<T*>(out_val);
  a.seg = static_cast<int*>(seg);
  a.count = static_cast<long long*>(count);
  a.ws = static_cast<unsigned long long*>(ws);
  a.vec = aligned16(col) && aligned16(rows) &&
          (value == nullptr || aligned16(value));
  return a;
}

int pow2_at_least(long long F) {
  int p = 1;
  while (p < F) p <<= 1;
  return p;
}

template <typename T, typename Key, int EPL>
cudaError_t launch_rows(const Args<T>& a, cudaStream_t st) {
  const size_t smem = kRowWarps * row_smem<T>(32 * EPL);
  if (smem > 40 * 1024) {      // near the 48 KB default: ask for more
    const cudaError_t e = cudaFuncSetAttribute(
        segcompact_rows_kernel<T, Key, EPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  segcompact_rows_kernel<T, Key, EPL>
      <<<static_cast<unsigned>(a.ntiles), kRowWarps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename Key>
cudaError_t launch_rows_key(const Args<T>& a, int epl, cudaStream_t st) {
  switch (epl) {
    case 1: return launch_rows<T, Key, 1>(a, st);
    case 2: return launch_rows<T, Key, 2>(a, st);
    case 4: return launch_rows<T, Key, 4>(a, st);
    case 8: return launch_rows<T, Key, 8>(a, st);
    case 16: return launch_rows<T, Key, 16>(a, st);
    default: return launch_rows<T, Key, 32>(a, st);
  }
}

template <typename T>
void launch_finish(const Args<T>& a, cudaStream_t st) {
  segcompact_finish_kernel<T><<<kFinishBlocks, 256, 0, st>>>(a);
}

// row kernel geometry: (Fp, G, EPL) for grid rows of F slots
void row_geometry(long long F, int& Fp, int& G, int& epl) {
  Fp = pow2_at_least(F);
  G = Fp < 32 ? 32 / Fp : 1;
  epl = Fp < 32 ? 1 : Fp / 32;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError(); 0 means the launches were accepted.

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
// `value` and `out_val` are null (structure only), f64 when value_f64 is 1,
// else f32; `seg` is null or R * F int32s; `count` one int64; `ws` the
// zeroed 1 + tiles int64s.
extern "C" int psp_segcompact_rows(const void* col, const void* rows,
                                   long long R, long long F, long long M,
                                   long long N, const void* value,
                                   int value_f64, int sort,
                                   long long out_capacity, void* out_row,
                                   void* out_col, void* out_val, void* seg,
                                   void* count, void* ws, void* stream) {
  if (F < 1 || F > kFMax || R < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int Fp, G, epl;
  row_geometry(F, Fp, G, epl);
  const long long tiles = psp_segcompact_tiles(R, F, 0, 1);
  // 32-bit keys when (col or N) and the slot fit
  const int slot_bits = log2i(32 * epl);
  const bool key32 = (static_cast<unsigned long long>(N) << slot_bits) <
                     (1ull << 32);
  auto fill = [&](auto tag) {
    using T = decltype(tag);
    Args<T> a = make_args<T>(col, rows, value, R * F, M, N, out_capacity,
                             out_row, out_col, out_val, seg, count, ws);
    a.R = R;
    a.F = static_cast<int>(F);
    a.Fp = Fp;
    a.G = G;
    a.sort = sort;
    a.ntiles = tiles;
    const cudaError_t e = key32
        ? launch_rows_key<T, uint32_t>(a, epl, st)
        : launch_rows_key<T, unsigned long long>(a, epl, st);
    if (e != cudaSuccess) return e;
    launch_finish<T>(a, st);
    return cudaGetLastError();
  };
  return static_cast<int>(value_f64 ? fill(double{}) : fill(float{}));
}

// A sorted stream of L elements, the row of element e rows[e / row_div]
// (row_div 1: flat). With values, `meta` and `part` hold tiles entries
// (int64 and the value type); without, they are null.
extern "C" int psp_segcompact_stream(const void* col, const void* rows,
                                     long long row_div, long long L,
                                     long long M, long long N,
                                     const void* value, int value_f64,
                                     long long out_capacity, void* out_row,
                                     void* out_col, void* out_val, void* seg,
                                     void* count, void* ws, void* meta,
                                     void* part, void* stream) {
  if (L < 1 || row_div < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = psp_segcompact_tiles(0, 0, L, 0);
  auto fill = [&](auto tag) {
    using T = decltype(tag);
    Args<T> a = make_args<T>(col, rows, value, L, M, N, out_capacity,
                             out_row, out_col, out_val, seg, count, ws);
    a.row_div = row_div;
    a.ntiles = tiles;
    a.meta = static_cast<long long*>(meta);
    a.part = static_cast<T*>(part);
    segcompact_stream_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0,
                                  st>>>(a);
    launch_finish<T>(a, st);
  };
  if (value_f64) {
    fill(double{});
  } else {
    fill(float{});
  }
  return static_cast<int>(cudaGetLastError());
}
