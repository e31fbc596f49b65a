// The run compaction's kernels (segcompact.cu describes them), shared by the
// two files that instantiate them: segcompact.cu (f32 and f64 values, no
// values, and the C entry points) and segcompact_values.cu (f16, bf16,
// int32 and int64 values, and the trailing-dim pass of every value type).
// The split only lets nvcc compile the two halves in parallel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "vec_load.cuh"

namespace psp_segcompact {

// Value dtype codes of the C entry points: psp::DType's, then the ints.
enum ValueCode : int { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3, kI32 = 4,
                       kI64 = 5 };

// One call of the row kernel (a grid of F <= kFMax slots a row).
struct RowsCall {
  const void* col;
  const void* rows;
  long long R, F, M, N;
  const void* value;
  int sort;
  long long cap;
  void* out_row;
  void* out_col;
  void* out_val;
  void* seg;
  void* count;
  void* ws;
  long long tiles;
};

// One call of the stream kernel (a sorted stream of L elements).
struct StreamCall {
  const void* col;
  const void* rows;
  long long row_div, L, M, N;
  const void* value;
  long long cap;
  void* out_row;
  void* out_col;
  void* out_val;
  void* seg;
  void* count;
  void* ws;
  void* meta;
  void* part;
  long long tiles;
};

// The trailing-dim pass over a structure pass's seg: (L, D) values.
struct VecCall {
  const void* value;
  const int* seg;
  long long L, D;
  void* out_val;
  long long cap;
  const long long* count;
};

// segcompact_values.cu: f16, bf16, int32 and int64 values through either
// kernel, and the trailing-dim pass of any value code.
cudaError_t rows_values(int code, const RowsCall& c, cudaStream_t st);
cudaError_t stream_values(int code, const StreamCall& c, cudaStream_t st);
cudaError_t vec_values(int code, const VecCall& c, cudaStream_t st);

}  // namespace psp_segcompact

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

// The sum's type of a value type: f32 for f16 and bf16 (rounded once per
// run), the type itself for f32, f64, int32 and int64 (ints exact, wrapping
// as torch's).
template <typename T>
using sum_t = typename std::conditional<psp::is_bf16<T> || psp::is_f16<T>,
                                        float, T>::type;

template <typename T>
__device__ __forceinline__ sum_t<T> widen_v(T v) {
  return psp::widen<sum_t<T>>(v);
}

template <typename T>
__device__ __forceinline__ T narrow_v(sum_t<T> v) {
  return psp::narrow<T>(v);
}

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
  sum_t<T>* part;        // stream with values: 2 * ntiles, see finish kernel
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
  using A = sum_t<T>;
  A v[EPL];
  A cin = A(0);
  if (has_val) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < EPL; ++r) {
      v[r] = (valid >> r) & 1u
                 ? widen_v(s_val[(pos[r] >> lg_fp) * F + (pos[r] & (Fp - 1))])
                 : A(0);
    }
    const bool first_cont = (valid & 1u) && !(head & 1u);
    A cout = A(0);
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
      const A up = __shfl_up_sync(kFull, cout, 1);
      const bool up_known = __shfl_up_sync(kFull, static_cast<int>(known), 1);
      if (!known && up_known) {
        A acc = up;
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
  A acc = cin;
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
      if (has_val) s_val[ls] = narrow_v<T>(acc);
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
  using A = sum_t<T>;
  __shared__ int warp_n[kWarps];
  __shared__ long long warp_base[kWarps];
  __shared__ A warp_v[kWarps];
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
  A v[kEpt];
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
        for (int k = 0; k < kVw; ++k) v[q * kVw + k] = widen_v(t[k]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) {
      const int64_t e = e0 + j;
      cc[j] = e < a.L ? __ldg(a.col + e) : a.N;
      rr[j] = (!grid && e < a.L) ? __ldg(a.rows + e) : a.M;
      if (has_val) v[j] = e < a.L ? widen_v(__ldg(a.value + e)) : A(0);
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
  A cin = A(0);
  int fe = 0;
  if (has_val) {
    A tv = A(0);
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
    A x = tv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const A xu = __shfl_up_sync(kFull, x, d);
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
    A wc = A(0);                                // warps before this one
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
  // the tile; the piece of a run from an earlier tile goes to part[tile],
  // and the tile's last element, when its run has its head here, also puts
  // its piece, unrounded, in part[ntiles + tile] (the finish kernel folds a
  // run that crosses tiles from there, so it is rounded once)
  A acc = cin;
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
      if (has_val) out_v[ls] = narrow_v<T>(acc);
      if (has_val && a.part != nullptr && tile_last && j == kEpt - 1) {
        a.part[a.ntiles + tile] = acc;
      }
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
// slot is the run open at tile t's start; the run's head tile t - 1 wrote its
// first partial at part[ntiles + t - 1] (and, rounded, at out_val[slot]),
// tile t and the tiles after it wrote part[t]. The run's sum is taken in the
// sum's type and rounded once into out_val[slot].
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
    if (a.out_val != nullptr) a.out_val[s] = narrow_v<T>(sum_t<T>(0));
  }
  if (a.meta == nullptr) return;
  for (int64_t t = 1 + me; t < a.ntiles; t += stride) {
    const long long m = a.meta[t];
    if (!(m >> 1) || !(a.meta[t - 1] & 1)) continue;   // not a run's 2nd tile
    const long long slot = (m >> 1) - 1;
    if (slot >= a.cap) continue;
    sum_t<T> acc = a.part[a.ntiles + t - 1];
    for (int64_t u = t;; ++u) {
      acc += a.part[u];
      if ((a.meta[u] & 1) || u + 1 == a.ntiles || !(a.meta[u + 1] >> 1)) {
        break;
      }
    }
    a.out_val[slot] = narrow_v<T>(acc);
  }
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
  a.vec = psp::aligned16(col) && psp::aligned16(rows) &&
          (value == nullptr || psp::aligned16(value));
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

// ---- trailing dims: runs of D-vectors on a flat stream -----------------------

// Value element i = e * D + d of a flat stream whose structure pass wrote
// seg (each element's slot, -1 for pads and slots past out_capacity): the
// thread of a run's first element walks the run in position order, summing
// column d in the sum's type, and writes the slot's entry, rounded once.
// Threads go over (element, column) with the column fastest, so neighbouring
// threads read neighbouring values. Then slots past the unique count get 0.
template <typename T>
__global__ void __launch_bounds__(256)
segcompact_vec_kernel(const T* __restrict__ value, const int* __restrict__ seg,
                      int64_t L, int64_t D, T* __restrict__ out_val,
                      int64_t cap, const long long* __restrict__ count) {
  using A = sum_t<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t me = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int64_t i = me; i < L * D; i += stride) {
    const int64_t e = i / D;
    const int s = __ldg(seg + e);
    if (s < 0 || (e > 0 && __ldg(seg + e - 1) == s)) continue;
    A acc = widen_v(__ldg(value + i));
    for (int64_t f = e + 1; f < L && __ldg(seg + f) == s; ++f) {
      acc += widen_v(__ldg(value + i + (f - e) * D));
    }
    out_val[static_cast<int64_t>(s) * D + (i - e * D)] = narrow_v<T>(acc);
  }
  const int64_t n = *count < cap ? *count : cap;
  for (int64_t i = n * D + me; i < cap * D; i += stride) {
    out_val[i] = narrow_v<T>(A(0));
  }
}

template <typename T>
void launch_vec(const psp_segcompact::VecCall& c, cudaStream_t st) {
  segcompact_vec_kernel<T><<<kFinishBlocks * 4, 256, 0, st>>>(
      static_cast<const T*>(c.value), c.seg, c.L, c.D,
      static_cast<T*>(c.out_val), c.cap, c.count);
}

// ---- host side: one call of either layout, of value type T ------------------

// 32-bit keys when (col or N) and the slot fit
bool key32(long long N, int epl) {
  const int slot_bits = log2i(32 * epl);
  return (static_cast<unsigned long long>(N) << slot_bits) < (1ull << 32);
}

template <typename T>
cudaError_t run_rows(const psp_segcompact::RowsCall& c, cudaStream_t st) {
  int Fp, G, epl;
  row_geometry(c.F, Fp, G, epl);
  Args<T> a = make_args<T>(c.col, c.rows, c.value, c.R * c.F, c.M, c.N,
                           c.cap, c.out_row, c.out_col, c.out_val, c.seg,
                           c.count, c.ws);
  a.R = c.R;
  a.F = static_cast<int>(c.F);
  a.Fp = Fp;
  a.G = G;
  a.sort = c.sort;
  a.ntiles = c.tiles;
  const cudaError_t e = key32(c.N, epl)
      ? launch_rows_key<T, uint32_t>(a, epl, st)
      : launch_rows_key<T, unsigned long long>(a, epl, st);
  if (e != cudaSuccess) return e;
  launch_finish<T>(a, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_stream(const psp_segcompact::StreamCall& c, cudaStream_t st) {
  Args<T> a = make_args<T>(c.col, c.rows, c.value, c.L, c.M, c.N, c.cap,
                           c.out_row, c.out_col, c.out_val, c.seg, c.count,
                           c.ws);
  a.row_div = c.row_div;
  a.ntiles = c.tiles;
  a.meta = static_cast<long long*>(c.meta);
  a.part = static_cast<sum_t<T>*>(c.part);
  segcompact_stream_kernel<T><<<static_cast<unsigned>(c.tiles), kThreads, 0,
                                st>>>(a);
  launch_finish<T>(a, st);
  return cudaGetLastError();
}

}  // namespace
