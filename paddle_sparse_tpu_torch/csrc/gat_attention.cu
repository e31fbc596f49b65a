// GAT's attention weights for Hopper (sm_90a): per node the head scores,
// then per CSR row the softmax of its edges' logits.
//
//   s_dst[n, h] = sum_d hw[n, h, d] * a_dst[h, d]      (and s_src with a_src)
//   logit[e, h] = leaky_relu(s_dst[row(e), h] + s_src[col[e], h], slope)
//   att[h, e]   = exp(logit[e, h] - max_row) / max(sum_row exp(...), 1e-16)
//
// Replaces no TPU kernel: the JAX package's GAT scores and edge_softmax
// (paddle_sparse_tpu/models/gcn.py) are plain jnp, which XLA fuses into about
// two passes over the edge stream. The port's plain torch took some twenty
// (E, H) passes a layer, each written to device memory (gathers by an int64
// flat index, two-level scatter max and sum, masks, exp, divide). These two
// kernels restore the fusion.
//
// What bounds them on the H100: bytes. The node scores read hw once (N x H x
// D, 5.0 GB a hidden layer of ogbn-products at 4 x 128 f32) and write 2 N H
// values; the edge pass reads col once (4 bytes an edge) and writes att once
// (4 H bytes an edge), and gathers s_src[col] (H values an edge), which at
// N x 4 f32 = 39 MB fits in the 50 MB L2. A handful of operations a byte:
// memory-bound by far.
//
// Design:
// - node scores: one warp a node, heads in groups of four whose 8 dot
//   products a lane keeps in registers, the loads of the four heads issued
//   together, 16-byte loads along D when D allows (else scalar); the 8 sums
//   in 9 shuffles (each of three steps halves what a lane holds), lanes 0,
//   4, ..., 28 writing them.
// - edge softmax: one warp a CSR row, in edge order, lane i on entries i,
//   i + 32, ... for the heads of a group (four heads, then single heads
//   for what is left; at H = 4 the four scores of an entry one vector
//   gather), the row's max and sum butterflies over the warp. A row of at
//   most 64 entries keeps its logits in registers: exact max, then exp and
//   the sum, then one write. A longer row keeps a running max and a
//   rescaled sum a lane (online), combines them across the warp, and
//   recomputes its logits in a second sweep to write them. Rows longer than
//   the piece table's cap (ops/kernels/row_split.py) go one warp a piece:
//   each piece writes its partial (max, sum) to a workspace slot, a fold
//   pass combines a split row's partials in a fixed order, and a write pass
//   has each piece write its normalised values. No atomics, a fixed order of every sum: two
//   launches give the same bits. att is written with the streaming hint
//   (2% faster at the cell's shapes on the H100). A lane on one head of 32
//   / kH entries, 3 shuffles a value where butterflies take 5 a head, ran
//   1.4x slower there: 4x the load and store instructions for the same
//   bytes; and reductions with fewer shuffles gained nothing measurable.
// - att is head-major, (H, ld) with ld >= the entries, so head h's weights
//   are one contiguous row; entries past rowptr[M] (padding) get 0.
//
// Semantics are those of the plain torch version (models/gcn.py::
// edge_softmax): a non-finite row max (NaN, +inf, or -inf when every logit
// is -inf) is taken as 0, the denominator is floored at 1e-16 (a NaN stays
// NaN), and exp and the divide are IEEE f32 (f64 for f64 inputs). Where the
// max is non-finite, the plain sum of exp(logit - 0) is NaN (a NaN logit),
// +inf (a +inf logit) or 0 (all -inf), so the online and split paths take
// that denominator without another sweep.
//
// Contract (the Python wrapper checks dtypes, shapes, devices and
// contiguity): hw (N, H, D), a_src and a_dst (H, D), s_src and s_dst (N, H)
// contiguous, all f32 or all f64; rowptr (M+1,) int32 with every col[e],
// e < rowptr[M], in [0, N) and s_dst holding at least M rows; out (H, ld).
// A piece table is rowptr's own (row_split.split_rows at S = 1): a split
// row's pieces hold consecutive workspace slots in piece order.

#include "spans.cuh"
#include "vec_load.cuh"

namespace {

using psp::aligned;
using psp::fma_acc;
using psp::kFullMask;
using psp::load_vec;

constexpr int kWarps = 8;      // warps a block: one node, row or piece each
constexpr int kHeadGroup = 4;  // heads whose dot products a lane holds

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ bool finite(T x) {
  return isfinite(x);
}

// max that keeps a NaN, as torch's amax does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// torch's clamp(min=1e-16): a NaN stays NaN
template <typename T>
__device__ __forceinline__ T floor_den(T d) {
  return d < T(1e-16) ? T(1e-16) : d;
}

// Running (max, sum of exp(x - max)) of one lane: one more logit.
template <typename T>
__device__ __forceinline__ void online_add(T& m, T& s, T x) {
  if (x != x) {
    m = x;
  } else if (x > m) {
    s = s * exp_t(m - x) + T(1);  // m = -inf: s is 0, and 0 * 0 + 1
    m = x;
  } else if (finite(m)) {
    s += exp_t(x - m);
  }
}

// Two (max, sum) states combined; symmetric in its two sides bit for bit, so
// every lane of a butterfly ends with the same state.
template <typename T>
__device__ __forceinline__ void combine(T& m, T& s, T m2, T s2) {
  const T mx = nan_max(m, m2);
  s = finite(mx) ? s * exp_t(m - mx) + s2 * exp_t(m2 - mx) : T(0);
  m = mx;
}

// The row max and denominator the writes use, from a combined state: the
// max itself when finite, else 0 with the plain version's sum of exp(x).
template <typename T>
__device__ __forceinline__ void finish(T m, T s, T& shift, T& den) {
  if (finite(m)) {
    shift = m;
    den = floor_den(s);
  } else {
    shift = T(0);
    den = (m != m) ? m : floor_den(m > T(0) ? inf_of<T>() : T(0));
  }
}

// ---- node scores -----------------------------------------------------------

// The 8 values v (per lane) summed over the warp, each to the lanes that
// hold it: lane L ends with the sum of v[L >> 2]. Three steps each halve
// what a lane holds (a lane keeps one half, its partner the other, and
// each adds what the other sends), then two plain steps: 9 shuffles where 8
// butterflies take 40 (the kernel 8% faster at D = 128 and 14% at D = 47 on
// the H100 at ogbn-products' 2.45M nodes).
template <typename T>
__device__ __forceinline__ T sum8_to_lanes(const T (&v)[8], int lane) {
  T w[4], u[2];
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (b4 ? v[4 + k] : v[k]) +
           __shfl_xor_sync(kFullMask, b4 ? v[k] : v[4 + k], 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    u[k] = (b3 ? w[2 + k] : w[k]) +
           __shfl_xor_sync(kFullMask, b3 ? w[k] : w[2 + k], 8);
  }
  T t = (b2 ? u[1] : u[0]) + __shfl_xor_sync(kFullMask, b2 ? u[0] : u[1], 4);
  t += __shfl_xor_sync(kFullMask, t, 2);
  t += __shfl_xor_sync(kFullMask, t, 1);
  return t;
}

// V: elements of a lane load along D (16 bytes when D and the pointers
// allow, else 1). A lane's loads of the four heads of a group are issued
// together, then summed.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
gat_node_scores_kernel(const T* __restrict__ hw, const T* __restrict__ a_src,
                       const T* __restrict__ a_dst, T* __restrict__ s_src,
                       T* __restrict__ s_dst, int N, int H, int D) {
  const int lane = threadIdx.x & 31;
  const long long n =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warp leaves together
  const T* row = hw + n * H * D;
  for (int h0 = 0; h0 < H; h0 += kHeadGroup) {
    T v[2 * kHeadGroup];  // the src dots of the group's heads, then the dst
#pragma unroll
    for (int j = 0; j < 2 * kHeadGroup; ++j) v[j] = T(0);
    for (int d = lane * V; d < D; d += 32 * V) {
#pragma unroll
      for (int j = 0; j < kHeadGroup; ++j) {
        if (h0 + j < H) {
          const int o = (h0 + j) * D + d;
          T x[V], as[V], ad[V];
          load_vec<T, V>(row + o, x);
          load_vec<T, V>(a_src + o, as);
          load_vec<T, V>(a_dst + o, ad);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            v[j] = fma_acc(x[i], as[i], v[j]);
            v[kHeadGroup + j] = fma_acc(x[i], ad[i], v[kHeadGroup + j]);
          }
        }
      }
    }
    const T t = sum8_to_lanes(v, lane);
    const int j = lane >> 2;  // this lane's sum: v[j]
    if ((lane & 3) == 0 && h0 + (j & 3) < H) {
      (j < kHeadGroup ? s_src : s_dst)[n * H + h0 + (j & 3)] = t;
    }
  }
}

// ---- edge softmax ----------------------------------------------------------

// Heads h0 .. h0 + kH - 1 of an (N, H) score table; kVec: H == kH, so a
// node's kH scores are one aligned vector load.
template <typename T, int kH, bool kVec>
struct Heads {
  const T* s_src;
  int H, h0;
  T slope;

  __device__ __forceinline__ void logits(int c, const T (&sd)[kH],
                                         T (&l)[kH]) const {
    T ss[kH];
    if constexpr (kVec) {
      load_vec<T, kH>(s_src + static_cast<long long>(c) * kH, ss);
    } else {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        ss[h] = __ldg(s_src + static_cast<long long>(c) * H + h0 + h);
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const T v = sd[h] + ss[h];
      l[h] = v > T(0) ? v : v * slope;
    }
  }
};

// Pass 0 (kWrite false): warp w takes row w, or piece w of the table, lane
// i its entries i, i + 32, ..., each for the kH heads. A whole row (no
// table, or a piece whose slot is -1) is written out; a piece of a split
// row writes its (max, sum) per head to workspace slot p_slot[w]. Its
// threads also zero the padding entries [rowptr[M], ld).
// Pass 2 (kWrite true): each piece of a split row writes its entries with
// the row's combined state, which the fold left in the row's first slot.
// att is written with the streaming hint: it passes through L2 without
// pushing out the score table that the gathers read.
template <typename T, int kH, bool kVec, bool kWrite>
__global__ void __launch_bounds__(kWarps * 32)
gat_edge_softmax_kernel(const int* __restrict__ rowptr,
                        const int* __restrict__ col,
                        const T* __restrict__ s_dst, Heads<T, kH, kVec> hd,
                        T* __restrict__ out, long long ld, int M, int units,
                        const int* __restrict__ p_row,
                        const int* __restrict__ p_piece,
                        const int* __restrict__ p_slot, long long cap,
                        T* __restrict__ ws) {
  constexpr int kRegs = 2;  // a short row's logits a lane holds: rows <= 64
  const int lane = threadIdx.x & 31;
  if constexpr (!kWrite) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(__ldg(rowptr + M)) +
                       static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         e < ld; e += stride) {
#pragma unroll
      for (int h = 0; h < kH; ++h) out[(hd.h0 + h) * ld + e] = T(0);
    }
  }
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= units) return;  // whole warp leaves together
  int row = w, piece = 0, slot = -1;
  if (p_row != nullptr) {
    row = __ldg(p_row + w);
    piece = __ldg(p_piece + w);
    slot = __ldg(p_slot + w);
  }
  if (kWrite && slot < 0) return;
  const int rs = __ldg(rowptr + row), re = __ldg(rowptr + row + 1);
  const int e0 = rs + static_cast<int>(piece * cap);
  const int e1 = slot < 0 ? re : min(e0 + static_cast<int>(cap), re);
  const int H = hd.H;
  T sd[kH];
  T* out_h[kH];  // head h's row of att
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    sd[h] = __ldg(s_dst + static_cast<long long>(row) * H + hd.h0 + h);
    out_h[h] = out + (hd.h0 + h) * ld;
  }

  T shift[kH], den[kH];
  if (!kWrite && slot < 0 && e1 - e0 <= 32 * kRegs) {
    // a short row: logits in registers, exact max, one write
    T l[kRegs][kH], m[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) m[h] = -inf_of<T>();
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int e = e0 + r * 32 + lane;
      if (e < e1) {
        hd.logits(__ldg(col + e), sd, l[r]);
#pragma unroll
        for (int h = 0; h < kH; ++h) m[h] = nan_max(m[h], l[r][h]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        m[h] = nan_max(m[h], __shfl_xor_sync(kFullMask, m[h], o));
      }
    }
    T s[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      shift[h] = finite(m[h]) ? m[h] : T(0);
      s[h] = T(0);
    }
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      if (e0 + r * 32 + lane < e1) {
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          l[r][h] = exp_t(l[r][h] - shift[h]);
          s[h] += l[r][h];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < kH; ++h) s[h] += __shfl_xor_sync(kFullMask, s[h], o);
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) den[h] = floor_den(s[h]);
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int e = e0 + r * 32 + lane;
      if (e < e1) {
#pragma unroll
        for (int h = 0; h < kH; ++h) __stcs(out_h[h] + e, l[r][h] / den[h]);
      }
    }
    return;
  }

  if constexpr (kWrite) {
    const T* st = ws + (static_cast<long long>(slot - piece) * H + hd.h0) * 2;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      finish(st[2 * h], st[2 * h + 1], shift[h], den[h]);
    }
  } else {
    // a long row or a piece: a running (max, sum) a lane, then the warp's
    T m[kH], s[kH], l[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      m[h] = -inf_of<T>();
      s[h] = T(0);
    }
    for (int e = e0 + lane; e < e1; e += 32) {
      hd.logits(__ldg(col + e), sd, l);
#pragma unroll
      for (int h = 0; h < kH; ++h) online_add(m[h], s[h], l[h]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const T m2 = __shfl_xor_sync(kFullMask, m[h], o);
        const T s2 = __shfl_xor_sync(kFullMask, s[h], o);
        combine(m[h], s[h], m2, s2);
      }
    }
    if (slot >= 0) {
      if (lane == 0) {
        T* st = ws + (static_cast<long long>(slot) * H + hd.h0) * 2;
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          st[2 * h] = m[h];
          st[2 * h + 1] = s[h];
        }
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) finish(m[h], s[h], shift[h], den[h]);
  }
  // the second sweep: logits again, written normalised
  for (int e = e0 + lane; e < e1; e += 32) {
    T l[kH];
    hd.logits(__ldg(col + e), sd, l);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      __stcs(out_h[h] + e, exp_t(l[h] - shift[h]) / den[h]);
    }
  }
}

// Pass 1 of a split launch: warp r combines split row r's partial states,
// slots fold_ptr[r] .. fold_ptr[r+1]-1 (lane i the i-th, i+32-th, ... in
// order, then a butterfly: a fixed order), into the row's first slot.
template <typename T, int kH>
__global__ void __launch_bounds__(kWarps * 32)
gat_fold_kernel(const int* __restrict__ fold_ptr, int R, int H, int h0,
                T* __restrict__ ws) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int p0 = __ldg(fold_ptr + r), p1 = __ldg(fold_ptr + r + 1);
  T m[kH], s[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    m[h] = -inf_of<T>();
    s[h] = T(0);
  }
  for (int p = p0 + lane; p < p1; p += 32) {
    const T* st = ws + (static_cast<long long>(p) * H + h0) * 2;
#pragma unroll
    for (int h = 0; h < kH; ++h) combine(m[h], s[h], st[2 * h], st[2 * h + 1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const T m2 = __shfl_xor_sync(kFullMask, m[h], o);
      const T s2 = __shfl_xor_sync(kFullMask, s[h], o);
      combine(m[h], s[h], m2, s2);
    }
  }
  if (lane == 0) {
    T* st = ws + (static_cast<long long>(p0) * H + h0) * 2;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      st[2 * h] = m[h];
      st[2 * h + 1] = s[h];
    }
  }
}

struct EdgeArgs {
  const int* rowptr;
  const int* col;
  const void* s_dst;
  const void* s_src;
  void* out;
  long long ld;
  int M, H;
  double slope;
  const int* p_row;
  const int* p_piece;
  const int* p_slot;
  long long P, cap;
  const int* fold_ptr;
  long long R;
  void* ws;
};

unsigned blocks(long long units) {
  return static_cast<unsigned>((units + kWarps - 1) / kWarps);
}

template <typename T, int kH, bool kVec>
void edge_group(const EdgeArgs& a, int h0, cudaStream_t stream) {
  const Heads<T, kH, kVec> hd{static_cast<const T*>(a.s_src), a.H, h0,
                              static_cast<T>(a.slope)};
  const T* sd = static_cast<const T*>(a.s_dst);
  T* out = static_cast<T*>(a.out);
  T* ws = static_cast<T*>(a.ws);
  const long long units = a.p_row != nullptr ? a.P : a.M;
  const dim3 block(kWarps * 32);
  const unsigned g = blocks(units) > 0 ? blocks(units) : 1;
  gat_edge_softmax_kernel<T, kH, kVec, false><<<g, block, 0, stream>>>(
      a.rowptr, a.col, sd, hd, out, a.ld, a.M, static_cast<int>(units),
      a.p_row, a.p_piece, a.p_slot, a.cap, ws);
  if (a.p_row == nullptr || a.R == 0) return;
  gat_fold_kernel<T, kH><<<blocks(a.R), block, 0, stream>>>(
      a.fold_ptr, static_cast<int>(a.R), a.H, h0, ws);
  gat_edge_softmax_kernel<T, kH, kVec, true><<<g, block, 0, stream>>>(
      a.rowptr, a.col, sd, hd, out, a.ld, a.M, static_cast<int>(units),
      a.p_row, a.p_piece, a.p_slot, a.cap, ws);
}

// Heads in groups of four, then one at a time, the passes of each group in
// turn; H = 4 reads a node's four scores as one vector when the table is
// aligned for it.
template <typename T>
int edge_softmax(const EdgeArgs& a, cudaStream_t stream) {
  const bool vec = a.H == kHeadGroup && aligned(a.s_src, 16);
  for (int h0 = 0; h0 < a.H;) {
    if (vec) {
      edge_group<T, kHeadGroup, true>(a, h0, stream);
      h0 += kHeadGroup;
    } else if (a.H - h0 >= kHeadGroup) {
      edge_group<T, kHeadGroup, false>(a, h0, stream);
      h0 += kHeadGroup;
    } else {
      edge_group<T, 1, false>(a, h0, stream);
      h0 += 1;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
void node_scores(const void* hw, const void* a_src, const void* a_dst,
                 void* s_src, void* s_dst, int N, int H, int D,
                 cudaStream_t stream) {
  const T* x = static_cast<const T*>(hw);
  const T* as = static_cast<const T*>(a_src);
  const T* ad = static_cast<const T*>(a_dst);
  T* ss = static_cast<T*>(s_src);
  T* sd = static_cast<T*>(s_dst);
  constexpr int V = psp::vec16<T>;
  const dim3 block(kWarps * 32), grid(blocks(N));
  if (D % V == 0 && aligned(hw, 16) && aligned(a_src, 16) &&
      aligned(a_dst, 16)) {
    gat_node_scores_kernel<T, V><<<grid, block, 0, stream>>>(x, as, ad, ss,
                                                             sd, N, H, D);
  } else {
    gat_node_scores_kernel<T, 1><<<grid, block, 0, stream>>>(x, as, ad, ss,
                                                             sd, N, H, D);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes; code is psp::DType's (0 f32,
// 3 f64; anything else is refused with cudaErrorInvalidValue before a
// launch). Each launches on `stream` and returns cudaGetLastError().
//
// psp_gat_node_scores: hw (N, H, D), a_src and a_dst (H, D) -> s_src and
// s_dst (N, H). N >= 1.
extern "C" int psp_gat_node_scores(const void* hw, const void* a_src,
                                   const void* a_dst, void* s_src,
                                   void* s_dst, long long N, long long H,
                                   long long D, int code, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N), h = static_cast<int>(H),
            d = static_cast<int>(D);
  if (code == psp::kF32) {
    node_scores<float>(hw, a_src, a_dst, s_src, s_dst, n, h, d, cs);
  } else if (code == psp::kF64) {
    node_scores<double>(hw, a_src, a_dst, s_src, s_dst, n, h, d, cs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// psp_gat_edge_softmax: the (H, ld) head-major weights of rowptr's M rows
// (M >= 1) from the scores; entries [rowptr[M], ld) written 0. p_row NULL:
// one warp a row; else the P-piece table (p_row, p_piece, p_slot, cap) with
// its R split rows' fold_ptr and a (W, H, 2) workspace ws of the scores'
// type, W the table's slots.
extern "C" int psp_gat_edge_softmax(
    const void* rowptr, const void* col, const void* s_dst,
    const void* s_src, void* out, long long ld, long long M, long long H,
    double slope, int code, const void* p_row, const void* p_piece,
    const void* p_slot, long long P, long long cap, const void* fold_ptr,
    long long R, void* ws, void* stream) {
  EdgeArgs a;
  a.rowptr = static_cast<const int*>(rowptr);
  a.col = static_cast<const int*>(col);
  a.s_dst = s_dst;
  a.s_src = s_src;
  a.out = out;
  a.ld = ld;
  a.M = static_cast<int>(M);
  a.H = static_cast<int>(H);
  a.slope = slope;
  a.p_row = static_cast<const int*>(p_row);
  a.p_piece = static_cast<const int*>(p_piece);
  a.p_slot = static_cast<const int*>(p_slot);
  a.P = P;
  a.cap = cap;
  a.fold_ptr = static_cast<const int*>(fold_ptr);
  a.R = R;
  a.ws = ws;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (code == psp::kF32) return edge_softmax<float>(a, cs);
  if (code == psp::kF64) return edge_softmax<double>(a, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
