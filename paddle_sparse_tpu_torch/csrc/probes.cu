// The five TPU probe kernels of experiments/, for Hopper (sm_90a).
//
// Each probe under experiments/ asks one design question of the TPU with a
// Pallas kernel. Here each gets a hand-written kernel that computes the same
// function, so that paddle_sparse_tpu_torch/experiments/ can ask the question
// of the H100:
//
// - scale2 (experiments/bisect_pallas.py:23 k, pallas_call :26 in trivial):
//   o = 2 * x over f32. A grid-stride float4 loop; bound by its bytes, and at
//   the probe's (256, 128) by the launch.
// - chunk_sum (bisect_pallas.py:38 k, pallas_call :86 in dma_copy):
//   out[t * E + i] = sum_{ptr[t] <= c < ptr[t+1]} src[c * E + i], the chunks
//   summed in ascending c. The TPU stages whole (E, K) chunks through one or
//   two VMEM slots with async copies; `double_buffer` picks the depth. Here
//   one CTA per (tile, 16 KB block of the tile's flat E * K elements) stages
//   its block of every chunk through a shared-memory ring of depth 1 or 2
//   (cp.async.bulk, completion on an mbarrier per slot), so the flag still
//   picks the depth. A whole 128 KB chunk in two slots would not fit in the
//   227 KB a block may have. f32 adds in chunk order from 0: the same bits
//   as a plain f32 sum in that order.
// - span_colsum (experiments/r4_dma_issue.py:44 kern, pallas_call :77):
//   step t stages NS spans of CAP rows of a bf16 (L, K) stream, starting at
//   rows e0[t * NS + s], and folds them with one MXU product into
//   seed[r] * colsum_t[k]; the wrapper takes the probe's output from the
//   (steps, K) f32 column sums. What bounds it here: the distinct rows the
//   spans cover, read once (3.57 GB at the probe's defaults, 1.07 ms at
//   3.35 TB/s); the spans overlap, so staging each step's own spans reads a
//   covered row 2.14 times on average. So the wrapper cuts the covered rows,
//   on the device, into pieces between consecutive span endpoints of at most
//   kPieceRows rows (every span is a run of whole pieces); piece_colsum
//   streams every piece once through a 4-deep ring of 16 KB bulk async
//   copies, one ring per CTA across all of its pieces, and writes each
//   piece's (K,) f32 column sum; step_colsum then adds, for each step, its
//   spans' piece sums in span order and ascending rows, so a span held by
//   two steps, or twice by one, counts once per occurrence.
//   span_colsum_staged keeps the probe's own schedule: one CTA per step
//   streams its spans through the same ring. It answers the probe's question
//   (each copy's issue cost hides behind the staged bytes) and takes each
//   chunk's column sum for band_ablate's "nosel" (NS = 1, CAP = E, e0 = c *
//   E: disjoint spans, each byte read once already).
// - band_ablate<nodot|nosel|empty> (experiments/r4_band_cost.py:181 k_nodot,
//   :201 k_nosel, :217 k_empty; pallas_call :131 in make_call): the cost
//   bisect of K4. Chunk c of E stream rows visits output tiles row0_c / 128
//   + j for j < nj_c (at most TMAX) and adds to each: nodot the edge count of
//   the tile's row 0 bounds within the chunk, to every entry; nosel the
//   chunk's column sum, to every row; empty the chunk's first 128 rows. The
//   TPU walks chunks in order with the band resident in VMEM; here the
//   tile's visits are sorted on the device into ascending c (the TPU grid's
//   order), so no atomics and the same sum order. nosel and empty: one CTA
//   owns one tile and 64 columns and walks the tile's visits. nodot
//   (band_nodot_kernel) moves one number a tile and stores 128 K of it, so
//   what bounds it is the (BR_pad, K) f32 output, written once (8.8 us at
//   the probe's defaults); walking 38 visits one after another, three
//   dependent loads each, in all 256 threads of 4 CTAs a tile cost it 4x
//   that. The output is one contiguous run of tiles of 128 K f32, so nodot
//   is a segmented fill: each CTA stores an equal contiguous share of its
//   16-byte units (within one unit), several CTAs an SM, after the counts
//   of the tiles its share touches, one warp a tile and a lane for each of
//   up to 64 visits: the tile's loads in one round, the overlaps added in
//   f32 in ascending c from shuffles. (k_full and k_untrans are K4's function, on K4's
//   port.)
// - slice_gather (experiments/r5_vmem_expand.py:56 kernel, pallas_call :85
//   in make_call): chunk c's E edges gather rows of one R-row slice of x,
//   x[fs[c] * R + cols[c * E + e]]; "write" writes each gathered row (an
//   exact copy), "reduce" writes the f32 sum over the chunk, rounded to bf16
//   once, as 8 equal rows. The probe's question is whether a gather served
//   from an on-chip slice beats one global gather per edge.
//   write: a 512 x 256 bf16 slice is 256 KB, over a block's 227 KB, so one
//   CTA per (chunk, 128 columns) loads its 128 KB part of the slice into
//   shared memory (one 256-byte bulk copy per slice row, all on one
//   mbarrier), and the chunk's column indices beside it, and serves every
//   edge's row from there. Bound by the bytes written.
//   reduce (slice_reduce): the TPU's onehot(cols)(E, R) @ slice(R, K) summed
//   over E is counts(R) . slice, so a chunk's sum needs its row counts, not
//   one read per edge. What bounds it: the distinct slices, cols and the
//   output, each moved once (0.084 ms at the probe's defaults), where a
//   slice per chunk moved 2.7 GB. The wrapper groups the chunks by slice on
//   the device (ascending c within a slice) and cuts each group into work
//   items of at most kItemChunks chunks. Persistent CTAs walk the items;
//   for each, a shared-memory histogram of each chunk's cols over the R rows,
//   then each 32-column part of the slice, loaded once per item by TMA
//   (boxes of at most 256 rows) into one of two buffers, the next part's
//   load in flight while this one is summed: out_c = counts_c . part, with
//   f32 sums, the slice rows split among the warps and their sums added in
//   shared memory. Up to E = 2,048 edges a chunk every count and bf16 value
//   is exact in TF32, so the tensor cores take the products (mma.sync
//   m16n8k8); past that the CUDA cores' f32 FMAs, each slice value read
//   once per item and applied to four chunks' counts in registers (count *
//   bf16 is exact in f32 below 2**16). The only rounding is of the sums.
//   Past R = 768 a part narrows to 16 or 8 columns, so that the two buffers
//   and the counts still fit a block's shared memory.
//
// Contract (the Python wrapper, ops/kernels/probes_cuda.py, checks shapes,
// dtypes, devices, contiguity and 16-byte alignment): ptr is non-decreasing
// with ptr[T] * E rows in src; every span [e0, e0 + CAP) lies in the stream;
// every visited chunk lies in the stream and every tile in the band; fs[c]
// indexes a whole slice of x and cols lie in [0, R). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

#include "tma.cuh"
#include "vec_load.cuh"

namespace {

using psp::encode_tiled;
using psp::EncodeTiledFn;
using psp::load_vec;
using psp::store_vec;
using psp::tma_load_box;

constexpr int kThreads = 256;

// ---- bulk async copies completing on an mbarrier (sm_90) ------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of transfers on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; the barrier counts the bytes as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- scale2 ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float* __restrict__ x, float* __restrict__ o,
              long long n, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long long i = first; i < n4; i += stride) {
    float4 v = __ldg(x4 + i);
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    o4[i] = v;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    o[i] = __ldg(x + i) * 2.0f;
  }
}

// ---- chunk_sum -------------------------------------------------------------

constexpr int kChunkPer = 16;                      // floats per thread
constexpr int kChunkBlock = kThreads * kChunkPer;  // 4096 floats, 16 KB

// Grid (blocks of a tile's E * K elements, T). DEPTH 1: the next chunk's
// copy starts after the current one is summed; 2: it starts before.
template <int DEPTH>
__global__ void __launch_bounds__(kThreads)
chunk_sum_kernel(const int* __restrict__ ptr, const float* __restrict__ src,
                 float* __restrict__ out, long long EK) {
  __shared__ __align__(128) float buf[DEPTH][kChunkBlock];
  __shared__ __align__(8) uint64_t bar[DEPTH];
  const int t = blockIdx.y;
  const long long off = static_cast<long long>(blockIdx.x) * kChunkBlock;
  const int n = static_cast<int>(
      EK - off < kChunkBlock ? EK - off : static_cast<long long>(kChunkBlock));
  const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
  const int c0 = __ldg(ptr + t), c1 = __ldg(ptr + t + 1);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int d = 0; d < DEPTH; ++d) mbar_init(&bar[d], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int c, int slot) {
    mbar_expect_tx(&bar[slot], bytes);
    bulk_load(buf[slot], src + static_cast<long long>(c) * EK + off, bytes,
              &bar[slot]);
  };
  if (tid == 0 && c0 < c1) issue(c0, 0);
  float acc[kChunkPer];
#pragma unroll
  for (int j = 0; j < kChunkPer; ++j) acc[j] = 0.0f;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0;
    const int slot = DEPTH == 1 ? 0 : (i & 1);
    const uint32_t parity = DEPTH == 1 ? (i & 1) : ((i >> 1) & 1);
    // depth 2: slot (i + 1) & 1 was last read in step i - 1, and every
    // thread passed that step's closing barrier
    if (DEPTH == 2 && tid == 0 && c + 1 < c1) issue(c + 1, (i + 1) & 1);
    mbar_wait(&bar[slot], parity);
#pragma unroll
    for (int j = 0; j < kChunkPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < n) acc[j] += buf[slot][e];
    }
    __syncthreads();  // the slot may be refilled
    if (DEPTH == 1 && tid == 0 && c + 1 < c1) issue(c + 1, 0);
  }
  float* o = out + static_cast<long long>(t) * EK + off;
#pragma unroll
  for (int j = 0; j < kChunkPer; ++j) {
    const int e = tid + j * kThreads;
    if (e < n) o[e] = acc[j];
  }
}

// ---- span_colsum -----------------------------------------------------------

constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kPieceRows = 256;  // P: rows of a piece at most (probes_cuda.py)

// The staged kernel: one CTA per step. VR: 16-byte vectors per stream row
// (K / 8), a power of two up to 256. Thread tid sums vector tid % VR of rows
// tid / VR, tid / VR + 256 / VR, ...
template <int VR>
__global__ void __launch_bounds__(kThreads)
span_colsum_staged_kernel(const __nv_bfloat16* __restrict__ stream,
                   const int* __restrict__ e0, float* __restrict__ out,
                   int NS, int CAP) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar[kStages];
  constexpr int K = VR * 8;
  constexpr int kRowBytes = VR * 16;
  constexpr int RB = kStageBytes / kRowBytes;  // rows per sub-chunk
  constexpr int RL = kThreads / VR;            // row lanes
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int per_span = (CAP + RB - 1) / RB;
  const int n = NS * per_span;
  if (tid == 0) {
    for (int d = 0; d < kStages; ++d) mbar_init(&bar[d], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto rows_of = [&](int i) {
    const int b = i % per_span;
    return CAP - b * RB < RB ? CAP - b * RB : RB;
  };
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int s = i / per_span, b = i % per_span;
    const long long row =
        static_cast<long long>(__ldg(e0 + static_cast<long long>(t) * NS + s)) +
        static_cast<long long>(b) * RB;
    const uint32_t bytes = static_cast<uint32_t>(rows_of(i)) * kRowBytes;
    mbar_expect_tx(&bar[st], bytes);
    bulk_load(ring + st * kStageBytes, stream + row * K, bytes, &bar[st]);
  };
  if (tid == 0) {
    for (int i = 0; i < n && i < kStages; ++i) issue(i);
  }
  const int v = tid % VR, rl = tid / VR;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    mbar_wait(&bar[st], (i / kStages) & 1);
    const __nv_bfloat16* buf =
        reinterpret_cast<const __nv_bfloat16*>(ring + st * kStageBytes);
    const int rows = rows_of(i);
    for (int r = rl; r < rows; r += RL) {
      const uint4 u = *reinterpret_cast<const uint4*>(buf + r * K + v * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        acc[2 * q] += f.x;
        acc[2 * q + 1] += f.y;
      }
    }
    __syncthreads();  // the stage may be refilled
    if (tid == 0 && i + kStages < n) issue(i + kStages);
  }
  // every copy has landed and been read: the ring holds the row lanes' sums
  float* red = reinterpret_cast<float*>(ring);  // (RL, K): 8 KB
#pragma unroll
  for (int q = 0; q < 8; ++q) red[rl * K + v * 8 + q] = acc[q];
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    float s = 0.0f;
    for (int l = 0; l < RL; ++l) s += red[l * K + k];
    out[static_cast<long long>(t) * K + k] = s;
  }
}

template <int VR>
int launch_span_colsum_staged(const __nv_bfloat16* stream, const int* e0,
                              float* out, long long steps, int NS, int CAP,
                              cudaStream_t cs) {
  const int smem = kStages * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      span_colsum_staged_kernel<VR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  span_colsum_staged_kernel<VR>
      <<<static_cast<unsigned>(steps), kThreads, smem, cs>>>(stream, e0, out,
                                                            NS, CAP);
  return static_cast<int>(cudaGetLastError());
}

// Grid-stride over the pieces q < *total, piece q the stream rows [prow[q],
// prow[q] + plen[q]), 1 <= plen[q] <= kPieceRows: each CTA streams its
// pieces one after another through the ring of the staged kernel, 16 KB
// sub-chunks, no gap in the ring between pieces, and writes each piece's
// (K,) f32 column sum to psum[q]. Thread tid sums vector tid % VR of the
// sub-chunk's rows tid / VR, tid / VR + 256 / VR, ...; at a piece's end the
// row lanes' sums meet in shared memory.
template <int VR>
__global__ void __launch_bounds__(kThreads)
piece_colsum_kernel(const __nv_bfloat16* __restrict__ stream,
                    const int* __restrict__ prow,
                    const int* __restrict__ plen,
                    const int* __restrict__ ptotal,
                    float* __restrict__ psum) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar[kStages];
  __shared__ __align__(16) float red[kThreads * 8];  // (RL, K): row lanes
  constexpr int K = VR * 8;
  constexpr int kRowBytes = VR * 16;
  constexpr int RB = kStageBytes / kRowBytes;  // rows per sub-chunk
  constexpr int RL = kThreads / VR;            // row lanes
  const int total = __ldg(ptotal);
  const int step = static_cast<int>(gridDim.x);
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= total) return;
  if (tid == 0) {
    for (int d = 0; d < kStages; ++d) mbar_init(&bar[d], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // the issuer's cursor (thread 0): piece iq, rows [irow, irow + ilen), its
  // next sub-chunk ib
  int iq = blockIdx.x, ib = 0, ilen = 0;
  long long irow = 0;
  auto issue = [&](int i) {  // the cursor's sub-chunk into stage i % kStages
    if (iq >= total) return;
    const int st = i % kStages;
    const int rows = min(RB, ilen - ib * RB);
    const uint32_t bytes = static_cast<uint32_t>(rows) * kRowBytes;
    mbar_expect_tx(&bar[st], bytes);
    bulk_load(ring + st * kStageBytes,
              stream + (irow + static_cast<long long>(ib) * RB) * K, bytes,
              &bar[st]);
    if (++ib * RB >= ilen) {
      ib = 0;
      iq += step;
      if (iq < total) {
        irow = __ldg(prow + iq);
        ilen = __ldg(plen + iq);
      }
    }
  };
  if (tid == 0) {
    irow = __ldg(prow + iq);
    ilen = __ldg(plen + iq);
    for (int i = 0; i < kStages; ++i) issue(i);
  }
  const int v = tid % VR, rl = tid / VR;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
  int cq = blockIdx.x, cb = 0, clen = __ldg(plen + cq);
  for (int i = 0; cq < total; ++i) {
    const int st = i % kStages;
    mbar_wait(&bar[st], (i / kStages) & 1);
    const __nv_bfloat16* buf =
        reinterpret_cast<const __nv_bfloat16*>(ring + st * kStageBytes);
    const int rows = min(RB, clen - cb * RB);
    for (int r = rl; r < rows; r += RL) {
      const uint4 u = *reinterpret_cast<const uint4*>(buf + r * K + v * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        acc[2 * q] += f.x;
        acc[2 * q + 1] += f.y;
      }
    }
    const bool last = ++cb * RB >= clen;  // the same in every thread
    if (last) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        red[rl * K + v * 8 + q] = acc[q];
        acc[q] = 0.0f;
      }
    }
    __syncthreads();  // the stage may be refilled; red holds the piece's sums
    if (tid == 0) issue(i + kStages);
    if (last) {
      float* o = psum + static_cast<long long>(cq) * K;
      for (int k = tid; k < K; k += kThreads) {
        float sum = 0.0f;
        for (int l = 0; l < RL; ++l) sum += red[l * K + k];
        o[k] = sum;
      }
      cq += step;
      cb = 0;
      if (cq < total) clen = __ldg(plen + cq);
      __syncthreads();  // red is read before the next piece writes it
    }
  }
}

// Step t (one warp of the grid): out[t, k] = the sum, over its NS spans in
// order and each span's pieces [first, last) in ascending order, of psum[q,
// k]. Lane l takes columns 8 l .. 8 l + 7 of every 256.
__global__ void __launch_bounds__(kThreads)
step_colsum_kernel(const int* __restrict__ first, const int* __restrict__ last,
                   const float* __restrict__ psum, float* __restrict__ out,
                   long long steps, int NS, int K) {
  const long long t =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (t >= steps) return;
  const int lane = threadIdx.x & 31;
  for (int c = lane * 8; c < K; c += 256) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      const long long sp = t * NS + s;
      const int q1 = __ldg(last + sp);
      for (int q = __ldg(first + sp); q < q1; ++q) {
        float f[4], g[4];
        const float* row = psum + static_cast<long long>(q) * K + c;
        load_vec<float, 4>(row, f);
        load_vec<float, 4>(row + 4, g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] += f[j];
          acc[j + 4] += g[j];
        }
      }
    }
    store_vec<float, 8>(out + t * K + c, acc);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1) {
    return 132;
  }
  return n;
}

template <int VR>
int launch_span_colsum(const __nv_bfloat16* stream, const int* prow,
                       const int* plen, const int* ptotal,
                       long long npieces_max, const int* first,
                       const int* last, float* psum, float* out,
                       long long steps, int NS, cudaStream_t cs) {
  const int smem = kStages * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      piece_colsum_kernel<VR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = 3LL * sm_count();  // 72 KB a CTA: three on an SM
  if (grid > npieces_max) grid = npieces_max;
  if (grid > 0) {
    piece_colsum_kernel<VR><<<static_cast<unsigned>(grid), kThreads, smem,
                              cs>>>(stream, prow, plen, ptotal, psum);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (steps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks == 0) return 0;
  step_colsum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, cs>>>(
      first, last, psum, out, steps, NS, VR * 8);
  return static_cast<int>(cudaGetLastError());
}

// ---- band_ablate -----------------------------------------------------------

constexpr int kModeNodot = 0;
constexpr int kModeNosel = 1;
constexpr int kModeEmpty = 2;
constexpr int kBandRows = 128;  // rows of an output tile (the TPU's R)
constexpr int kBandCols = 64;   // columns of a CTA: 8 lanes of 8 values

// nosel and empty: grid (tiles, column blocks). Thread tid holds column
// vector tid % 8 of rows tid / 8 + 32 q, q < 4. Visits i in [tile_ptr[tile],
// tile_ptr[tile+1]) name the chunks that visit the tile, in ascending order.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
band_ablate_kernel(const int* __restrict__ tile_ptr,
                   const int* __restrict__ visit_chunk,
                   const __nv_bfloat16* __restrict__ stream,
                   const float* __restrict__ colsum, float* __restrict__ out,
                   int K, int E) {
  static_assert(MODE == kModeNosel || MODE == kModeEmpty, "nosel or empty");
  const int tile = blockIdx.x;
  const int col = blockIdx.y * kBandCols + (threadIdx.x & 7) * 8;
  const int rl = threadIdx.x >> 3;
  const int v0 = __ldg(tile_ptr + tile), v1 = __ldg(tile_ptr + tile + 1);
  float* o = out + static_cast<long long>(tile) * kBandRows * K;
  if (col >= K) return;
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[q][i] = 0.0f;
  }
  for (int i = v0; i < v1; ++i) {
    const long long c = __ldg(visit_chunk + i);
    if constexpr (MODE == kModeEmpty) {
      const __nv_bfloat16* head = stream + c * E * K + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[8];
        load_vec<__nv_bfloat16, 8>(head + static_cast<long long>(rl + 32 * q) * K,
                                   f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][j] += f[j];
      }
    } else {
      float f[4], g[4];
      load_vec<float, 4>(colsum + c * K + col, f);
      load_vec<float, 4>(colsum + c * K + col + 4, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] += f[j];
        acc[0][j + 4] += g[j];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = MODE == kModeEmpty ? acc[q][j] : acc[0][j];
    }
    store_vec<float, 8>(o + static_cast<long long>(rl + 32 * q) * K + col, w);
  }
}

constexpr int kNodotCtasPerSm = 4;             // CTAs of band_nodot an SM
constexpr int kNodotWarps = kThreads / 32;     // tiles counted at once

// The overlap of visit i's chunk with the bound at (its span, the tile's
// first row), as f32; 0 past the tile's last visit v1.
__device__ __forceinline__ float band_visit_overlap(
    int i, int v1, long long tile, const int* __restrict__ visit_chunk,
    const int* __restrict__ chunk_span, const int* __restrict__ bst,
    const int* __restrict__ ben, long long BR_pad, int E) {
  if (i >= v1) return 0.0f;
  const long long c = __ldg(visit_chunk + i);
  const long long b = static_cast<long long>(__ldg(chunk_span + c)) * BR_pad +
                      tile * kBandRows;
  const long long lo = max(static_cast<long long>(__ldg(bst + b)), c * E);
  const long long hi = min(static_cast<long long>(__ldg(ben + b)), (c + 1) * E);
  return static_cast<float>(hi > lo ? hi - lo : 0);
}

// nodot's count of one tile, in every lane of the calling warp: lane l
// loads visits v0 + l and v0 + 32 + l (+ 64, ... past 64 visits), all in
// one round, and every lane adds the overlaps in ascending visit order from
// shuffles: the f32 sum, in the order, of band_ablate_reference.
__device__ __forceinline__ float band_tile_count(
    long long tile, const int* __restrict__ tile_ptr,
    const int* __restrict__ visit_chunk, const int* __restrict__ chunk_span,
    const int* __restrict__ bst, const int* __restrict__ ben, long long BR_pad,
    int E) {
  const int lane = threadIdx.x & 31;
  const int v0 = __ldg(tile_ptr + tile), v1 = __ldg(tile_ptr + tile + 1);
  float acc = 0.0f;
  for (int base = v0; base < v1; base += 64) {
    const float n0 = band_visit_overlap(base + lane, v1, tile, visit_chunk,
                                        chunk_span, bst, ben, BR_pad, E);
    const float n1 = band_visit_overlap(base + 32 + lane, v1, tile,
                                        visit_chunk, chunk_span, bst, ben,
                                        BR_pad, E);
    const int m = v1 - base;
    for (int j = 0; j < 32 && j < m; ++j) {
      acc += __shfl_sync(0xffffffffu, n0, j);
    }
    for (int j = 0; j < 32 && j < m - 32; ++j) {
      acc += __shfl_sync(0xffffffffu, n1, j);
    }
  }
  return acc;
}

// nodot: CTA b of G stores the 16-byte units [U b / G, U (b + 1) / G) of the
// output (U = ntiles * tile_units, tile_units = 32 K), each unit its tile's
// count. The tiles its share touches (two at the probe's defaults) are
// counted kNodotWarps at a time, one warp each, then their units stored
// with streaming 16-byte stores, the CTA's threads on consecutive units.
__global__ void __launch_bounds__(kThreads)
band_nodot_kernel(const int* __restrict__ tile_ptr,
                  const int* __restrict__ visit_chunk,
                  const int* __restrict__ chunk_span,
                  const int* __restrict__ bst, const int* __restrict__ ben,
                  long long BR_pad, float* __restrict__ out,
                  long long tile_units, long long units, int E) {
  __shared__ float count[kNodotWarps];
  const long long G = gridDim.x, b = blockIdx.x;
  const long long u0 = units * b / G, u1 = units * (b + 1) / G;
  if (u0 >= u1) return;
  const long long t_first = u0 / tile_units, t_last = (u1 - 1) / tile_units;
  const int warp = threadIdx.x >> 5;
  float4* o = reinterpret_cast<float4*>(out);
  for (long long g = t_first; g <= t_last; g += kNodotWarps) {
    if (g + warp <= t_last) {
      const float n = band_tile_count(g + warp, tile_ptr, visit_chunk,
                                      chunk_span, bst, ben, BR_pad, E);
      if ((threadIdx.x & 31) == 0) count[warp] = n;
    }
    __syncthreads();
    const long long g_end =
        t_last + 1 < g + kNodotWarps ? t_last + 1 : g + kNodotWarps;
    for (long long t = g; t < g_end; ++t) {
      const float v = count[t - g];
      const float4 w = make_float4(v, v, v, v);
      const long long a = u0 > t * tile_units ? u0 : t * tile_units;
      const long long z = u1 < (t + 1) * tile_units ? u1 : (t + 1) * tile_units;
      for (long long u = a + threadIdx.x; u < z; u += kThreads) {
        __stcs(o + u, w);
      }
    }
    __syncthreads();  // count[] is written again
  }
}

// ---- the plans of span_colsum and slice_reduce ------------------------------
//
// Built on the device inside the call, from a workspace the wrapper
// allocates (probes_cuda._plan_ws_bytes): a stable radix sort (CUB) and
// prefix sums (CUB), and small kernels between them. The wrapper's plain
// versions (span_pieces_reference, slice_items_reference) build the same
// tables with torch ops.

constexpr int kPlanThreads = 256;
constexpr int kItemChunks = 32;  // G: chunks of one slice in a work item

size_t round256(size_t b) { return (b + 255) / 256 * 256; }

// Carves 256-byte aligned arrays out of the workspace; ok turns false when
// the workspace is too small.
struct Carve {
  unsigned char* p;
  size_t left;
  bool ok;
  template <typename T>
  T* take(size_t n) {
    const size_t b = round256(n * sizeof(T));
    if (b > left) {
      ok = false;
      return nullptr;
    }
    T* r = reinterpret_cast<T*>(p);
    p += b;
    left -= b;
    return r;
  }
};

unsigned plan_blocks(long long n) {
  const long long b = (n + kPlanThreads - 1) / kPlanThreads;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// keys[i] = the span endpoints, starts then ends (e0[i] + cap); vals[i] = i
__global__ void span_ends_kernel(const int* __restrict__ e0, int n, int cap,
                                 unsigned* __restrict__ keys,
                                 int* __restrict__ vals) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= 2 * n) return;
  keys[i] = static_cast<unsigned>(i < n ? __ldg(e0 + i)
                                        : __ldg(e0 + i - n) + cap);
  vals[i] = i;
}

__global__ void span_delta_kernel(const int* __restrict__ code, int n, int m,
                                  int* __restrict__ delta) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i < m) delta[i] = __ldg(code + i) < n ? 1 : -1;
}

// cnt[i]: the pieces of segment [s[i], s[i + 1]) if a span covers it
__global__ void piece_count_kernel(const unsigned* __restrict__ s,
                                   const int* __restrict__ cover, int m,
                                   int* __restrict__ cnt) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= m) return;
  const unsigned len = i + 1 < m ? __ldg(s + i + 1) - __ldg(s + i) : 0u;
  cnt[i] = __ldg(cover + i) > 0
               ? static_cast<int>((len + kPieceRows - 1) / kPieceRows)
               : 0;
}

// Segment i's pieces at pe[i] ..; the span whose endpoint sorted to i starts
// (or ends) at piece pe[i] (equal endpoints bound empty segments: one pe).
__global__ void piece_table_kernel(const unsigned* __restrict__ s,
                                   const int* __restrict__ code,
                                   const int* __restrict__ cnt,
                                   const int* __restrict__ pe, int n, int m,
                                   int* __restrict__ prow,
                                   int* __restrict__ plen,
                                   int* __restrict__ first,
                                   int* __restrict__ last,
                                   int* __restrict__ total) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= m) return;
  const int c = __ldg(code + i), q0 = __ldg(pe + i), k = __ldg(cnt + i);
  if (c < n) {
    first[c] = q0;
  } else {
    last[c - n] = q0;
  }
  if (k > 0) {
    const unsigned a = __ldg(s + i), b = __ldg(s + i + 1);
    for (int q = 0; q < k; ++q) {
      const unsigned row = a + static_cast<unsigned>(q) * kPieceRows;
      prow[q0 + q] = static_cast<int>(row);
      plen[q0 + q] = static_cast<int>(min(b - row,
                                          static_cast<unsigned>(kPieceRows)));
    }
  }
  if (i == m - 1) *total = q0 + k;
}

constexpr int kSpanPlanArrays = 8;   // int arrays of 2 n that span_plan takes
constexpr int kSlicePlanArrays = 6;  // and of n that slice_plan takes

// Workspace of a plan over m keys below 2**end_bit: `arrays` int arrays of
// m (as Carve takes them) and CUB's temporary storage for the radix sort and
// the prefix sums, as large as the largest of CUB's queries.
size_t plan_ws_bytes(int m, int arrays, int end_bit) {
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  int* none = nullptr;
  size_t sort_b = 0, inc_b = 0, exc_b = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, sort_b, keys, vals, m, 0, end_bit);
  cub::DeviceScan::InclusiveSum(nullptr, inc_b, none, none, m);
  cub::DeviceScan::ExclusiveSum(nullptr, exc_b, none, none, m);
  return arrays * round256(static_cast<size_t>(m) * sizeof(int)) +
         round256(std::max(sort_b, std::max(inc_b, exc_b)));
}

// The span piece plan (probes_cuda.span_pieces) of the n spans [e0[i], e0[i]
// + cap), the endpoints below 2**end_bit.
int span_plan(const int* e0, int n, int cap, int end_bit, int* prow,
              int* plen, int* total, int* first, int* last, void* ws,
              size_t ws_bytes, cudaStream_t cs) {
  const int m = 2 * n;
  Carve w{static_cast<unsigned char*>(ws), ws_bytes, true};
  unsigned* k0 = w.take<unsigned>(m);
  unsigned* k1 = w.take<unsigned>(m);
  int* v0 = w.take<int>(m);
  int* v1 = w.take<int>(m);
  int* delta = w.take<int>(m);
  int* cover = w.take<int>(m);
  int* cnt = w.take<int>(m);
  int* pe = w.take<int>(m);
  if (!w.ok) return static_cast<int>(cudaErrorMemoryAllocation);
  cub::DoubleBuffer<unsigned> keys(k0, k1);
  cub::DoubleBuffer<int> vals(v0, v1);
  size_t sort_b = 0, scan_b = 0, b = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, sort_b, keys, vals, m, 0, end_bit,
                                  cs);
  cub::DeviceScan::InclusiveSum(nullptr, scan_b, delta, cover, m, cs);
  cub::DeviceScan::ExclusiveSum(nullptr, b, cnt, pe, m, cs);
  const size_t tmp_b = std::max(sort_b, std::max(scan_b, b));
  void* tmp = w.take<unsigned char>(tmp_b);
  if (!w.ok) return static_cast<int>(cudaErrorMemoryAllocation);
  const unsigned blocks = plan_blocks(m);
  span_ends_kernel<<<blocks, kPlanThreads, 0, cs>>>(e0, n, cap, k0, v0);
  cudaError_t e = cub::DeviceRadixSort::SortPairs(tmp, sort_b, keys, vals, m,
                                                  0, end_bit, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned* sorted = keys.Current();
  const int* code = vals.Current();
  span_delta_kernel<<<blocks, kPlanThreads, 0, cs>>>(code, n, m, delta);
  e = cub::DeviceScan::InclusiveSum(tmp, scan_b, delta, cover, m, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  piece_count_kernel<<<blocks, kPlanThreads, 0, cs>>>(sorted, cover, m, cnt);
  e = cub::DeviceScan::ExclusiveSum(tmp, b, cnt, pe, m, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  piece_table_kernel<<<blocks, kPlanThreads, 0, cs>>>(
      sorted, code, cnt, pe, n, m, prow, plen, first, last, total);
  return static_cast<int>(cudaGetLastError());
}

__global__ void chunk_keys_kernel(const int* __restrict__ fs, int n,
                                  unsigned* __restrict__ keys,
                                  int* __restrict__ vals) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= n) return;
  keys[i] = static_cast<unsigned>(__ldg(fs + i));
  vals[i] = i;
}

// flag[i] = 1 where an item starts: every kItemChunks-th chunk of a slice's
// run in the sorted keys, counted from the run's first (a binary search).
__global__ void item_flag_kernel(const unsigned* __restrict__ sf, int n,
                                 int* __restrict__ flag) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned key = __ldg(sf + i);
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sf + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  flag[i] = (i - lo) % kItemChunks == 0;
}

__global__ void item_start_kernel(const int* __restrict__ flag,
                                  const int* __restrict__ before, int n,
                                  int* __restrict__ istart,
                                  int* __restrict__ n_items) {
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= n) return;
  if (__ldg(flag + i)) istart[__ldg(before + i)] = i;
  if (i == n - 1) {
    const int items = __ldg(before + i) + __ldg(flag + i);
    *n_items = items;
    istart[items] = n;
  }
}

// The item plan (probes_cuda.slice_items) of n chunks on slices fs < 2**
// end_bit: order and sf (fs[order]) of n entries, istart of n + 1.
int slice_plan(const int* fs, int n, int end_bit, int* order, int* sf,
               int* istart, int* n_items, void* ws, size_t ws_bytes,
               cudaStream_t cs) {
  Carve w{static_cast<unsigned char*>(ws), ws_bytes, true};
  unsigned* k0 = w.take<unsigned>(n);
  unsigned* k1 = w.take<unsigned>(n);
  int* v0 = w.take<int>(n);
  int* v1 = w.take<int>(n);
  int* flag = w.take<int>(n);
  int* before = w.take<int>(n);
  if (!w.ok) return static_cast<int>(cudaErrorMemoryAllocation);
  cub::DoubleBuffer<unsigned> keys(k0, k1);
  cub::DoubleBuffer<int> vals(v0, v1);
  size_t sort_b = 0, scan_b = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, sort_b, keys, vals, n, 0, end_bit,
                                  cs);
  cub::DeviceScan::ExclusiveSum(nullptr, scan_b, flag, before, n, cs);
  const size_t tmp_b = std::max(sort_b, scan_b);
  void* tmp = w.take<unsigned char>(tmp_b);
  if (!w.ok) return static_cast<int>(cudaErrorMemoryAllocation);
  const unsigned blocks = plan_blocks(n);
  chunk_keys_kernel<<<blocks, kPlanThreads, 0, cs>>>(fs, n, k0, v0);
  cudaError_t e = cub::DeviceRadixSort::SortPairs(tmp, sort_b, keys, vals, n,
                                                  0, end_bit, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  item_flag_kernel<<<blocks, kPlanThreads, 0, cs>>>(keys.Current(), n, flag);
  e = cub::DeviceScan::ExclusiveSum(tmp, scan_b, flag, before, n, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  item_start_kernel<<<blocks, kPlanThreads, 0, cs>>>(flag, before, n, istart,
                                                     n_items);
  e = cudaMemcpyAsync(sf, keys.Current(), n * sizeof(int),
                      cudaMemcpyDeviceToDevice, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyAsync(order, vals.Current(), n * sizeof(int),
                      cudaMemcpyDeviceToDevice, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- slice_gather, write: each chunk's rows from its slice part -----------

constexpr int kSliceCols = 128;  // columns of x per CTA: 256-byte rows
constexpr int kSliceLanes = kSliceCols / 8;       // 16 vectors of a row
constexpr int kEdgeLanes = kThreads / kSliceLanes;  // 16 edges at a time

// Grid (chunks, column parts). The part's R x W slice lands in shared memory
// through R bulk copies on one barrier, and the chunk's E column indices
// beside it (read once, so the edge loop waits on no global load); thread
// tid serves vector tid % 16 of edges tid / 16, tid / 16 + 16, ...
__global__ void __launch_bounds__(kThreads)
slice_gather_kernel(const int* __restrict__ fs, const int* __restrict__ cols,
                    const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ out, int R, int E, int K) {
  extern __shared__ __align__(128) unsigned char slice_raw[];
  __shared__ __align__(8) uint64_t bar;
  const long long c = blockIdx.x;
  const int k0 = blockIdx.y * kSliceCols;
  const int W = K - k0 < kSliceCols ? K - k0 : kSliceCols;
  const int tid = threadIdx.x;
  __nv_bfloat16* slice = reinterpret_cast<__nv_bfloat16*>(slice_raw);
  int* ccols = reinterpret_cast<int*>(slice_raw + static_cast<long long>(R) *
                                                      kSliceCols * 2);
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {
    const uint32_t row_bytes = static_cast<uint32_t>(W) * 2u;
    if (tid == 0) mbar_expect_tx(&bar, row_bytes * static_cast<uint32_t>(R));
    __syncwarp();
    const long long row0 = static_cast<long long>(__ldg(fs + c)) * R;
    for (int r = tid; r < R; r += 32) {
      bulk_load(slice + static_cast<long long>(r) * W,
                x + (row0 + r) * K + k0, row_bytes, &bar);
    }
  }
  for (int e = tid; e < E; e += kThreads) ccols[e] = __ldg(cols + c * E + e);
  mbar_wait(&bar, 0);
  __syncthreads();  // the column indices
  const int v = tid % kSliceLanes, el = tid / kSliceLanes;
  if (v * 8 >= W) return;
  __nv_bfloat16* oc = out + c * E * K + k0 + v * 8;
#pragma unroll 4
  for (int e = el; e < E; e += kEdgeLanes) {
    const int r = ccols[e];
    *reinterpret_cast<uint4*>(oc + static_cast<long long>(e) * K) =
        *reinterpret_cast<const uint4*>(slice + r * W + v * 8);
  }
}

// ---- slice_gather, reduce: each chunk's counts times its slice -------------

constexpr int kPartCols = 32;     // columns of a slice part: 64-byte rows
constexpr int kBoxRows = 256;     // rows of a TMA box at most
constexpr int kReduceThreads = 256;  // 8 warps: one CTA an SM, persistent
constexpr int kWarps = kReduceThreads / 32;
constexpr int kRedStride = 33;    // floats a lane in the warps' sums: no
                                  // two lanes of a warp on one bank

// Chunk j's count of slice row r: 32 words a row, each group of four
// chunks XOR-swizzled by r, so that a warp's atomics (8 lanes a chunk, random
// rows) and its float4 reads (one row, eight groups) spread over the banks.
__device__ __forceinline__ int count_slot(int r, int j) {
  return r * kItemChunks + 4 * ((j >> 2) ^ (r & 7)) + (j & 3);
}

// Persistent CTAs walk the work items: item i holds the chunks order[istart[i]
// .. istart[i + 1]) (at most kItemChunks, ascending, one slice: sf[istart[i]]).
// Per item: the chunks' histograms of cols over the R rows in shared memory,
// then per 32-column part of the slice (TMA, nbox boxes of box_rows rows; two
// buffers, the next unit's load in flight), out_c = counts_c . part in f32.
// MMA (E <= 2,048: every count and bf16 value exact in TF32): warp w takes
// the 8-row steps w, w + 8, ... of the part through mma.sync m16n8k8 TF32
// tiles of 16 chunks x 8 columns, f32 sums. Else f32 FMAs: lane (lr, lc) of
// warp w holds four chunks (quad) x eight columns (lc) of the part and walks
// rows of [w R / 8, (w + 1) R / 8), 8 / nqp rows a step when the item has
// fewer than 8 quads (lr = off * nqp + quad). The warps' sums meet in
// shared memory.
template <bool MMA>
__global__ void __launch_bounds__(kReduceThreads, 1)
slice_reduce_kernel(const __grid_constant__ CUtensorMap xmap,
                    const int* __restrict__ order, const int* __restrict__ sf,
                    const int* __restrict__ istart,
                    const int* __restrict__ n_items_p,
                    const int* __restrict__ cols,
                    __nv_bfloat16* __restrict__ out, int R, int E, int K,
                    int PW, int box_rows, int nbox, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int ch[kItemChunks];
  // TMA writes 128-byte aligned boxes: the launch gives 128 bytes to spare
  unsigned char* smem =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int R8 = (R + 7) & ~7;  // the MMA reads the counts 8 rows a step
  int* cnt = reinterpret_cast<int*>(smem + 2 * stage_bytes);  // (R8, 32)
  float* red = reinterpret_cast<float*>(
      smem + 2 * stage_bytes + static_cast<long long>(R8) * kItemChunks * 4);
  const int n_items = __ldg(n_items_p);
  const int grid = static_cast<int>(gridDim.x);
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  const int my_items = (n_items - static_cast<int>(blockIdx.x) + grid - 1) /
                       grid;
  const int P = (K + PW - 1) / PW;
  const int nunits = my_items * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t unit_bytes = static_cast<uint32_t>(nbox) * box_rows * PW * 2;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // thread 0: the first x row of the slices of items li, li + 1, li + 2
  auto slice_row = [&](int li) {
    const int it = static_cast<int>(blockIdx.x) + li * grid;
    return it < n_items ? __ldg(sf + __ldg(istart + it)) * R : 0;
  };
  int row0 = 0, row1 = 0, row2 = 0;
  auto issue = [&](int u, int cur) {  // unit u = (item, part) into u & 1
    const int li = u / P, p = u - li * P;
    const int row = li == cur ? row0 : li == cur + 1 ? row1 : row2;
    unsigned char* dst = smem + (u & 1) * stage_bytes;
    mbar_expect_tx(&bar[u & 1], unit_bytes);
    for (int b = 0; b < nbox; ++b) {
      tma_load_box(dst + b * box_rows * PW * 2, &xmap, p * PW,
                   row + b * box_rows, &bar[u & 1]);
    }
  };
  if (tid == 0) {
    row0 = slice_row(0);
    row1 = slice_row(1);
    row2 = slice_row(2);
    for (int u = 0; u < 2 && u < nunits; ++u) issue(u, 0);
  }
  const int lr = lane >> 2, lc = lane & 3;
  const int rpw = (R + kWarps - 1) / kWarps;
  const int r_lo = warp * rpw;
  const int r_hi = min(R, r_lo + rpw);
  const bool live = lc * 8 < PW;
  for (int li = 0; li < my_items; ++li) {
    const int item = static_cast<int>(blockIdx.x) + li * grid;
    const int first = __ldg(istart + item);
    const int nc = __ldg(istart + item + 1) - first;  // 1 .. kItemChunks
    if (tid < kItemChunks) ch[tid] = tid < nc ? __ldg(order + first + tid) : 0;
    for (int i = tid; i < R8 * kItemChunks; i += kReduceThreads) cnt[i] = 0;
    __syncthreads();
    // the histograms: lane group g takes chunk 4 q + g, 8 lanes side by
    // side; four indices a lane in one 16-byte load where E % 4 == 0 and
    // cols is 16-byte aligned (so is then every chunk's first index), and
    // four loads in flight before their atomics
    const int nq = (nc + 3) >> 2;
    {
      const int g = lane >> 3, il = lane & 7;
      const bool vec =
          (E & 3) == 0 && (reinterpret_cast<uintptr_t>(cols) & 15u) == 0;
      for (int q = 0; q < nq; ++q) {
        const int j = 4 * q + g;
        if (j >= nc) continue;
        const int* cc = cols + static_cast<long long>(ch[j]) * E;
        if (vec) {
          const int4* cc4 = reinterpret_cast<const int4*>(cc);
#pragma unroll 4
          for (int e = warp * 8 + il; e < (E >> 2); e += kWarps * 8) {
            const int4 r = __ldg(cc4 + e);
            atomicAdd(cnt + count_slot(r.x, j), 1);
            atomicAdd(cnt + count_slot(r.y, j), 1);
            atomicAdd(cnt + count_slot(r.z, j), 1);
            atomicAdd(cnt + count_slot(r.w, j), 1);
          }
        } else {
#pragma unroll 4
          for (int e = warp * 8 + il; e < E; e += kWarps * 8) {
            atomicAdd(cnt + count_slot(__ldg(cc + e), j), 1);
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < R8 * kItemChunks; i += kReduceThreads) {
      cnt[i] = __float_as_int(static_cast<float>(cnt[i]));
    }
    __syncthreads();
    int nqp = 1;
    while (nqp < nq) nqp <<= 1;
    const int shift = __ffs(nqp) - 1;
    const int quad = lr & (nqp - 1), off = lr >> shift;
    const int rstep = 8 >> shift;
    const float* cntf = reinterpret_cast<const float*>(cnt);
    const int mtiles = (nc + 15) >> 4;  // MMA: 16 chunks a tile
    for (int p = 0; p < P; ++p) {
      const int u = li * P + p;
      const __nv_bfloat16* part =
          reinterpret_cast<const __nv_bfloat16*>(smem + (u & 1) * stage_bytes);
      float acc[4][8];  // FMA: [quad chunk][column]; MMA: [tile][fragment]
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[a][k] = 0.0f;
      }
      mbar_wait(&bar[u & 1], (u >> 1) & 1);
      if constexpr (MMA) {
        // warp w takes the 8-row steps w, w + 8, ...; tile (mt, nt) of
        // chunks 16 mt .. and columns 8 nt .. sits in acc[2 mt + nt / 2]
        const unsigned short* bits =
            reinterpret_cast<const unsigned short*>(part);
        const int g = lane >> 2, t4 = lane & 3;
        for (int r0 = warp * 8; r0 < R; r0 += kWarps * 8) {
          const int ra = r0 + t4, rb = ra + 4;
          uint32_t fa[2][4], fb[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int j0 = mt * 16 + g;
            fa[mt][0] = static_cast<uint32_t>(cnt[count_slot(ra, j0)]);
            fa[mt][1] = static_cast<uint32_t>(cnt[count_slot(ra, j0 + 8)]);
            fa[mt][2] = static_cast<uint32_t>(cnt[count_slot(rb, j0)]);
            fa[mt][3] = static_cast<uint32_t>(cnt[count_slot(rb, j0 + 8)]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = min(nt * 8 + g, PW - 1);
            fb[nt][0] =
                ra < R ? static_cast<uint32_t>(bits[ra * PW + col]) << 16 : 0u;
            fb[nt][1] =
                rb < R ? static_cast<uint32_t>(bits[rb * PW + col]) << 16 : 0u;
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mtiles) break;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (nt * 8 >= PW) break;
              float(&c)[8] = acc[2 * mt + (nt >> 1)];
              const int h = 4 * (nt & 1);
              asm volatile(
                  "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                  "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                  "{%0, %1, %2, %3};\n"
                  : "+f"(c[h]), "+f"(c[h + 1]), "+f"(c[h + 2]),
                    "+f"(c[h + 3])
                  : "r"(fa[mt][0]), "r"(fa[mt][1]), "r"(fa[mt][2]),
                    "r"(fa[mt][3]), "r"(fb[nt][0]), "r"(fb[nt][1]));
            }
          }
        }
      } else if (live) {
#pragma unroll 4
        for (int r = r_lo + off; r < r_hi; r += rstep) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(part + r * PW + lc * 8);
          const float4 c = *reinterpret_cast<const float4*>(
              cntf + r * kItemChunks + 4 * (quad ^ (r & 7)));
          const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
          float xv[8];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            xv[2 * h] = __uint_as_float(wd[h] << 16);
            xv[2 * h + 1] = __uint_as_float(wd[h] & 0xffff0000u);
          }
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc[a][k] = fmaf(cv[a], xv[k], acc[a][k]);
            }
          }
        }
      }
      float* mine = red + (warp * 32 + lane) * kRedStride;
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e] = acc[e >> 3][e & 7];
      __syncthreads();  // the buffer may be refilled; red holds every warp's
      if (tid == 0 && u + 2 < nunits) issue(u + 2, li);
      if (tid < kItemChunks * 4) {  // chunk j, columns 8 c4 .. of the part
        const int j = MMA ? (tid & 31) : (tid >> 2);
        const int c4 = MMA ? (tid >> 5) : (tid & 3);
        const int k = p * PW + c4 * 8;
        if (j < nc && c4 * 8 < PW && k < K) {
          float sum[8];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) sum[kk] = 0.0f;
          if constexpr (MMA) {
            // lane 4 (j % 8) + t4 holds columns 2 t4, 2 t4 + 1 of chunk j
            // (and of j + 8) in tile (j / 16, c4): entries 2 (j % 16 / 8) ..
            const int e0 = ((j >> 4) * 4 + c4) * 4 + ((j >> 3) & 1) * 2;
            for (int w = 0; w < kWarps; ++w) {
#pragma unroll
              for (int t4 = 0; t4 < 4; ++t4) {
                const float* src =
                    red + (w * 32 + (j & 7) * 4 + t4) * kRedStride + e0;
                sum[2 * t4] += src[0];
                sum[2 * t4 + 1] += src[1];
              }
            }
          } else {
            for (int w = 0; w < kWarps; ++w) {
              for (int m = 0; m < rstep; ++m) {
                const float* src =
                    red + (w * 32 + ((m * nqp + (j >> 2)) << 2) + c4) *
                              kRedStride + (j & 3) * 8;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) sum[kk] += src[kk];
              }
            }
          }
          __nv_bfloat16* o =
              out + static_cast<long long>(ch[j]) * 8 * K + k;
#pragma unroll
          for (int row = 0; row < 8; ++row) {
            store_vec<__nv_bfloat16, 8>(o + static_cast<long long>(row) * K,
                                        sum);
          }
        }
      }
      __syncthreads();  // red, and after the last part cnt and ch, are free
    }
    if (tid == 0) {
      row0 = row1;
      row1 = row2;
      row2 = slice_row(li + 3);
    }
  }
}

// Shared memory of slice_reduce: two buffers of a part, the counts, the
// warps' sums (dynamic), beside the barriers and chunk ids (static), within
// a block's 227 KB. The wrapper mirrors this (probes_cuda._slice_reduce_smem).
constexpr long long kBlockSmem = 232448;
constexpr long long kSliceReduceStatic = 1024;
struct SliceReduceShape {
  int PW, box_rows, nbox, stage_bytes;
  long long smem;
};

// The widest part of at most kPartCols columns (then 16, then 8) whose two
// buffers fit beside the counts.
SliceReduceShape slice_reduce_shape(int R, int K) {
  SliceReduceShape s;
  s.nbox = (R + kBoxRows - 1) / kBoxRows;
  s.box_rows = ((R + s.nbox - 1) / s.nbox + 7) / 8 * 8;
  for (s.PW = K < kPartCols ? K : kPartCols;; s.PW = s.PW > 16 ? 16 : 8) {
    s.stage_bytes = (s.nbox * s.box_rows * s.PW * 2 + 127) / 128 * 128;
    s.smem = 128 + 2LL * s.stage_bytes +
             static_cast<long long>((R + 7) & ~7) * kItemChunks * 4 +
             kReduceThreads * kRedStride * 4;
    if (s.PW == 8 || s.smem + kSliceReduceStatic <= kBlockSmem) return s;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0: the launch was accepted), or
// cudaErrorInvalidValue for a shape the kernel does not take.

// o = 2 x over n floats; the float4 loop runs when both are 16-byte aligned.
extern "C" int psp_scale2(const void* x, void* out, long long n,
                          void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long n4 = vec ? n / 4 : 0;
  long long blocks = ((n4 > 0 ? n4 : n) + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  scale2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}

// T tiles of EK = E * K floats (a multiple of 4; src 16-byte aligned);
// depth 1 or 2.
extern "C" int psp_chunk_sum(const void* ptr, const void* src, void* out,
                             long long T, long long EK, int depth,
                             void* stream) {
  if (EK % 4 != 0 || (depth != 1 && depth != 2) || T > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((EK + kChunkBlock - 1) / kChunkBlock),
                  static_cast<unsigned>(T));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  if (depth == 1) {
    chunk_sum_kernel<1><<<grid, kThreads, 0, cs>>>(p, s, o, EK);
  } else {
    chunk_sum_kernel<2><<<grid, kThreads, 0, cs>>>(p, s, o, EK);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of workspace that psp_span_plan (span 1: 2 n endpoints) or
// psp_slice_plan (span 0: n chunks) needs for keys below 2**end_bit, from
// CUB's own size queries (no device work).
extern "C" long long psp_plan_ws_bytes(int span, long long n,
                                       long long end_bit) {
  const int m = static_cast<int>(span ? 2 * n : n);
  return static_cast<long long>(
      plan_ws_bytes(m, span ? kSpanPlanArrays : kSlicePlanArrays,
                    static_cast<int>(end_bit)));
}

// The piece plan of the n spans [e0[i], e0[i] + cap), endpoints below
// 2**end_bit, into prow / plen (at least probes_cuda.span_piece_bound
// entries; those from *total on are left as they were), total, first and
// last (n each), from ws_bytes of workspace (probes_cuda._plan_ws_bytes);
// cudaErrorMemoryAllocation when the workspace is too small.
extern "C" int psp_span_plan(const void* e0, long long n, long long cap,
                             long long end_bit, void* prow, void* plen,
                             void* total, void* first, void* last, void* ws,
                             long long ws_bytes, void* stream) {
  if (n <= 0) return 0;
  return span_plan(static_cast<const int*>(e0), static_cast<int>(n),
                   static_cast<int>(cap), static_cast<int>(end_bit),
                   static_cast<int*>(prow), static_cast<int*>(plen),
                   static_cast<int*>(total), static_cast<int*>(first),
                   static_cast<int*>(last), ws, static_cast<size_t>(ws_bytes),
                   static_cast<cudaStream_t>(stream));
}

// The item plan of n chunks on slices fs below 2**end_bit: order, sf (n
// each), istart (n + 1), n_items (1), from ws_bytes of workspace.
extern "C" int psp_slice_plan(const void* fs, long long n, long long end_bit,
                              void* order, void* sf, void* istart,
                              void* n_items, void* ws, long long ws_bytes,
                              void* stream) {
  if (n <= 0) return 0;
  return slice_plan(static_cast<const int*>(fs), static_cast<int>(n),
                    static_cast<int>(end_bit), static_cast<int*>(order),
                    static_cast<int*>(sf), static_cast<int*>(istart),
                    static_cast<int*>(n_items), ws,
                    static_cast<size_t>(ws_bytes),
                    static_cast<cudaStream_t>(stream));
}

// steps x (K,) f32 column sums of NS spans of CAP rows of the bf16 (L, K)
// stream, each step's own spans staged by one CTA; K / 8 a power of two up
// to 256.
extern "C" int psp_span_colsum_staged(const void* src, const void* e0,
                                      void* out, long long steps,
                                      long long NS, long long CAP,
                                      long long K, void* stream) {
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
  const int* e = static_cast<const int*>(e0);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(NS), cap = static_cast<int>(CAP);
  switch (K) {
    case 8: return launch_span_colsum_staged<1>(s, e, o, steps, ns, cap, cs);
    case 16: return launch_span_colsum_staged<2>(s, e, o, steps, ns, cap, cs);
    case 32: return launch_span_colsum_staged<4>(s, e, o, steps, ns, cap, cs);
    case 64: return launch_span_colsum_staged<8>(s, e, o, steps, ns, cap, cs);
    case 128:
      return launch_span_colsum_staged<16>(s, e, o, steps, ns, cap, cs);
    case 256:
      return launch_span_colsum_staged<32>(s, e, o, steps, ns, cap, cs);
    case 512:
      return launch_span_colsum_staged<64>(s, e, o, steps, ns, cap, cs);
    case 1024:
      return launch_span_colsum_staged<128>(s, e, o, steps, ns, cap, cs);
    case 2048:
      return launch_span_colsum_staged<256>(s, e, o, steps, ns, cap, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same sums from the piece plan (probes_cuda.span_pieces): *ptotal
// pieces (prow, plen; at most npieces_max) of the bf16 (L, K) stream summed
// once into psum (npieces_max, K) f32, then step t's spans t * NS + s, pieces
// [first, last), added into out (steps, K) f32; K / 8 a power of two up to
// 256.
extern "C" int psp_span_colsum(const void* src, const void* prow,
                               const void* plen, const void* ptotal,
                               long long npieces_max, const void* first,
                               const void* last, void* psum, void* out,
                               long long steps, long long NS, long long K,
                               void* stream) {
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
  const int* pr = static_cast<const int*>(prow);
  const int* pl = static_cast<const int*>(plen);
  const int* pt = static_cast<const int*>(ptotal);
  const int* f = static_cast<const int*>(first);
  const int* l = static_cast<const int*>(last);
  float* ps = static_cast<float*>(psum);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(NS);
  const long long np = npieces_max;
#define PSP_SPAN_COLSUM(VR)                                                \
  return launch_span_colsum<VR>(s, pr, pl, pt, np, f, l, ps, o, steps, ns, \
                                cs)
  switch (K) {
    case 8: PSP_SPAN_COLSUM(1);
    case 16: PSP_SPAN_COLSUM(2);
    case 32: PSP_SPAN_COLSUM(4);
    case 64: PSP_SPAN_COLSUM(8);
    case 128: PSP_SPAN_COLSUM(16);
    case 256: PSP_SPAN_COLSUM(32);
    case 512: PSP_SPAN_COLSUM(64);
    case 1024: PSP_SPAN_COLSUM(128);
    case 2048: PSP_SPAN_COLSUM(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PSP_SPAN_COLSUM
}

// mode 0 nodot, 1 nosel (colsum: the chunks' (nchunks, K) f32 column sums),
// 2 empty; ntiles tiles of 128 rows of the (BR_pad, K) f32 output band.
extern "C" int psp_band_ablate(int mode, const void* tile_ptr,
                               const void* visit_chunk, const void* chunk_span,
                               const void* bst, const void* ben,
                               long long BR_pad, const void* src,
                               const void* colsum, void* out,
                               long long ntiles, long long K, long long E,
                               void* stream) {
  if (K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* vc = static_cast<const int*>(visit_chunk);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
  const float* cs_ = static_cast<const float*>(colsum);
  float* o = static_cast<float*>(out);
  const int k = static_cast<int>(K), e = static_cast<int>(E);
  if (mode == kModeNodot) {
    const long long tile_units = kBandRows * K / 4;
    const long long units = ntiles * tile_units;
    long long grid = static_cast<long long>(kNodotCtasPerSm) * sm_count();
    if (grid > units / kThreads) grid = units / kThreads;  // a unit a thread
    if (grid < 1) grid = 1;
    band_nodot_kernel<<<static_cast<unsigned>(grid), kThreads, 0, cs>>>(
        tp, vc, static_cast<const int*>(chunk_span),
        static_cast<const int*>(bst), static_cast<const int*>(ben), BR_pad, o,
        tile_units, units, e);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(ntiles),
                  static_cast<unsigned>((K + kBandCols - 1) / kBandCols));
  if (mode == kModeNosel) {
    band_ablate_kernel<kModeNosel><<<grid, kThreads, 0, cs>>>(tp, vc, s, cs_,
                                                              o, k, e);
  } else if (mode == kModeEmpty) {
    band_ablate_kernel<kModeEmpty><<<grid, kThreads, 0, cs>>>(tp, vc, s, cs_,
                                                              o, k, e);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Each of the nch chunks' E rows of its R-row slice of the bf16 (N, K) x:
// (nch * E, K), one CTA per (chunk, 128 columns) (K a multiple of 8; a
// 128-column slice part and the E indices within 200 KB).
extern "C" int psp_slice_gather(const void* fs, const void* cols,
                                const void* x, void* out, long long nch,
                                long long R, long long E, long long K,
                                void* stream) {
  const long long smem = R * kSliceCols * 2 + E * 4;  // slice part, indices
  if (K % 8 != 0 || smem > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      slice_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nch),
                  static_cast<unsigned>((K + kSliceCols - 1) / kSliceCols));
  slice_gather_kernel<<<grid, kThreads, static_cast<int>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(fs), static_cast<const int*>(cols),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(R), static_cast<int>(E), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

// The chunks' sums over R-row slices of the bf16 (N, K) x (K a multiple of
// 8, N < 2**31), rounded to bf16 as 8 equal rows: (nch * 8, K), from the item
// plan (probes_cuda.slice_items: order, sf = fs[order], istart, n_items, at
// most nch items). Returns cudaErrorInvalidValue when the shared memory
// exceeds a block's 227 KB, -1 when cuTensorMapEncodeTiled cannot be found,
// -1000 - r when it refuses the tensor map with CUresult r.
extern "C" int psp_slice_reduce(const void* order, const void* sf,
                                const void* istart, const void* n_items,
                                const void* cols, const void* x, void* out,
                                long long nch, long long N, long long R,
                                long long E, long long K, void* stream) {
  const SliceReduceShape sh =
      slice_reduce_shape(static_cast<int>(R), static_cast<int>(K));
  if (K % 8 != 0 || sh.smem + kSliceReduceStatic > kBlockSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(sh.PW),
                             static_cast<cuuint32_t>(sh.box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -1000 - static_cast<int>(res);
  const int smem = static_cast<int>(sh.smem);
  // counts up to 2,048 and bf16 values are exact in TF32: the tensor cores
  // sum them; past E = 2,048 a count may not be, so the CUDA cores do
  auto kernel = E <= 2048 ? slice_reduce_kernel<true>
                          : slice_reduce_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = sm_count();  // one CTA an SM, persistent
  if (grid > nch) grid = nch;
  if (grid < 1) return 0;
  kernel<<<static_cast<unsigned>(grid), kReduceThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int*>(order), static_cast<const int*>(sf),
      static_cast<const int*>(istart), static_cast<const int*>(n_items),
      static_cast<const int*>(cols), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(R), static_cast<int>(E), static_cast<int>(K), sh.PW,
      sh.box_rows, sh.nbox, sh.stage_bytes);
  return static_cast<int>(cudaGetLastError());
}
