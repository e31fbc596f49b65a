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
//   seed[r] * colsum_t[k]. Here one CTA per step streams its spans in 16 KB
//   sub-chunks through a 4-deep ring of bulk async copies and sums each
//   column in f32 registers; every step's (K,) sum goes to a (steps, K) f32
//   buffer, from which the wrapper takes the probe's output. Bound by the
//   staged bytes (NS * CAP * K * 2 a step); each copy's issue cost is the
//   probe's question. It also takes each chunk's column sum for band_ablate's
//   "nosel" (NS = 1, CAP = E, e0 = c * E).
// - band_ablate<nodot|nosel|empty> (experiments/r4_band_cost.py:181 k_nodot,
//   :201 k_nosel, :217 k_empty; pallas_call :131 in make_call): the cost
//   bisect of K4. Chunk c of E stream rows visits output tiles row0_c / 128
//   + j for j < nj_c (at most TMAX) and adds to each: nodot the edge count of
//   the tile's row 0 bounds within the chunk, to every entry; nosel the
//   chunk's column sum, to every row; empty the chunk's first 128 rows. The
//   TPU walks chunks in order with the band resident in VMEM; here one CTA
//   owns one tile and 64 columns and walks the tile's visits, sorted on the
//   device into ascending c (the TPU grid's order), so no atomics and the
//   same sum order. (k_full and k_untrans are K4's function, on K4's port.)
// - slice_gather<write|reduce> (experiments/r5_vmem_expand.py:56 kernel,
//   pallas_call :85 in make_call): chunk c's E edges gather rows of one
//   R-row slice of x, x[fs[c] * R + cols[c * E + e]]; "write" writes each
//   gathered row (an exact copy), "reduce" writes the f32 sum over the
//   chunk, rounded to bf16 once, as 8 equal rows. The probe's question is
//   whether a gather served from an on-chip slice beats one global gather
//   per edge. A 512 x 256 bf16 slice is 256 KB, over a block's 227 KB, so
//   one CTA per (chunk, 128 columns) loads its 128 KB part of the slice into
//   shared memory (one 256-byte bulk copy per slice row, all on one
//   mbarrier), and the chunk's column indices beside it, and serves every
//   edge's row from there. Bound by the bytes written (write) or by the
//   slice loads (reduce).
//
// Contract (the Python wrapper, ops/kernels/probes_cuda.py, checks shapes,
// dtypes, devices, contiguity and 16-byte alignment): ptr is non-decreasing
// with ptr[T] * E rows in src; every span [e0, e0 + CAP) lies in the stream;
// every visited chunk lies in the stream and every tile in the band; fs[c]
// indexes a whole slice of x and cols lie in [0, R). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_load.cuh"

namespace {

using psp::load_vec;
using psp::store_vec;

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

// VR: 16-byte vectors per stream row (K / 8), a power of two up to 256.
// Thread tid sums vector tid % VR of rows tid / VR, tid / VR + 256 / VR, ...
template <int VR>
__global__ void __launch_bounds__(kThreads)
span_colsum_kernel(const __nv_bfloat16* __restrict__ stream,
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
int launch_span_colsum(const __nv_bfloat16* stream, const int* e0,
                       float* out, long long steps, int NS, int CAP,
                       cudaStream_t cs) {
  const int smem = kStages * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      span_colsum_kernel<VR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  span_colsum_kernel<VR><<<static_cast<unsigned>(steps), kThreads, smem, cs>>>(
      stream, e0, out, NS, CAP);
  return static_cast<int>(cudaGetLastError());
}

// ---- band_ablate -----------------------------------------------------------

constexpr int kModeNodot = 0;
constexpr int kModeNosel = 1;
constexpr int kModeEmpty = 2;
constexpr int kBandRows = 128;  // rows of an output tile (the TPU's R)
constexpr int kBandCols = 64;   // columns of a CTA: 8 lanes of 8 values

// Grid (tiles, column blocks). Thread tid holds column vector tid % 8 of
// rows tid / 8 + 32 q, q < 4. Visits i in [tile_ptr[tile], tile_ptr[tile+1])
// name the chunks that visit the tile, in ascending order.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
band_ablate_kernel(const int* __restrict__ tile_ptr,
                   const int* __restrict__ visit_chunk,
                   const int* __restrict__ chunk_span,
                   const int* __restrict__ bst, const int* __restrict__ ben,
                   long long BR_pad, const __nv_bfloat16* __restrict__ stream,
                   const float* __restrict__ colsum, float* __restrict__ out,
                   int K, int E) {
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
    } else if constexpr (MODE == kModeNosel) {
      float f[4], g[4];
      load_vec<float, 4>(colsum + c * K + col, f);
      load_vec<float, 4>(colsum + c * K + col + 4, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] += f[j];
        acc[0][j + 4] += g[j];
      }
    } else {
      const long long b =
          static_cast<long long>(__ldg(chunk_span + c)) * BR_pad +
          static_cast<long long>(tile) * kBandRows;
      const long long lo = max(static_cast<long long>(__ldg(bst + b)), c * E);
      const long long hi =
          min(static_cast<long long>(__ldg(ben + b)), (c + 1) * E);
      acc[0][0] += static_cast<float>(hi > lo ? hi - lo : 0);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = MODE == kModeEmpty   ? acc[q][j]
             : MODE == kModeNosel ? acc[0][j]
                                  : acc[0][0];
    }
    store_vec<float, 8>(o + static_cast<long long>(rl + 32 * q) * K + col, w);
  }
}

// ---- slice_gather ----------------------------------------------------------

constexpr int kSliceCols = 128;  // columns of x per CTA: 256-byte rows
constexpr int kSliceLanes = kSliceCols / 8;       // 16 vectors of a row
constexpr int kEdgeLanes = kThreads / kSliceLanes;  // 16 edges at a time

// Grid (chunks, column parts). The part's R x W slice lands in shared memory
// through R bulk copies on one barrier, and the chunk's E column indices
// beside it (read once, so the edge loop waits on no global load); thread
// tid serves vector tid % 16 of edges tid / 16, tid / 16 + 16, ...
template <bool REDUCE>
__global__ void __launch_bounds__(kThreads)
slice_gather_kernel(const int* __restrict__ fs, const int* __restrict__ cols,
                    const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ out, int R, int E, int K) {
  extern __shared__ __align__(128) unsigned char slice_raw[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[kEdgeLanes][kSliceCols];
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
  const bool live = v * 8 < W;
  if constexpr (!REDUCE) {
    __nv_bfloat16* oc = out + c * E * K + k0 + v * 8;
#pragma unroll 4
    for (int e = el; e < E; e += kEdgeLanes) {
      const int r = ccols[e];
      if (live) {
        *reinterpret_cast<uint4*>(oc + static_cast<long long>(e) * K) =
            *reinterpret_cast<const uint4*>(slice + r * W + v * 8);
      }
    }
  } else {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int e = el; e < E; e += kEdgeLanes) {
      const int r = ccols[e];
      if (live) {
        const uint4 u = *reinterpret_cast<const uint4*>(slice + r * W + v * 8);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(h[q]);
          acc[2 * q] += f.x;
          acc[2 * q + 1] += f.y;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) red[el][v * 8 + q] = acc[q];
    __syncthreads();
    for (int k = tid; k < W * 8; k += kThreads) {  // 8 rows of W columns
      const int col = k % W;
      float s = 0.0f;
      for (int l = 0; l < kEdgeLanes; ++l) s += red[l][col];
      out[(c * 8 + k / W) * K + k0 + col] = __float2bfloat16_rn(s);
    }
  }
}

template <bool REDUCE>
int launch_slice_gather(const int* fs, const int* cols,
                        const __nv_bfloat16* x, __nv_bfloat16* out,
                        long long nch, int R, int E, int K,
                        cudaStream_t cs) {
  const int smem = R * kSliceCols * 2 + E * 4;  // slice part, indices
  const cudaError_t err = cudaFuncSetAttribute(
      slice_gather_kernel<REDUCE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nch),
                  static_cast<unsigned>((K + kSliceCols - 1) / kSliceCols));
  slice_gather_kernel<REDUCE><<<grid, kThreads, smem, cs>>>(fs, cols, x, out,
                                                            R, E, K);
  return static_cast<int>(cudaGetLastError());
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

// steps x (K,) f32 column sums of NS spans of CAP rows of the bf16 (L, K)
// stream; K / 8 a power of two up to 256.
extern "C" int psp_span_colsum(const void* src, const void* e0, void* out,
                               long long steps, long long NS, long long CAP,
                               long long K, void* stream) {
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
  const int* e = static_cast<const int*>(e0);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(NS), cap = static_cast<int>(CAP);
  switch (K) {
    case 8: return launch_span_colsum<1>(s, e, o, steps, ns, cap, cs);
    case 16: return launch_span_colsum<2>(s, e, o, steps, ns, cap, cs);
    case 32: return launch_span_colsum<4>(s, e, o, steps, ns, cap, cs);
    case 64: return launch_span_colsum<8>(s, e, o, steps, ns, cap, cs);
    case 128: return launch_span_colsum<16>(s, e, o, steps, ns, cap, cs);
    case 256: return launch_span_colsum<32>(s, e, o, steps, ns, cap, cs);
    case 512: return launch_span_colsum<64>(s, e, o, steps, ns, cap, cs);
    case 1024: return launch_span_colsum<128>(s, e, o, steps, ns, cap, cs);
    case 2048: return launch_span_colsum<256>(s, e, o, steps, ns, cap, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const dim3 grid(static_cast<unsigned>(ntiles),
                  static_cast<unsigned>((K + kBandCols - 1) / kBandCols));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* vc = static_cast<const int*>(visit_chunk);
  const int* sp = static_cast<const int*>(chunk_span);
  const int* bs = static_cast<const int*>(bst);
  const int* be = static_cast<const int*>(ben);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
  const float* cs_ = static_cast<const float*>(colsum);
  float* o = static_cast<float*>(out);
  const int k = static_cast<int>(K), e = static_cast<int>(E);
  if (mode == kModeNodot) {
    band_ablate_kernel<kModeNodot><<<grid, kThreads, 0, cs>>>(
        tp, vc, sp, bs, be, BR_pad, s, cs_, o, k, e);
  } else if (mode == kModeNosel) {
    band_ablate_kernel<kModeNosel><<<grid, kThreads, 0, cs>>>(
        tp, vc, sp, bs, be, BR_pad, s, cs_, o, k, e);
  } else if (mode == kModeEmpty) {
    band_ablate_kernel<kModeEmpty><<<grid, kThreads, 0, cs>>>(
        tp, vc, sp, bs, be, BR_pad, s, cs_, o, k, e);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// nch chunks of E edges over R-row slices of the bf16 (N, K) x (K a
// multiple of 8; a 128-column slice part and E indices within 200 KB);
// reduce 0 writes (nch * E, K), 1 writes (nch * 8, K).
extern "C" int psp_slice_gather(int reduce, const void* fs, const void* cols,
                                const void* x, void* out, long long nch,
                                long long R, long long E, long long K,
                                void* stream) {
  if (K % 8 != 0 || R * kSliceCols * 2 + E * 4 > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* f = static_cast<const int*>(fs);
  const int* c = static_cast<const int*>(cols);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(R), e = static_cast<int>(E),
            k = static_cast<int>(K);
  return reduce ? launch_slice_gather<true>(f, c, xp, o, nch, r, e, k, cs)
                : launch_slice_gather<false>(f, c, xp, o, nch, r, e, k, cs);
}
