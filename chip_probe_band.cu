// P4 nodot (band_ablate mode 0, experiments/r4_band_cost.py:181 k_nodot) as
// paddle_sparse_tpu_torch/csrc/probes.cu ran it before its redesign, in
// stages, beside fills of the same (BR_pad, K) f32 output. Only `python3
// chip_probe.py band` builds and runs this file, for its breakdown of the
// kernel's time. It is no part of the package.
//
// Former kernel: grid (tiles, 64-column blocks) of 256 threads; every
// thread walks its tile's visits one after another (visit_chunk[i] ->
// chunk_span[c] -> bst/ben at the tile's first row: three dependent loads a
// visit) and then stores its 4 x 8 values of the tile.
//   stage 0 whole: the kernel as it was;
//   stage 1 walk:  the walk, and a store only where the count equals
//                  `value` (a sentinel no input reaches: counts are >= 0);
//   stage 2 fill:  the same grid stores `value`, with no walk.
// Fills of the whole output with `value`, its 16-byte units cut into
// `grid` equal contiguous ranges, one a CTA (within one unit):
//   stage 3 fill_v4:   st.global.cs.v4 (streaming), coalesced;
//   stage 4 fill_bulk: one thread issues bulk stores (cp.async.bulk) of a
//                      16 KB shared buffer holding `value`.
// Stage 5 counts: each tile's count as the package's nodot takes it, from
// one round of loads, one warp a tile and a lane for each of up to 64
// visits, summed in f32 in ascending chunk order from shuffles; written to
// out[tile] alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paddle_sparse_tpu_torch/csrc/tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 128;  // rows of an output tile (the TPU's R)
constexpr int kBandCols = 64;   // columns of a CTA: 8 lanes of 8 values
constexpr int kBulkBytes = 16384;

constexpr int kStageWhole = 0;
constexpr int kStageWalk = 1;
constexpr int kStageFill = 2;
constexpr int kStageFillV4 = 3;
constexpr int kStageFillBulk = 4;
constexpr int kStageCounts = 5;

template <int STAGE>
__global__ void __launch_bounds__(kThreads)
former_nodot_kernel(const int* __restrict__ tile_ptr,
                    const int* __restrict__ visit_chunk,
                    const int* __restrict__ chunk_span,
                    const int* __restrict__ bst, const int* __restrict__ ben,
                    long long BR_pad, float* __restrict__ out, int K, int E,
                    float value) {
  const int tile = blockIdx.x;
  const int col = blockIdx.y * kBandCols + (threadIdx.x & 7) * 8;
  const int rl = threadIdx.x >> 3;
  float* o = out + static_cast<long long>(tile) * kBandRows * K;
  if (col >= K) return;
  float acc = value;
  if (STAGE != kStageFill) {
    const int v0 = __ldg(tile_ptr + tile), v1 = __ldg(tile_ptr + tile + 1);
    acc = 0.0f;
    for (int i = v0; i < v1; ++i) {
      const long long c = __ldg(visit_chunk + i);
      const long long b =
          static_cast<long long>(__ldg(chunk_span + c)) * BR_pad +
          static_cast<long long>(tile) * kBandRows;
      const long long lo = max(static_cast<long long>(__ldg(bst + b)), c * E);
      const long long hi =
          min(static_cast<long long>(__ldg(ben + b)), (c + 1) * E);
      acc += static_cast<float>(hi > lo ? hi - lo : 0);
    }
    if (STAGE == kStageWalk && acc != value) return;
  }
  const float4 w = make_float4(acc, acc, acc, acc);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4* p =
        reinterpret_cast<float4*>(o + static_cast<long long>(rl + 32 * q) * K +
                                  col);
    p[0] = w;
    p[1] = w;
  }
}

// CTA b's share of `units` 16-byte units: [units b / G, units (b + 1) / G).
__device__ __forceinline__ void even_share(long long units, long long& u0,
                                           long long& u1) {
  const long long G = gridDim.x, b = blockIdx.x;
  u0 = units * b / G;
  u1 = units * (b + 1) / G;
}

__global__ void __launch_bounds__(kThreads)
fill_v4_kernel(float* __restrict__ out, long long units, float value) {
  long long u0, u1;
  even_share(units, u0, u1);
  float4* o = reinterpret_cast<float4*>(out);
  const float4 w = make_float4(value, value, value, value);
  for (long long u = u0 + threadIdx.x; u < u1; u += kThreads) __stcs(o + u, w);
}

__global__ void __launch_bounds__(kThreads)
fill_bulk_kernel(float* __restrict__ out, long long units, float value) {
  __shared__ __align__(128) float4 buf[kBulkBytes / 16];
  long long u0, u1;
  even_share(units, u0, u1);
  const float4 w = make_float4(value, value, value, value);
  for (int i = threadIdx.x; i < kBulkBytes / 16; i += kThreads) buf[i] = w;
  psp::fence_proxy_async_shared();
  __syncthreads();
  if (threadIdx.x != 0) return;
  char* o = reinterpret_cast<char*>(out);
  for (long long p = u0 * 16; p < u1 * 16; p += kBulkBytes) {
    const long long n = u1 * 16 - p < kBulkBytes ? u1 * 16 - p : kBulkBytes;
    psp::bulk_store(o + p, buf, static_cast<uint32_t>(n));
  }
  psp::bulk_commit_and_wait_read();
}

// The package's band_visit_overlap and band_tile_count (csrc/probes.cu).
__device__ __forceinline__ float visit_overlap(
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

__global__ void __launch_bounds__(kThreads)
counts_kernel(const int* __restrict__ tile_ptr,
              const int* __restrict__ visit_chunk,
              const int* __restrict__ chunk_span,
              const int* __restrict__ bst, const int* __restrict__ ben,
              long long BR_pad, float* __restrict__ out, long long ntiles,
              int E) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (tile >= ntiles) return;
  const int lane = threadIdx.x & 31;
  const int v0 = __ldg(tile_ptr + tile), v1 = __ldg(tile_ptr + tile + 1);
  float acc = 0.0f;
  for (int base = v0; base < v1; base += 64) {
    const float n0 = visit_overlap(base + lane, v1, tile, visit_chunk,
                                   chunk_span, bst, ben, BR_pad, E);
    const float n1 = visit_overlap(base + 32 + lane, v1, tile, visit_chunk,
                                   chunk_span, bst, ben, BR_pad, E);
    const int m = v1 - base;
    for (int j = 0; j < 32 && j < m; ++j) {
      acc += __shfl_sync(0xffffffffu, n0, j);
    }
    for (int j = 0; j < 32 && j < m - 32; ++j) {
      acc += __shfl_sync(0xffffffffu, n1, j);
    }
  }
  if (lane == 0) out[tile] = acc;
}

template <int STAGE>
int launch_former(const int* tp, const int* vc, const int* sp, const int* bs,
                  const int* be, long long BR_pad, float* o, long long ntiles,
                  int K, int E, float value, cudaStream_t cs) {
  const dim3 grid(static_cast<unsigned>(ntiles),
                  static_cast<unsigned>((K + kBandCols - 1) / kBandCols));
  former_nodot_kernel<STAGE><<<grid, kThreads, 0, cs>>>(tp, vc, sp, bs, be,
                                                        BR_pad, o, K, E, value);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stage `stage` (0-5, above) on the schedule's visits (tile_ptr, visit_chunk)
// and the (S * BR_pad) bounds, ntiles tiles of 128 rows of the (BR_pad, K)
// f32 out (K a multiple of 8); `grid` CTAs for stages 3 and 4.
extern "C" int psp_band_stages(int stage, long long grid, const void* tile_ptr,
                               const void* visit_chunk,
                               const void* chunk_span, const void* bst,
                               const void* ben, long long BR_pad, void* out,
                               long long ntiles, long long K, long long E,
                               float value, void* stream) {
  if (K % 8 != 0 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* vc = static_cast<const int*>(visit_chunk);
  const int* sp = static_cast<const int*>(chunk_span);
  const int* bs = static_cast<const int*>(bst);
  const int* be = static_cast<const int*>(ben);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(K), e = static_cast<int>(E);
  const long long units = ntiles * kBandRows * K / 4;
  switch (stage) {
    case kStageWhole:
      return launch_former<kStageWhole>(tp, vc, sp, bs, be, BR_pad, o, ntiles,
                                        k, e, value, cs);
    case kStageWalk:
      return launch_former<kStageWalk>(tp, vc, sp, bs, be, BR_pad, o, ntiles,
                                       k, e, value, cs);
    case kStageFill:
      return launch_former<kStageFill>(tp, vc, sp, bs, be, BR_pad, o, ntiles,
                                       k, e, value, cs);
    case kStageFillV4:
      fill_v4_kernel<<<static_cast<unsigned>(grid), kThreads, 0, cs>>>(
          o, units, value);
      return static_cast<int>(cudaGetLastError());
    case kStageFillBulk:
      fill_bulk_kernel<<<static_cast<unsigned>(grid), kThreads, 0, cs>>>(
          o, units, value);
      return static_cast<int>(cudaGetLastError());
    case kStageCounts:
      counts_kernel<<<static_cast<unsigned>((ntiles + 7) / 8), kThreads, 0,
                      cs>>>(tp, vc, sp, bs, be, BR_pad, o, ntiles, e);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
