// The per-chunk P5 kernel (slice_gather, experiments/r5_vmem_expand.py:56)
// as paddle_sparse_tpu_torch/csrc/probes.cu had it before its reduce was
// redesigned, with diagnostic copies that leave out a part of it. Only
// `python3 chip_probe.py slice` builds and runs this file, for its
// breakdown of the per-CTA time: the slice load alone, the edge loop alone,
// each variant whole. It is no part of the package.
//
// One CTA per (chunk, 128 columns) loads its part of the chunk's R-row
// slice of x into shared memory (one 256-byte bulk copy per slice row, all
// on one mbarrier), and the chunk's column indices beside it, and serves
// every edge's row from there: "write" writes each row, "reduce" the f32
// sum over the chunk, rounded to bf16 once, as 8 equal rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

constexpr int kSliceCols = 128;  // columns of x per CTA: 256-byte rows
constexpr int kSliceLanes = kSliceCols / 8;       // 16 vectors of a row
constexpr int kEdgeLanes = kThreads / kSliceLanes;  // 16 edges at a time
constexpr int kStageFull = 0;    // the slice load, then the edge loop
constexpr int kStageLoad = 1;    // the slice load and the indices alone
constexpr int kStageLoop = 2;    // the indices and the edge loop alone

// Grid (chunks, column parts). The part's R x W slice lands in shared memory
// through R bulk copies on one barrier, and the chunk's E column indices
// beside it (read once, so the edge loop waits on no global load); thread
// tid serves vector tid % 16 of edges tid / 16, tid / 16 + 16, ...
// STAGE kStageLoad or kStageLoop leaves out the edge loop or the slice load
// (the output is then unspecified): the breakdown's diagnostic copies.
template <bool REDUCE, int STAGE>
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
  if (STAGE != kStageLoop) {
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
  }
  for (int e = tid; e < E; e += kThreads) ccols[e] = __ldg(cols + c * E + e);
  if (STAGE != kStageLoop) mbar_wait(&bar, 0);
  __syncthreads();  // the column indices
  if (STAGE == kStageLoad) return;
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

template <bool REDUCE, int STAGE>
int launch_slice_gather(const int* fs, const int* cols,
                        const __nv_bfloat16* x, __nv_bfloat16* out,
                        long long nch, int R, int E, int K,
                        cudaStream_t cs) {
  const int smem = R * kSliceCols * 2 + E * 4;  // slice part, indices
  const cudaError_t err = cudaFuncSetAttribute(
      slice_gather_kernel<REDUCE, STAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(nch),
                  static_cast<unsigned>((K + kSliceCols - 1) / kSliceCols));
  slice_gather_kernel<REDUCE, STAGE><<<grid, kThreads, smem, cs>>>(
      fs, cols, x, out, R, E, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool REDUCE>
int launch_slice_gather_stage(int stage, const int* fs, const int* cols,
                              const __nv_bfloat16* x, __nv_bfloat16* out,
                              long long nch, int R, int E, int K,
                              cudaStream_t cs) {
  switch (stage) {
    case kStageFull:
      return launch_slice_gather<REDUCE, kStageFull>(fs, cols, x, out, nch, R,
                                                     E, K, cs);
    case kStageLoad:
      return launch_slice_gather<REDUCE, kStageLoad>(fs, cols, x, out, nch, R,
                                                     E, K, cs);
    case kStageLoop:
      return launch_slice_gather<REDUCE, kStageLoop>(fs, cols, x, out, nch, R,
                                                     E, K, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// nch chunks of E edges over R-row slices of the bf16 (N, K) x, one CTA per
// (chunk, 128 columns) (K a multiple of 8; a 128-column slice part and E
// indices within 200 KB); reduce 0 writes (nch * E, K), 1 writes (nch * 8,
// K); stage 0 the whole kernel, 1 the slice load alone, 2 the edge loop
// alone (the last two for measurement: the output is unspecified).
extern "C" int psp_slice_stages(int reduce, int stage, const void* fs,
                                const void* cols, const void* x, void* out,
                                long long nch, long long R, long long E,
                                long long K, void* stream) {
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
  return reduce ? launch_slice_gather_stage<true>(stage, f, c, xp, o, nch, r,
                                                  e, k, cs)
                : launch_slice_gather_stage<false>(stage, f, c, xp, o, nch, r,
                                                   e, k, cs);
}
