// Windowed CSR SpMM (row-sum) for Hopper (sm_90a): K1 with the x rows that a
// tile of output rows shares served from shared memory.
//
//   out[m, :] = sum_{rowptr[m] <= e < rowptr[m+1]} value[e] * src[col[e], :]
//
// for the rows m of the flagged tiles of a window plan
// (ops/kernels/row_window.py); value = NULL means ones. The rows of the other
// tiles run K1's register walk (spmm_spans.cu at S = 1) through a piece
// table of their own, so the two launches together are K1.
//
// Replaces, with spmm_spans.cu, the TPU kernel
// paddle_sparse_tpu/ops/kernels/spmm_pallas.py::_reduce_kernel (:45,
// launched by _reduce_call :137), the CSR row-sum (K1).
//
// What bounds K1 on the H100: one gathered row of src per edge, nnz * K *
// sizeof(src) bytes (at ogbn-products scale, K = 256 f32: 125 GB, 37.4 ms at
// 3.35 TB/s), 20x the bytes of reading each input once. On a graph whose
// rows read mostly a short range of src (a clustered graph, or one
// renumbered by partition or RCM), L2 serves most of those rows, and the
// register walk is then bound by the rate at which L2 feeds the SMs. This
// kernel serves the rows of a tile's shared range from shared memory.
//
// Design. One block takes one flagged tile of T rows and one chunk of C
// columns: C = 32 f32 or 64 bf16, so one window row is 128 bytes and each
// lane owns one 32-bit word of it. Thread 0 copies the window src[w0 : w0 +
// W, c0 : c0 + C] into shared memory with 2-D TMA loads (a tensor map over
// src, boxes of 64 rows, completion on one mbarrier); W = 1728 rows fill
// 216 KB, beside an 8 KB stage, so one block of 32 warps runs on an SM. The
// warps then walk the tile's rows, one row each at a time, in CSR edge
// order: lane t stages edge t of the next 32 as (code, value), the code the
// word offset of its row in the window, or the complement of its row's word
// offset in src, and the warp takes the edges one by one, two codes a
// broadcast read. An edge inside the window reads its word from shared
// memory, any other from device memory with an L1-allocating __ldg; the
// whole warp takes one edge, so the choice is warp-uniform, and both loads
// are predicated, with no branch. Eight edges' words are loaded before they
// are summed. Each column sums fmaf(v, x, acc) from 0 in edge order, as
// spmm_spans.cu does, so the output is K1's bit for bit. Each output row is
// written once, with no atomics.
//
// What the card measured (PERF.md): slower than the register walk at
// every setting tried. Each 32-column chunk walks the tile's edges again and
// moves 4 bytes a lane a load: ~2.9 ns of an SM an edge and chunk even when
// every edge is in its window, where the register walk moves 16 bytes a
// lane a load for all of a row's columns at once, ~16 ns of an SM an edge
// at K = 256 f32 with L2 serving its rows. So no path builds a window plan,
// and nothing but its own checks and measurements launches this kernel.
//
// Contract (the Python wrapper, ops/kernels/spmm_window_cuda.py, checks it):
// src is a contiguous (N, K) f32 or bf16 array, 16-byte aligned, with K *
// sizeof(src) a multiple of 16 (TMA's stride rule) and fewer than 2**31
// 32-bit words; every col[e] of a
// flagged tile's rows lies in [0, N); W is a multiple of 64, and W * 128
// bytes and 8 bytes a thread fit in a block's shared memory; out is a
// contiguous (M, K) array.
// Offsets into src and out are computed in 64 bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using psp::encode_tiled;
using psp::EncodeTiledFn;
using psp::tma_load_box;

constexpr int kThreads = 1024;     // 32 warps a block
constexpr int kRowBytes = 128;     // one window row: 32 words
constexpr int kBoxRows = 64;       // rows per TMA box (at most 256)
constexpr int kUnroll = 8;         // edges whose words are in flight a warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
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

// A lane's 32-bit word of a row: one f32, or two bf16 columns.
template <typename TX>
__device__ __forceinline__ void unpack(uint32_t w,
                                       float (&v)[4 / sizeof(TX)]) {
  if constexpr (sizeof(TX) == 4) {
    v[0] = __uint_as_float(w);
  } else {
    v[0] = __uint_as_float(w << 16);           // column k: the low half
    v[1] = __uint_as_float(w & 0xffff0000u);   // column k + 1
  }
}

// A lane's columns of an output row, rounded to TO once.
template <typename TO, int VL>
__device__ __forceinline__ void store_word(TO* o, const float (&acc)[VL]) {
  if constexpr (sizeof(TO) == 4 && VL == 1) {
    *o = acc[0];
  } else if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(acc[0], acc[1]);
  }
}

// Block (tile i, chunk) of a grid of F * nchunks blocks, chunk fastest, so
// the chunks of one tile run together and share its col and value in L2.
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
spmm_window_kernel(const __grid_constant__ CUtensorMap xmap,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ col,
                   const float* __restrict__ value,
                   const uint32_t* __restrict__ src, TO* __restrict__ out,
                   const int* __restrict__ tiles,
                   const int* __restrict__ tile_w0, int M, int K, int T,
                   int W, int nchunks) {
  constexpr int VL = 4 / sizeof(TX);  // columns per lane
  extern __shared__ __align__(128) uint32_t win[];
  __shared__ __align__(8) uint64_t bar;
  const int chunk = blockIdx.x % nchunks;
  const int i = blockIdx.x / nchunks;
  const int tile = __ldg(tiles + i);
  const int w0 = __ldg(tile_w0 + i);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, static_cast<uint32_t>(W) * kRowBytes);
    for (int b = 0; b < W; b += kBoxRows) {
      tma_load_box(win + b * 32, &xmap, chunk * 32 * VL, w0 + b, &bar);
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(&bar, 0);

  const int lane = threadIdx.x & 31;
  // the warp's stage, after the window: its next 32 edges, each as (code,
  // value bits), code >= 0 the word offset of its row in the window, code
  // < 0 the complement of its row's word offset in src
  int2* stage =
      reinterpret_cast<int2*>(win + W * 32) + (threadIdx.x >> 5) * 32;
  const int row_words = K / VL;
  const int lw = chunk * 32 + lane;  // the lane's word of a row
  const bool active = lw < row_words;
  const uint32_t* lane_win = win + lane;
  const uint32_t* lane_src = src + (active ? lw : 0);  // a word any lane
  //                                                      may read
  const int r1 = static_cast<int>(
      min(static_cast<long long>(M), (tile + 1LL) * T));
  for (int r = tile * T + (threadIdx.x >> 5); r < r1; r += kThreads / 32) {
    const int e1 = __ldg(rowptr + r + 1);
    float acc[VL];
#pragma unroll
    for (int j = 0; j < VL; ++j) acc[j] = 0.f;
    for (int eb = __ldg(rowptr + r); eb < e1; eb += 32) {
      const int n = min(32, e1 - eb);
      int2 cv = make_int2(0, 0);  // past n: window word 0, never summed
      if (lane < n) {
        const int c = __ldg(col + eb + lane);
        const unsigned d = static_cast<unsigned>(c - w0);
        cv.x = d < static_cast<unsigned>(W) ? static_cast<int>(d) * 32
                                            : ~(c * row_words);
        cv.y = __float_as_int(value != nullptr ? __ldg(value + eb + lane)
                                               : 1.f);
      }
      __syncwarp();  // the last batch's reads of the stage are done
      stage[lane] = cv;
      __syncwarp();
      for (int j0 = 0; j0 < n; j0 += kUnroll) {
        uint32_t w[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int2 e = stage[j0 + u];  // a broadcast read
          v[u] = __int_as_float(e.y);
          // one of the two loads, by a warp-uniform predicate
          w[u] = e.x >= 0 ? lane_win[e.x]
                          : __ldg(lane_src + static_cast<uint32_t>(~e.x));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < n) {
            float xv[VL];
            unpack<TX>(w[u], xv);
#pragma unroll
            for (int j = 0; j < VL; ++j) acc[j] = fmaf(v[u], xv[j], acc[j]);
          }
        }
      }
    }
    if (active) store_word<TO, VL>(out + static_cast<int64_t>(r) * K + lw * VL,
                                   acc);
  }
}

// The launch's arguments past the tensor map.
struct Args {
  const int* rowptr;
  const int* col;
  const float* value;
  const void* src;
  void* out;
  const int* tiles;
  const int* tile_w0;
  int F, M, K, T, W;
  cudaStream_t stream;
};

template <typename TX, typename TO>
int launch(const CUtensorMap& map, const Args& a) {
  constexpr int C = 32 * (4 / sizeof(TX));
  const int nchunks = (a.K + C - 1) / C;
  // the window, then 8 bytes of stage a thread
  const size_t smem = static_cast<size_t>(a.W) * kRowBytes + kThreads * 8;
  auto kernel = spmm_window_kernel<TX, TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(a.F) * nchunks, kThreads, smem,
           a.stream>>>(map, a.rowptr, a.col, a.value,
                       static_cast<const uint32_t*>(a.src),
                       static_cast<TO*>(a.out), a.tiles, a.tile_w0, a.M, a.K,
                       a.T, a.W, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes: the rows of the F flagged tiles
// (tiles, tile_w0) of T rows and W window rows, written into the (M, K)
// out; src is (N, K). src_bf16 / out_bf16 select bf16 (1) or f32 (0); f32
// src takes an f32 out only. Launches on `stream` and returns
// cudaGetLastError() (0: accepted), or -1 when cuTensorMapEncodeTiled cannot
// be found, or -1000 - r when it refuses the tensor map with CUresult r.
extern "C" int psp_spmm_window(const void* rowptr, const void* col,
                               const void* value, const void* src, void* out,
                               const void* tiles, const void* tile_w0,
                               long long F, long long M, long long N,
                               long long K, long long T, long long W,
                               int src_bf16, int out_bf16, void* stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const int elt = src_bf16 ? 2 : 4;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elt};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / elt),
                             static_cast<cuuint32_t>(kBoxRows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = encode(
      &map,
      src_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(src), dims, strides, box, estrides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -1000 - static_cast<int>(r);
  const Args a{static_cast<const int*>(rowptr),
               static_cast<const int*>(col),
               static_cast<const float*>(value),
               src,
               out,
               static_cast<const int*>(tiles),
               static_cast<const int*>(tile_w0),
               static_cast<int>(F),
               static_cast<int>(M),
               static_cast<int>(K),
               static_cast<int>(T),
               static_cast<int>(W),
               static_cast<cudaStream_t>(stream)};
  if (!src_bf16) {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<float, float>(map, a);
  }
  if (out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(map, a);
  return launch<__nv_bfloat16, float>(map, a);
}
