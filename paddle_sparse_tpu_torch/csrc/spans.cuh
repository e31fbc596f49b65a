// Span flattening shared by the multi-span kernels (spmm_spans.cu,
// sddmm_spans.cu).
//
// Row m of a multi-span operand owns S spans of edge positions,
// [start[s * stride + m], end[s * stride + m]) for s < S, a span with
// end <= start being empty. At full ogbn-products scale a row's ~50 edges are
// spread over 19 (bf16) or 38 (f32) spans of 1-3 edges each, so a warp that
// walked span by span would have about one gather in flight. Instead the warp
// flattens up to 32 spans at a time: lane t loads the bounds of span s0 + t, a
// warp prefix sum over the span lengths numbers the chunk's edges
// 0 .. total-1 in (span, position) order, and each lane finds the span of its
// flat edge by a 5-step binary search over the lanes' prefix sums. The caller
// then walks the flat edges 32 at a time, as the CSR kernels walk a row, so
// the edges of a row are visited in span order and, within a span, in
// position order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace psp {

constexpr unsigned kFullMask = 0xffffffffu;

// Up to 32 spans of one row, one per lane. Sums of lengths are 64-bit: spans
// given by a caller's tables may overlap, so a row's total is not bounded by
// the number of edges.
struct SpanChunk {
  int start;        // start of span s0 + lane (lanes past S: 0)
  int base;         // base[s0 + lane], or 0 without a base table
  long long excl;   // edges of the chunk in spans before s0 + lane
  long long total;  // edges of the chunk; the same on every lane
};

struct SpanEdge {
  int e;     // edge position
  int base;  // base of the edge's span
};

// Called by all 32 lanes of the warp together.
__device__ __forceinline__ SpanChunk load_span_chunk(
    const int* __restrict__ start, const int* __restrict__ end,
    const int* __restrict__ base, long long stride, int s0, int S, int row,
    int lane) {
  SpanChunk c;
  c.start = 0;
  c.base = 0;
  int len = 0;
  const int s = s0 + lane;
  if (s < S) {
    const int64_t off = static_cast<int64_t>(s) * stride + row;
    c.start = __ldg(start + off);
    len = max(0, __ldg(end + off) - c.start);
    if (base != nullptr) c.base = __ldg(base + s);
  }
  long long cum = len;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFullMask, cum, o);
    if (lane >= o) cum += y;
  }
  c.excl = cum - len;
  c.total = __shfl_sync(kFullMask, cum, 31);
  return c;
}

// The edge at flat position f of the chunk. Called by all 32 lanes together;
// a lane with f >= total gets a meaningless answer and must not use it. The
// span of f is the last lane t with excl[t] <= f: excl is non-decreasing, an
// empty span shares its excl with the next span, and the last lane's span
// ends at total > f, so that lane's span is never empty.
__device__ __forceinline__ SpanEdge span_edge(const SpanChunk& c,
                                              long long f) {
  int t = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kFullMask, c.excl, t + step) <= f) t += step;
  }
  SpanEdge se;
  se.e = __shfl_sync(kFullMask, c.start, t) +
         static_cast<int>(f - __shfl_sync(kFullMask, c.excl, t));
  se.base = __shfl_sync(kFullMask, c.base, t);
  return se;
}

}  // namespace psp
