// The run compaction's second half (segcompact.cu describes the kernels):
// f16, bf16, int32 and int64 values through the row and the stream kernel,
// and the trailing-dim pass of every value type. Compiled apart from
// segcompact.cu only so that nvcc builds the two in parallel.

#include "segcompact.cuh"

namespace psp_segcompact {

cudaError_t rows_values(int code, const RowsCall& c, cudaStream_t st) {
  switch (code) {
    case kBF16: return run_rows<__nv_bfloat16>(c, st);
    case kF16: return run_rows<__half>(c, st);
    case kI32: return run_rows<int>(c, st);
    case kI64: return run_rows<long long>(c, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t stream_values(int code, const StreamCall& c, cudaStream_t st) {
  switch (code) {
    case kBF16: return run_stream<__nv_bfloat16>(c, st);
    case kF16: return run_stream<__half>(c, st);
    case kI32: return run_stream<int>(c, st);
    case kI64: return run_stream<long long>(c, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t vec_values(int code, const VecCall& c, cudaStream_t st) {
  switch (code) {
    case kF32: launch_vec<float>(c, st); break;
    case kBF16: launch_vec<__nv_bfloat16>(c, st); break;
    case kF16: launch_vec<__half>(c, st); break;
    case kF64: launch_vec<double>(c, st); break;
    case kI32: launch_vec<int>(c, st); break;
    case kI64: launch_vec<long long>(c, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace psp_segcompact
