// What the gather microbenchmarks' kernels share (csrc/microbench_gather.cu,
// csrc/microbench_gather2.cu): the row width, the warp mask, the bfloat16
// widening and launch helpers.

#pragma once

#undef NDEBUG  // the index checks are asserts and must stay on
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_gather {

constexpr int kD = 128;  // row width (columns)
constexpr unsigned kFull = 0xffffffffu;

// 4 bfloat16 values (8 bytes) as float32.
__device__ __forceinline__ float4 widen4(const uint2 w) {
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// An error of a runtime call (one that launched nothing), after clearing
// it from the runtime's last-error state, so that the next launch's
// cudaGetLastError() does not report it again.
inline int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

inline unsigned blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace ofs_gather
