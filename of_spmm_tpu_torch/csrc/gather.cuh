// What the gather microbenchmarks' kernels share (csrc/microbench_gather.cu,
// csrc/microbench_gather2.cu): the row width, the warp mask, the bfloat16
// widening, launch helpers, and the one row gather that vmem_take, onehot,
// onehot_pair and window_pair all instantiate.

#pragma once

#undef NDEBUG  // the index checks are asserts and must stay on
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_gather {

constexpr int kD = 128;      // row width (columns)
constexpr int kD4 = kD / 4;  // row width in float4: one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherThreads = 256;

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

// Piece p (4 values) of table row c as float32, read through L1 / L2.
__device__ __forceinline__ float4 tier_piece(const float* __restrict__ tier, int64_t c, int p) {
  return __ldg(reinterpret_cast<const float4*>(tier) + c * kD4 + p);
}

__device__ __forceinline__ float4 tier_piece(const __nv_bfloat16* __restrict__ tier, int64_t c,
                                             int p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(tier) + c * kD4 + p));
}

// The row gather: out[t] = f32(tier[b + l]) (+ f32(tier2[b + l]) where
// tier2 is not null, the two added in float32), l = cols[t], b =
// bases[t / tile] (0 where bases is null). Thread e writes float4 e % 32
// of row e / 32, so neighbouring threads write neighbouring addresses and
// each warp's store is one 512-byte row; the row's index and base are
// loaded once for its 32 threads (one broadcast load each). The tables
// (a few MB at most in the tools) are read through L1 / L2; the output
// (512 MB at the tools' T, ten times L2) is written with streaming stores
// (st.global.cs). An l outside [0, window) stops the kernel (kZeroFill
// false) or gives a zero row (kZeroFill true); a base with b + window
// past the table's n_rows stops it.
template <class Tier, bool kZeroFill>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const int32_t* __restrict__ cols, const int32_t* __restrict__ bases,
                  int64_t tile, const Tier* __restrict__ tier, const Tier* __restrict__ tier2,
                  float4* __restrict__ out, int64_t T, int64_t window, int64_t n_rows) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= T * kD4) return;
  const int64_t t = e / kD4;
  const int32_t l = cols[t];
  int64_t b = 0;
  if (bases != nullptr) {
    b = bases[t / tile];
    assert(b >= 0 && b + window <= n_rows);
  }
  const bool inside = l >= 0 && l < window;
  if (!kZeroFill) assert(inside);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!kZeroFill || inside) {
    const int p = static_cast<int>(e % kD4);
    v = tier_piece(tier, b + l, p);
    if (tier2 != nullptr) {
      const float4 w = tier_piece(tier2, b + l, p);
      v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
    }
  }
  __stcs(out + e, v);
}

// Launches row_gather_kernel on T rows; returns a cudaError_t.
template <class Tier, bool kZeroFill>
int launch_row_gather(const void* cols, const void* bases, int64_t tile, const void* tier,
                      const void* tier2, void* out, int64_t T, int64_t window, int64_t n_rows,
                      cudaStream_t stream) {
  row_gather_kernel<Tier, kZeroFill><<<blocks_for(T * kD4, kGatherThreads), kGatherThreads, 0,
                                       stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const int32_t*>(bases), tile,
      static_cast<const Tier*>(tier), static_cast<const Tier*>(tier2), static_cast<float4*>(out),
      T, window, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ofs_gather
