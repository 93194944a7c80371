// Register and shared-memory helpers of the work-unit SpMM kernels: the
// panel kernel (csrc/panels.cu) and the fused / ranges kernel
// (csrc/staged_spmm.cuh). Both sum a chunk's X rows in registers, one
// float4 (or two floats) of a row per lane, add each run into a 128-row
// fp32 accumulator tile in shared memory laid out [element][row][lane]
// (so a warp's 32 adds fall on 32 banks), and write each tile row once:
// a store, or an atomic add for a tile split into several work units.

#pragma once

#include <cuda_runtime.h>

namespace ofs_tile {

constexpr int kWarp = 32;
constexpr int kRows = 128;  // rows of the accumulator tile

__device__ __forceinline__ void fma_acc(float4& acc, float v, const float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ void fma_acc(float& acc, float v, const float x) {
  acc = fmaf(v, x, acc);
}

// element e of a lane's value: the float4's components, or the float
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float elem(const float& v, int) { return v; }

__device__ __forceinline__ void set_elem(float4& v, int e, float f) {
  if (e == 0) v.x = f;
  else if (e == 1) v.y = f;
  else if (e == 2) v.z = f;
  else v.w = f;
}

__device__ __forceinline__ void set_elem(float& v, int, float f) { v = f; }

// a row's value into Y: a store, or an atomic add (a float4 add exists for
// global memory on sm_90)
__device__ __forceinline__ void store(float4* p, const float4 v, bool add) {
  if (add) {
    atomicAdd(p, v);
  } else {
    *p = v;
  }
}

__device__ __forceinline__ void store(float* p, const float v, bool add) {
  if (add) {
    atomicAdd(p, v);
  } else {
    *p = v;
  }
}

// acc into row r of the accumulator tile [e][row][lane] (NE = NV * the
// floats of T elements per lane and row)
template <typename T, int NV>
__device__ __forceinline__ void add_row(float* s_acc, int r, int lane, const T (&acc)[NV]) {
  constexpr int EPV = static_cast<int>(sizeof(T) / sizeof(float));
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      atomicAdd(s_acc + ((i * EPV + e) * kRows + r) * kWarp + lane, elem(acc[i], e));
    }
}

}  // namespace ofs_tile
