// Register and shared-memory helpers of the work-unit SpMM kernels: the
// panel kernel (csrc/panels.cu), the fused / ranges kernel
// (csrc/staged_spmm.cuh), the bucket kernel (csrc/spmm.cu) and the
// expansion kernel (csrc/expansion.cuh). Each sums a chunk's X rows in
// registers, one float4 (or two floats) of a row per lane, adds each run
// into a 128-row fp32 accumulator tile in shared memory laid out
// [element][row][lane] (so a warp's 32 adds fall on 32 banks), and writes
// each tile row once: a store, or an atomic add for a tile split into
// several work units.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// The warp's 32 entries, one per thread: X row ``src``, multiplier ``mul``
// and tile row ``row``, in row order; ``take`` (warp-uniform) marks the
// entries to add. Loads kInFlight X rows at a time (the slab's elements
// c0 + lane + 32 i of each), sums each run of one row in registers and
// adds the run into the tile once.
template <int kInFlight, typename T, int NV>
__device__ __forceinline__ void accumulate_entries(float* s_acc, const T* __restrict__ x,
                                                   int64_t width, int64_t c0, int lane,
                                                   unsigned take, int32_t src, float mul,
                                                   int row) {
  constexpr unsigned kFull = 0xffffffffu;
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T{};
  int cur = -1;
  while (take != 0u) {
    int j_u[kInFlight];  // the entries' threads (-1: none), warp-uniform
    T v[kInFlight][NV];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      j_u[q] = -1;
      if (take != 0u) {
        j_u[q] = __ffs(take) - 1;
        take &= take - 1;
      }
      const int64_t s = __shfl_sync(kFull, src, j_u[q] & (kWarp - 1));
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int64_t col = c0 + lane + i * kWarp;
        v[q][i] = T{};
        if (j_u[q] >= 0 && col < width) v[q][i] = __ldg(x + s * width + col);
      }
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (j_u[q] < 0) break;
      const float m = __shfl_sync(kFull, mul, j_u[q]);
      const int r = __shfl_sync(kFull, row, j_u[q]);
      if (r != cur) {  // a run of one row ends
        if (cur >= 0) add_row(s_acc, cur, lane, acc);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = T{};
        cur = r;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) fma_acc(acc[i], m, v[q][i]);
    }
  }
  if (cur >= 0) add_row(s_acc, cur, lane, acc);
}

// Row j of the tile times ``scale`` into ``out_row`` (the slab's elements
// c0 + lane + 32 i): a store, or an atomic add.
template <typename T, int NV>
__device__ __forceinline__ void write_row(const float* s_acc, int j, int lane, int64_t c0,
                                          int64_t width, T* out_row, float scale, bool add) {
  constexpr int EPV = static_cast<int>(sizeof(T) / sizeof(float));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t col = c0 + lane + i * kWarp;
    if (col >= width) continue;
    T val;
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      set_elem(val, e, s_acc[((i * EPV + e) * kRows + j) * kWarp + lane] * scale);
    }
    store(out_row + col, val, add);
  }
}

}  // namespace ofs_tile
