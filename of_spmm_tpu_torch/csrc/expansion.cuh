// Hand-written Hopper (sm_90a) kernel shared by the two one-hot expansion
// engines (csrc/expansion.cu, csrc/expansion2.cu).
//
// Both TPU kernels (of_spmm_tpu/ops/pallas/expansion.py::_expansion_kernel
// and of_spmm_tpu/ops/pallas/expansion2.py::_kernel) compute, per plan
// group and per step s of 1,024 lanes (TILE, or G groups of 128),
//     Y[tile_of[s] * R + lrow[l], :] += scale(l) * X[stage_row[u(l)], :]
// over the step's lanes l, where u(l) is the lane's staged row:
//   v1: base_blk[s * CW/128 + li / 128] * 128 + li % 128 (li = win_lidx,
//       an index into the step's window of CW/128 arbitrary 128-row
//       staging blocks);
//   v2: blk_of[g] * 128 + lidx (one staging block per 128-lane group g).
// The scale is the lane's value, val_hi + val_lo read in fp32 (v1, and v2
// on general values), or stage_scale[u] * row_scale[output row] (v2 on
// rank-1 values). A lane adds nothing when its row is the sentinel R (v2
// padding) or its value is 0 (v1 padding carries row 0 and value 0).
//
// What the TPU kernels needed and this one does not: the TPU cannot
// gather rows inside a kernel, so XLA gathered a staged table per group
// (one take per 32,768-column tier) and the kernels selected its rows
// with exact 0/1 one-hot matmuls on the MXU, in bf16 hi/lo pairs, then
// scattered the (TILE, D) contributions into the (R, D) output tile with a
// second one-hot matmul. Here placement has mapped each staged row to its
// X row on the host (stage_row, sparse/expansion.py), and the kernel
// reads X rows straight from memory: no staged table, no one-hots, fp32
// throughout.
//
// What bounds it on the H100: bytes. Per lane it reads its index, row and
// value (10-12 B), per real lane one X row (4d B, L2 catches rows that
// neighbouring lanes share) and adds one row into Y. The compulsory
// traffic (each plan array once, each referenced X row once, Y once) over
// 3.35 TB/s is its bound (utils/roofline.py ExpansionTraffic). The design
// is simple on purpose:
// - the output tile (R = 512 rows: 256 KB at d = 128) does not fit a
//   block's shared memory, and one block per tile would repeat the panel
//   kernel's imbalance. Every step carries exactly 1,024 lanes, so one
//   block of 4 warps per 128-lane group (steps x 8 blocks) is balanced by
//   construction; the price is that groups of one tile add into the same
//   output rows, so every lane's row is a float32 atomic add into Y (one
//   float4 atomic per thread where d % 4 == 0), which the wrapper zeroes
//   first; row_scale folds into the add;
// - each thread resolves one lane (staged row, X row, scale, output row);
//   each warp then walks its real lanes warp-uniformly, four X rows in
//   flight, all 32 threads on the columns of a row (one float4 each when
//   d % 4 == 0, two floats otherwise), per column slab.
//
// All address arithmetic is 64-bit. A staged row outside the group's
// table or an X row outside X is a plan bug: the kernel stops on it with
// a device-side assertion (placement has checked the plan on the host,
// sparse/expansion.py check_lanes).

#pragma once

#undef NDEBUG  // the row checks below are asserts and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_expansion {

constexpr int kWarp = 32;
constexpr int kL = 128;          // lanes per group = staging block rows
constexpr int kThreads = kL;     // one thread per lane
constexpr int kInFlight = 4;     // X rows loaded before their adds
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const int32_t* lidx;         // (lanes,) v1 win_lidx / v2 lidx
  const int32_t* lrow;         // (lanes,)
  const uint16_t* val_hi;      // (lanes,) bf16 bits, or null (v2 rank-1)
  const uint16_t* val_lo;
  const int32_t* blk;          // v1 base_blk (steps * nblk) / v2 blk_of (groups)
  const int32_t* tile_of;      // (steps,)
  const int32_t* stage_row;    // (n_staged,) X row of each staged row
  const float* stage_scale;    // (n_staged,) or null
  const float* row_scale;      // (n,) or null
  const void* x;               // (m, d) float32
  void* out;                   // (n, d) float32, zeroed
  int64_t m, n, width, out_row0, n_staged;
  int32_t groups_per_step, nblk, R;
};

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ float4 scaled(const float4 v, float s) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float scaled(const float v, float s) { return s * v; }

// one atomic add per thread: a float4 add exists for global memory on sm_90
__device__ __forceinline__ void add_to(float4* p, const float4 v) { atomicAdd(p, v); }

__device__ __forceinline__ void add_to(float* p, const float v) { atomicAdd(p, v); }

// kV2: one staging block per 128-lane group (blk_of) instead of a window
// of nblk blocks per step (base_blk). T is float4 (width counted in
// float4s, NV = 1) or float (NV = 2): lane j of a warp owns elements
// c0 + j + 32 * i, i < NV, of each row, for column slabs c0 = 0, 32 * NV, ...
template <bool kV2, typename T, int NV>
__global__ void __launch_bounds__(kThreads)
expansion_kernel(const Args a) {
  const int64_t slot = blockIdx.x;  // the 128-lane group
  const int64_t s = slot / a.groups_per_step;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t e = slot * kL + threadIdx.x;

  // this thread's lane: X row, scale and output row
  const int row = __ldg(a.lrow + e);
  bool real = row >= 0 && row < a.R;
  float mul = 1.f;
  if (real && a.val_hi != nullptr) {
    mul = bf16_to_float(__ldg(a.val_hi + e)) + bf16_to_float(__ldg(a.val_lo + e));
    real = mul != 0.f;
  }
  int32_t src = 0;
  int32_t orow = 0;
  if (real) {
    const int li = __ldg(a.lidx + e);
    const int64_t bi = kV2 ? slot : s * a.nblk + (li >> 7);
    const int64_t u = static_cast<int64_t>(__ldg(a.blk + bi)) * kL + (li & (kL - 1));
    assert(u >= 0 && u < a.n_staged);
    const int64_t xrow = __ldg(a.stage_row + u);
    assert(xrow >= 0 && xrow < a.m);
    const int64_t o = a.out_row0 + static_cast<int64_t>(__ldg(a.tile_of + s)) * a.R + row;
    real = o < a.n;
    src = static_cast<int32_t>(xrow);
    orow = static_cast<int32_t>(o);
    if (a.stage_scale != nullptr) mul *= __ldg(a.stage_scale + u);
    if (real && a.row_scale != nullptr) mul *= __ldg(a.row_scale + o);
  }
  const unsigned real_lanes = __ballot_sync(kFullMask, real);
  if (real_lanes == 0u) return;  // a warp of padding

  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int64_t c0 = 0; c0 < a.width; c0 += kWarp * NV) {
    unsigned lanes = real_lanes;
    while (lanes != 0u) {
      int32_t src_u[kInFlight], row_u[kInFlight];
      float mul_u[kInFlight];
      int nu = 0;
      while (lanes != 0u && nu < kInFlight) {
        const int j = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        src_u[nu] = __shfl_sync(kFullMask, src, j);
        row_u[nu] = __shfl_sync(kFullMask, orow, j);
        mul_u[nu] = __shfl_sync(kFullMask, mul, j);
        ++nu;
      }
      T v[kInFlight][NV];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int64_t c = c0 + lane + i * kWarp;
          v[q][i] = T{};
          if (q < nu && c < a.width) {
            v[q][i] = __ldg(x + static_cast<int64_t>(src_u[q]) * a.width + c);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (q >= nu) break;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int64_t c = c0 + lane + i * kWarp;
          if (c < a.width) {
            add_to(out + static_cast<int64_t>(row_u[q]) * a.width + c, scaled(v[q][i], mul_u[q]));
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch one plan group: one block per 128-lane group. Returns a cudaError_t.
template <bool kV2>
inline int launch(Args a, int64_t d, int64_t n_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_steps == 0 || d == 0 || a.n == 0) return 0;
  if (a.groups_per_step <= 0 || n_steps * a.groups_per_step > 0x7fffffff || a.R <= 0 ||
      (!kV2 && a.nblk <= 0) || a.m > 0x7fffffff || a.n > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_steps * a.groups_per_step));
  if (d % 4 == 0 && aligned16(a.x) && aligned16(a.out)) {
    a.width = d / 4;
    expansion_kernel<kV2, float4, 1><<<grid, kThreads, 0, st>>>(a);
  } else {
    a.width = d;
    expansion_kernel<kV2, float, 2><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The C entry point of both engines (their signatures are the same).
template <bool kV2>
inline int run(const void* lidx, const void* lrow, const void* val_hi, const void* val_lo,
               const void* blk, const void* tile_of, const void* stage_row,
               const void* stage_scale, const void* row_scale, const void* x, void* out,
               int64_t m, int64_t n, int64_t d, int64_t out_row0, int64_t n_steps,
               int64_t n_staged, int groups_per_step, int nblk, int R, int device,
               void* stream) {
  Args a{};
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.val_hi = static_cast<const uint16_t*>(val_hi);
  a.val_lo = static_cast<const uint16_t*>(val_lo);
  a.blk = static_cast<const int32_t*>(blk);
  a.tile_of = static_cast<const int32_t*>(tile_of);
  a.stage_row = static_cast<const int32_t*>(stage_row);
  a.stage_scale = static_cast<const float*>(stage_scale);
  a.row_scale = static_cast<const float*>(row_scale);
  a.x = x;
  a.out = out;
  a.m = m;
  a.n = n;
  a.out_row0 = out_row0;
  a.n_staged = n_staged;
  a.groups_per_step = groups_per_step;
  a.nblk = nblk;
  a.R = R;
  return launch<kV2>(a, d, n_steps, device, stream);
}

}  // namespace ofs_expansion
