// Hand-written Hopper (sm_90a) kernel shared by the fused and the ranges
// engines (csrc/fused.cu, csrc/ranges.cu).
//
// Both TPU kernels (of_spmm_tpu/ops/pallas/fused.py::_kernel and
// of_spmm_tpu/ops/pallas/ranges.py::_kernel) compute, per plan segment,
//     Y[tile * R + dst0 + lrow[s, g, l], :] +=
//         sum_{window rows w selected by lane l} val(s, g, l) * X'[row(s, g, w), :]
// over every compute step s and lane group g, where window row w of
// group g is row w of the 128-row block blk[s, g] of the step's window
// ([hot | staged] or [hot | range | scattered]), X' = X * col_scale on
// rank-1 plans and Y is scaled by row_scale. Multi-hot lanes (rank-1
// plans) select window rows with a (4, 128) bitmask, summing them; one-hot
// lanes (general values) select one row and carry the value as a bf16
// pair (val_hi + val_lo). Lanes whose lrow is the sentinel (the tile
// height, or 128 in window mode) are padding.
//
// What the TPU kernels needed and this one does not: the TPU cannot
// gather inside a kernel, so it copied staged rows, take-table blocks and
// range chunks into VMEM one step ahead, split them into bf16 hi/lo pairs
// and ran one-hot matmuls. Here each window row resolves to its X row
// through the window provenance placement derived on the host
// (sparse/staged_windows.py), and the kernel reads X rows straight from
// memory (L2 catches rows that neighbouring steps share): no staging
// buffers, no take table, no hot table, fp32 throughout.
//
// What bounds it on the H100: bytes. Per lane group it reads the lane
// rows and masks or indices (0.5-2.5 KB), per selected window row one X
// row, and per lane it adds one row into Y. The compulsory traffic (each
// plan array the kernel reads once, each referenced X row once, Y once)
// over 3.35 TB/s is its bound. The design is simple on purpose:
// - one block of 4 warps per lane group slot (128 lanes), so the work is
//   spread over steps x G blocks whatever the tiles' weights: a hub tile's
//   steps (and virtual tiles) land on many blocks. The price is that
//   groups of one tile add into the same output rows: every lane's sum is
//   a float32 atomic add into Y (one float4 atomic per thread where
//   d % 4 == 0), which the wrapper zeroes first; row_scale is folded into
//   each add;
// - the block first resolves the group's 128 window rows to (X row,
//   scale) pairs in shared memory, one per thread;
// - each warp owns 32 lanes; one coalesced load brings each lane's row and
//   mask words (or index and values); then, per column slab of X, the warp
//   walks the selections of its lanes in order, warp-uniformly, four X
//   rows in flight, all 32 threads on the columns of a row (one float4
//   each when d % 4 == 0, two floats otherwise), summing a lane's
//   selections in registers and adding the sum when the lane ends;
// - non-compute steps (the prologue) and padding groups cost one read.
//
// The per-lane sums and the block per group matter because the work per
// lane is very unequal: a multi-hot lane of the hot columns can carry up
// to 128 selections, and the steps of a hub tile hold many such lanes
// (chip_smoke.py prints the selections per step and per group slot).
//
// All address arithmetic is 64-bit. A window row that resolves outside
// the padded X is a plan bug: the resolve step stops on it with a
// device-side assertion, once per window row and not per selection.
// Window rows that resolve to nothing copied read as zero; placement has
// checked on the host that no real lane reads one
// (sparse/staged_windows.py attach_windows).

#pragma once

#undef NDEBUG  // the window-row check below is an assert and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_staged {

constexpr int kWarp = 32;
constexpr int kL = 128;          // window block rows = lanes per group
constexpr int kThreads = kL;     // one thread per lane and per window row
constexpr int kCtrlWords = 16;
constexpr int kWinWords = 3;
constexpr int kInFlight = 4;     // X rows loaded before their adds
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const int32_t* ctrl;         // (steps, 16): [0] tile, [10] dst window
  const int32_t* blk;          // (steps, G)
  const int32_t* lidx;         // multi-hot (steps * G, 4, 128) or (steps * G, 128)
  const int32_t* lrow;         // (steps * G, 128)
  const float* val_hi;         // (steps * G, 128) or null (rank-1 plans)
  const float* val_lo;
  const int32_t* step_win;     // (steps, 3): range window, staged offset, extent
  const int32_t* range_rows;   // (n_windows, RC / RQ) or null
  const int32_t* staged_rows;  // (n_staged,)
  const int32_t* hot_ids;      // (n_hot,)
  const float* col_scale;      // (m,) or null
  const float* row_scale;      // (n,) or null
  const void* x;               // (m, d) float32
  void* out;                   // (n, d) float32, zeroed
  int64_t m, xs_rows, n, width, out_row0;
  int32_t G, R, n_hot, RC, RQ, n_rq, multihot, window;
};

__device__ __forceinline__ void fma_acc(float4& acc, float s, const float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ void fma_acc(float& acc, float s, const float v) {
  acc = fmaf(s, v, acc);
}

// one atomic add per thread: a float4 add exists for global memory on sm_90
__device__ __forceinline__ void add_to(float4* p, const float4 v) { atomicAdd(p, v); }

__device__ __forceinline__ void add_to(float* p, const float v) { atomicAdd(p, v); }

// Window row pos of a step -> (X row, scale); sw is the step's
// [range window, staged offset, staged extent].
__device__ __forceinline__ void resolve(const Args& a, const int sw[kWinWords], int pos,
                                        int32_t& src_out, float& scale_out) {
  int64_t src = -1;
  if (pos < a.n_hot) {
    src = __ldg(a.hot_ids + pos);
  } else if (pos < a.n_hot + a.RC) {
    const int p = pos - a.n_hot;
    if (sw[0] >= 0) {
      const int32_t start =
          __ldg(a.range_rows + static_cast<int64_t>(sw[0]) * a.n_rq + p / a.RQ);
      if (start >= 0) src = static_cast<int64_t>(start) + p % a.RQ;
    }
  } else {
    const int q = pos - a.n_hot - a.RC;
    if (q < sw[2]) src = __ldg(a.staged_rows + static_cast<int64_t>(sw[1]) + q);
  }
  if (src < 0) {  // nothing copied there: no real lane reads it
    src_out = 0;
    scale_out = 0.f;
    return;
  }
  assert(src < a.xs_rows);
  if (src >= a.m) {  // a row of the TPU wrapper's zero padding
    src_out = 0;
    scale_out = 0.f;
    return;
  }
  src_out = static_cast<int32_t>(src);
  scale_out = a.col_scale != nullptr ? __ldg(a.col_scale + src) : 1.f;
}

// T is float4 (width counted in float4s, NV = 1) or float (NV = 2): lane
// l of a warp owns elements c0 + l + 32 * i, i < NV, of each row, for
// column slabs c0 = 0, 32 * NV, ...
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
staged_spmm_kernel(const Args a) {
  __shared__ int32_t s_src[kL];
  __shared__ float s_scale[kL];

  const int64_t slot = blockIdx.x;
  const int64_t s = slot / a.G;
  const int tile = __ldg(a.ctrl + s * kCtrlWords);
  if (tile < 0) return;  // a staging-only (prologue) step
  const int sent = a.window ? kL : a.R;
  const int64_t row0 = a.out_row0 + static_cast<int64_t>(tile) * a.R +
                       (a.window ? static_cast<int64_t>(__ldg(a.ctrl + s * kCtrlWords + 10)) * kL
                                 : 0);
  const int l = threadIdx.x;
  const int lane = l & (kWarp - 1);
  // this thread's lane: its output row, selection words and multiplier
  const int row = __ldg(a.lrow + slot * kL + l);
  unsigned w0, w1, w2, w3;
  if (a.multihot) {
    const int32_t* m4 = a.lidx + slot * (4 * kL) + l;
    w0 = __ldg(m4);
    w1 = __ldg(m4 + kL);
    w2 = __ldg(m4 + 2 * kL);
    w3 = __ldg(m4 + 3 * kL);
  } else {
    const int w = __ldg(a.lidx + slot * kL + l) & (kL - 1);
    const unsigned bit = 1u << (w & 31);
    w0 = (w >> 5) == 0 ? bit : 0u;
    w1 = (w >> 5) == 1 ? bit : 0u;
    w2 = (w >> 5) == 2 ? bit : 0u;
    w3 = (w >> 5) == 3 ? bit : 0u;
  }
  const int64_t orow = row0 + row;
  const bool real = row < sent && orow < a.n && (w0 | w1 | w2 | w3) != 0u;
  if (__syncthreads_count(real) == 0) return;  // a padding group
  {
    int sw[kWinWords];
#pragma unroll
    for (int k = 0; k < kWinWords; ++k) sw[k] = __ldg(a.step_win + s * kWinWords + k);
    resolve(a, sw, __ldg(a.blk + slot) * kL + l, s_src[l], s_scale[l]);
  }
  __syncthreads();
  float mul = 0.f;
  if (real) {
    mul = a.row_scale != nullptr ? __ldg(a.row_scale + orow) : 1.f;
    if (a.val_hi != nullptr) {
      mul *= __ldg(a.val_hi + slot * kL + l) + __ldg(a.val_lo + slot * kL + l);
    }
  }
  const unsigned real_lanes = __ballot_sync(kFullMask, real);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int64_t c0 = 0; c0 < a.width; c0 += kWarp * NV) {
    // warp-uniform walk over the selections (lane j, window row w) of the
    // warp's lanes, a lane's selections summed in acc
    unsigned lanes = real_lanes;
    unsigned lw1 = 0u, lw2 = 0u, lw3 = 0u, cur = 0u;
    int k = 3;
    int64_t crow = -1, acc_row = -1;
    float cmul = 0.f;
    T acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = T{};
    bool more = true;
    while (more) {
      int src_u[kInFlight];
      float mul_u[kInFlight];
      int64_t row_u[kInFlight];
      int nu = 0;
      while (nu < kInFlight) {
        if (cur == 0u) {
          if (k < 3) {
            ++k;
            cur = k == 1 ? lw1 : (k == 2 ? lw2 : lw3);
            continue;
          }
          if (lanes == 0u) {
            more = false;
            break;
          }
          const int j = __ffs(lanes) - 1;
          lanes &= lanes - 1;
          cur = __shfl_sync(kFullMask, w0, j);
          lw1 = __shfl_sync(kFullMask, w1, j);
          lw2 = __shfl_sync(kFullMask, w2, j);
          lw3 = __shfl_sync(kFullMask, w3, j);
          crow = row0 + __shfl_sync(kFullMask, row, j);
          cmul = __shfl_sync(kFullMask, mul, j);
          k = 0;
          continue;
        }
        const int w = k * kWarp + __ffs(cur) - 1;
        cur &= cur - 1;
        src_u[nu] = s_src[w];
        mul_u[nu] = s_scale[w] * cmul;
        row_u[nu] = crow;
        ++nu;
      }
      T v[kInFlight][NV];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int64_t c = c0 + lane + i * kWarp;
          v[u][i] = T{};
          if (u < nu && c < a.width) v[u][i] = __ldg(x + src_u[u] * a.width + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u >= nu) break;
        if (row_u[u] != acc_row) {  // a new lane: add the last one's sum
          if (acc_row >= 0) {
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              const int64_t c = c0 + lane + i * kWarp;
              if (c < a.width) add_to(out + acc_row * a.width + c, acc[i]);
              acc[i] = T{};
            }
          }
          acc_row = row_u[u];
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) fma_acc(acc[i], mul_u[u], v[u][i]);
      }
    }
    if (acc_row >= 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int64_t c = c0 + lane + i * kWarp;
        if (c < a.width) add_to(out + acc_row * a.width + c, acc[i]);
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch one segment: one block per lane group slot. Returns a cudaError_t.
inline int launch(Args a, int64_t d, int64_t n_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_steps == 0 || d == 0 || a.n == 0) return 0;
  if (a.G <= 0 || n_steps * a.G > 0x7fffffff || a.R <= 0 || a.RQ <= 0 || a.RC % a.RQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_rq = a.RC / a.RQ;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_steps * a.G));
  if (d % 4 == 0 && aligned16(a.x) && aligned16(a.out)) {
    a.width = d / 4;
    staged_spmm_kernel<float4, 1><<<grid, kThreads, 0, st>>>(a);
  } else {
    a.width = d;
    staged_spmm_kernel<float, 2><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ofs_staged
