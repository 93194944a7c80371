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
// What bounds it on the H100: bytes. Per real lane it reads its list
// entry, index, row and value (14-16 B) and one X row (4d B; L2 catches
// rows that neighbouring lanes share), and it writes Y once. The
// compulsory traffic (each plan array once, each referenced X row once,
// Y once; utils/roofline.py ExpansionTraffic, which leaves the work list
// out) over 3.35 TB/s is its bound: 0.0601 ms (v1) and 0.0580 ms (v2)
// for one arxiv SpMM at d = 128.
//
// What the first design lost: one block of 4 warps per 128-lane group,
// balanced by construction, but groups of one tile add into the same
// output rows, so every real lane was a float4 atomic row add into a Y
// the wrapper had zeroed first: on arxiv 1.33M atomic rows of 512 bytes,
// 680 MB of read-modify-write into an 87 MB Y that does not fit L2, after
// an 87 MB memset; and 36% of the lanes were padding, resolved thread by
// thread before being dropped. It took 0.318 ms on arxiv, 5.3x its bound,
// 1.58x torch.sparse.mm (2.31 ms on products-small, 2.2x).
//
// This design is the panel kernel's (csrc/panels.cu) on lanes:
// - placement lists only the real lanes, sorted by output block (a 128-row
//   block of a tile: the key) and output row, and cuts each key's run
//   into work units of at most E lanes (sparse/expansion.py UNIT_LANES,
//   2,048; LaneWork, lane_work, with sparse/panels.py work_units). The
//   units of one key run together, since they read the same tile's X
//   rows and L2 then holds them, and keys run heaviest first, so the hub
//   tiles start at once (where X exceeds L2, as on products-small,
//   heaviest unit first spread a key's units over the run and was
//   slower). One launch runs every unit of every group of the plan: a
//   small device table holds each group's array pointers. One block runs
//   one unit and one column slab: blockIdx.x = unit * slabs + slab;
// - the 16 warps take the unit's lanes in chunks of 32, round robin; each
//   thread resolves one lane (staged row, X row, scale, row in the block)
//   and the warp sums the chunk 8 X rows at a time, each run of one
//   output row in registers (7.8 lanes a row on arxiv), then adds the run
//   into a 128-row fp32 accumulator tile in shared memory
//   (csrc/tile_accumulate.cuh);
// - the epilogue folds row_scale (v2 rank-1) once per row. A key with one
//   unit stores its rows: no zeroing, no atomics. The rows of a key cut
//   into several units are zeroed first (one small kernel over those keys
//   only, on the same stream), and each unit adds its rows with the sm_90
//   vector atomicAdd(float4*) (scalar atomicAdd on the scalar path). Y is
//   never zeroed as a whole: a key without lanes has an empty unit, which
//   writes its zero rows; rows at or past n are not written;
// - blockIdx.x's slab picks a column slab of X: 128 columns, one float4
//   per lane, when d % 4 == 0; 64 columns, two floats per lane, otherwise.
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

#include "tile_accumulate.cuh"

namespace ofs_expansion {

constexpr int kWarp = 32;
constexpr int kL = 128;          // staging block rows = output block rows
constexpr int kWarps = 16;
constexpr int kThreads = kWarp * kWarps;
constexpr int kInFlight = 8;     // X rows loaded before their adds
constexpr int kTableWords = 8;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kL == ofs_tile::kRows && kWarp == ofs_tile::kWarp, "the accumulator tile");

// One group's row of the device table (int64 words): its lane arrays
// lidx (v1 win_lidx / v2 lidx), lrow, val_hi, val_lo (bf16 bits, or 0 on
// v2 rank-1 plans), blk (v1 base_blk / v2 blk_of), stage_row, stage_scale
// (or 0), and its staged rows.
struct Args {
  const long long* table;   // (groups, 8)
  const int32_t* lanes;     // (n_real,) group-local lane ids, sorted
  const int32_t* units;     // (n_units, 4) [key or ~key, first, end, group]
  const int32_t* split_keys;
  const float* row_scale;   // (n,) or null
  const void* x;            // (m, d) float32
  void* out;                // (n, d) float32
  int64_t m, n, width, slabs;
  int32_t R, nwb, tile_lanes, nblk;  // nwb = ceil(R / 128); v1: TILE, CW / 128
};

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// first output row and height of key (a 128-row block of a tile)
__device__ __forceinline__ void key_rows(const Args& a, int64_t key, int64_t& row0,
                                         int& height) {
  const int w = static_cast<int>(key % a.nwb);
  row0 = (key / a.nwb) * a.R + static_cast<int64_t>(w) * kL;
  height = min(kL, a.R - w * kL);
}

// kV2: one staging block per 128-lane group (blk_of) instead of a window
// of nblk blocks per step (base_blk). T is float4 (width counted in
// float4s, NV = 1) or float (NV = 2): lane j of a warp owns elements
// c0 + j + 32 * i, i < NV, of each row, for one 32 * NV-wide column slab
// c0. The accumulator tile holds NE = NV * sizeof(T) / 4 floats per lane
// and row, at [e][row][lane].
template <bool kV2, typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
expansion_kernel(const Args a) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);  // NE * 128 * 32

  const int64_t unit = blockIdx.x / a.slabs;
  const int64_t c0 = (blockIdx.x % a.slabs) * kWarp * NV;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  const int key_word = __ldg(a.units + unit * 4);
  const int first = __ldg(a.units + unit * 4 + 1);
  const int end = __ldg(a.units + unit * 4 + 2);
  const long long* g = a.table + static_cast<int64_t>(__ldg(a.units + unit * 4 + 3)) * kTableWords;
  const bool split = key_word < 0;
  int64_t row0;
  int height;
  key_rows(a, split ? ~key_word : key_word, row0, height);
  const auto* lidx = reinterpret_cast<const int32_t*>(__ldg(g));
  const auto* lrow = reinterpret_cast<const int32_t*>(__ldg(g + 1));
  const auto* val_hi = reinterpret_cast<const uint16_t*>(__ldg(g + 2));
  const auto* val_lo = reinterpret_cast<const uint16_t*>(__ldg(g + 3));
  const auto* blk = reinterpret_cast<const int32_t*>(__ldg(g + 4));
  const auto* stage_row = reinterpret_cast<const int32_t*>(__ldg(g + 5));
  const auto* stage_scale = reinterpret_cast<const float*>(__ldg(g + 6));
  const int64_t n_staged = __ldg(g + 7);
  const T* __restrict__ x = static_cast<const T*>(a.x);

  for (int i = tid; i < NE * kL * kWarp; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();
  for (int c = first + warp * kWarp; c < end; c += kWarps * kWarp) {
    // this thread's lane: X row, scale and row in the block
    int32_t src = 0;
    float mul = 0.f;
    int row = 0;
    const bool real = c + lane < end;
    if (real) {
      const int e = __ldg(a.lanes + c + lane);  // lanes of a group stay below 2^31
      const int li = __ldg(lidx + e);
      const int64_t bi =
          kV2 ? e / kL : static_cast<int64_t>(e / a.tile_lanes) * a.nblk + (li >> 7);
      const int64_t u = static_cast<int64_t>(__ldg(blk + bi)) * kL + (li & (kL - 1));
      assert(u >= 0 && u < n_staged);
      const int64_t xrow = __ldg(stage_row + u);
      assert(xrow >= 0 && xrow < a.m);
      src = static_cast<int32_t>(xrow);
      mul = val_hi != nullptr ? bf16_to_float(__ldg(val_hi + e)) + bf16_to_float(__ldg(val_lo + e))
                              : 1.f;
      if (stage_scale != nullptr) mul *= __ldg(stage_scale + u);
      row = __ldg(lrow + e) & (kL - 1);
    }
    ofs_tile::accumulate_entries<kInFlight, T, NV>(
        s_acc, x, a.width, c0, lane, __ballot_sync(kFullMask, real), src, mul, row);
  }
  __syncthreads();
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int j = warp; j < height; j += kWarps) {
    const int64_t r = row0 + j;
    if (r >= a.n) break;  // the ragged last tile
    const float rs = a.row_scale != nullptr ? __ldg(a.row_scale + r) : 1.f;
    ofs_tile::write_row<T, NV>(s_acc, j, lane, c0, a.width, out + r * a.width, rs, split);
  }
}

// Zero the rows of the keys that several units add into: key
// split_keys[blockIdx.x], rows [row0, row0 + height) below n.
__global__ void zero_split_rows(const Args a, int64_t d) {
  int64_t row0;
  int height;
  key_rows(a, __ldg(a.split_keys + blockIdx.x), row0, height);
  const int64_t r1 = row0 + height < a.n ? row0 + height : a.n;
  float* p = static_cast<float*>(a.out) + row0 * d;
  for (int64_t i = threadIdx.x; i < (r1 - row0) * d; i += blockDim.x) p[i] = 0.f;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool kV2, typename T, int NV>
cudaError_t launch_units(const Args& a, int64_t n_units, cudaStream_t s) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  constexpr size_t smem = sizeof(float) * NE * kL * kWarp;
  const auto kernel = expansion_kernel<kV2, T, NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (n_units * a.slabs > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_units * a.slabs), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The C entry point of both engines (their signatures are the same): the
// zeroing of split keys' rows, then one launch over every unit.
template <bool kV2>
inline int run(const void* table, const void* lanes, const void* units, const void* split_keys,
               const void* row_scale, const void* x, void* out, int64_t m, int64_t n,
               int64_t d, int64_t n_units, int64_t n_split, int R, int tile_lanes, int nblk,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units == 0 || d == 0 || n == 0) return 0;
  if (R <= 0 || n_split > 0x7fffffff || m > 0x7fffffff ||
      (!kV2 && (tile_lanes <= 0 || nblk <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.table = static_cast<const long long*>(table);
  a.lanes = static_cast<const int32_t*>(lanes);
  a.units = static_cast<const int32_t*>(units);
  a.split_keys = static_cast<const int32_t*>(split_keys);
  a.row_scale = static_cast<const float*>(row_scale);
  a.x = x;
  a.out = out;
  a.m = m;
  a.n = n;
  a.R = R;
  a.nwb = (R + kL - 1) / kL;
  a.tile_lanes = tile_lanes;
  a.nblk = nblk;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    zero_split_rows<<<static_cast<unsigned>(n_split), 256, 0, st>>>(a, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (d % 4 == 0 && aligned16(x) && aligned16(out)) {
    a.width = d / 4;
    a.slabs = (a.width + kWarp - 1) / kWarp;
    err = launch_units<kV2, float4, 1>(a, n_units, st);
  } else {
    a.width = d;
    a.slabs = (d + 2 * kWarp - 1) / (2 * kWarp);
    err = launch_units<kV2, float, 2>(a, n_units, st);
  }
  return static_cast<int>(err);
}

}  // namespace ofs_expansion
