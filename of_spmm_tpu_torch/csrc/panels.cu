// Hand-written Hopper (sm_90a) kernel of the panel engine.
//
// panel_spmm replaces of_spmm_tpu/ops/pallas/panels.py::_kernel (launched
// there by _segment_call, one pallas_call per plan segment). It runs one
// segment of a PanelPlan (sparse/panels.py): for every compute step s of
// an output tile and every real group slot g of that step,
//     out[tile * 128 + r, :] += sum_w bit(mask[s, g], w, r) * X'[row(s, g, w), :]
// where window row w of block blk[s, g] resolves to an X row through the
// plan's window provenance (PanelWindows) and X' = X * col_scale (times
// stage_scale on per-edge scattered rows). The epilogue multiplies by
// row_scale, so one launch computes the segment's rows of Y = A @ X.
//
// What the TPU kernel needed and this one does not: the TPU cannot gather
// inside a kernel, so its wrapper built a take table (X rows in window
// order) in HBM, the kernel DMA'd that table, the hot rows and the range
// chunks into VMEM, split them into bf16 hi/lo pairs and ran one
// 128x128x256 MXU matmul per group. Here a block reads its window rows
// straight from X (L2 catches rows that several tiles share): no take
// table, no staging copies, no hi/lo split, fp32 throughout.
//
// What bounds it on the H100: bytes. Per group slot it reads the mask
// words (2 KB) and, per set bit, one X row (d * 4 bytes); it does 2 flops
// per X element read. The compulsory traffic (each mask, structure array
// and referenced X row once, the output once) over 3.35 TB/s is its
// bound: 0.0658 ms for one arxiv SpMM at d = 128.
//
// What the first design lost: one block of 16 warps per 128-row output
// tile, each warp owning 8 fixed rows and walking their set bits with 4 X
// rows in flight. A tile's edges are far from even (on arxiv the heaviest
// tile holds 75,573 edges, the mean 1,003) and so are a tile's rows: one
// warp walked 9,794 edges alone while its block's other 15 idled, and the
// kernel took 45x its bound (2.95 ms).
//
// This design balances the work at both levels:
// - placement cuts each tile's group slots, in step order, into work
//   units of at most E edges (UNIT_EDGES, 8,192; a denser single slot is
//   a unit alone) and orders them heaviest first (PanelWindows.units,
//   sparse/panels.py work_units); one block runs one unit and one column
//   slab (blockIdx.x = unit * slabs + slab). Only slots with mask bits
//   are listed, so staging-only steps and padded slots are never read;
// - per batch of up to 8 slots the block resolves their 8 x 128 window
//   rows to (X row, scale) pairs in shared memory, once; then each thread
//   loads one mask word (tile row r = tid / 4, word tid % 4) of each slot,
//   a block-wide prefix sum of the popcounts gives each thread its place,
//   and the threads write the batch's edges as (slot, window row, tile
//   row) into a shared list, in tile-row order (4,096 entries at a time);
// - the 16 warps take that list in chunks of 8 edges, round robin: 8 X
//   rows in flight per warp, and a warp's critical path is about a
//   unit's edges / 16 whatever the rows they land on. A chunk's run of
//   edges into one tile row is summed in registers, then added to a
//   128-row fp32 accumulator tile in shared memory (shared-memory atomics;
//   the tile is laid out [element][row][lane], so a warp's 32 adds fall on
//   32 banks);
// - the epilogue multiplies the tile by row_scale. A tile with one unit
//   stores its rows: no zero pass, no atomics. A tile cut into several
//   units has its rows zeroed first (one small kernel over those tiles
//   only, on the same stream), and each unit adds its scaled partial
//   with the sm_90 vector atomicAdd(float4*) (scalar atomicAdd on the
//   scalar path). Atomics rather than a buffer of partials and a second
//   pass: split tiles are few (at E = 8,192, 14 of arxiv's 1,323 tiles and
//   244 of products-small's 1,914), a buffer would cost 64 KB of writes
//   and reads a unit, and the sum order they leave free moves a result by
//   about 1e-7 relative, far inside the kernel's 1e-5 + 1e-4|p| bar;
// - blockIdx.x's slab picks a column slab of X: 128 columns, one float4
//   per lane, when d % 4 == 0; 64 columns, two floats per lane, otherwise.
//
// All address arithmetic is 64-bit. A window row that resolves outside
// the padded X is a plan bug: the resolve step stops on it with a
// device-side assertion, once per window row and not per nonzero. Window
// rows that resolve to nothing staged (past a tile's scattered region, a
// range chunk never copied) read as zero; placement has checked on the
// host that no mask bit names one (sparse/panels.py attach_windows).

#undef NDEBUG  // the window-row check below is an assert and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_accumulate.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 128;
constexpr int kWarps = 16;
constexpr int kThreads = kWarp * kWarps;
constexpr int kBatch = 8;       // group slots resolved and listed at once
constexpr int kListCap = 4096;  // edges listed at once
constexpr int kChunk = 8;       // edges (X rows in flight) per warp and turn
constexpr int kWinWords = 5;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == 4 * kTileRows, "one thread per mask word of a slot");
static_assert(kTileRows == ofs_tile::kRows && kWarp == ofs_tile::kWarp, "the accumulator tile");

struct PanelArgs {
  const int32_t* blk;          // (steps, G)
  const int32_t* masks;        // (steps * G, 4, 128)
  const int32_t* step_win;     // (steps, 5)
  const int32_t* range_rows;   // (n_windows, n_rq)
  const int32_t* direct_rows;  // (n_direct,)
  const int32_t* stage_take;   // (n_take,)
  const float* stage_scale;    // (n_take,) or null (rank-1 plans)
  const int32_t* hot_ids;      // (n_hot,)
  const float* col_scale;      // (m,)
  const float* row_scale;      // (n,)
  const int32_t* unit_slots;   // (n_live,) slot ids step * G + g
  const int32_t* units;        // (n_units, 3) [tile or ~tile, first, end]
  const void* x;               // (m, d) float32
  void* out;                   // (n, d) float32
  int64_t m, xs_rows, n, width, out_tile0, slabs;
  int32_t G, n_hot, RC, RQ, n_rq;
};

using ofs_tile::add_row;
using ofs_tile::fma_acc;
using ofs_tile::set_elem;
using ofs_tile::store;

// Window row pos of a step -> (X row, scale). sw: the step's
// [range window, table base, table rows P, direct base, direct rows D].
__device__ __forceinline__ void resolve(const PanelArgs& a, const int sw[kWinWords],
                                        int pos, int32_t& src_out, float& scale_out) {
  int64_t src = 0;
  float sc = 1.f;
  bool found = false;
  if (pos < a.n_hot) {
    src = __ldg(a.hot_ids + pos);
    found = true;
  } else if (pos < a.n_hot + a.RC) {
    const int p = pos - a.n_hot;
    if (sw[0] >= 0) {
      const int32_t start =
          __ldg(a.range_rows + static_cast<int64_t>(sw[0]) * a.n_rq + p / a.RQ);
      if (start >= 0) {
        src = static_cast<int64_t>(start) + p % a.RQ;
        found = true;
      }
    }
  } else {
    const int q = pos - a.n_hot - a.RC;
    if (q < sw[2]) {
      const int64_t ti = static_cast<int64_t>(sw[1]) + q;
      src = __ldg(a.stage_take + ti);
      if (a.stage_scale != nullptr) sc = __ldg(a.stage_scale + ti);
      found = true;
    } else if (q < sw[2] + sw[4]) {
      src = __ldg(a.direct_rows + static_cast<int64_t>(sw[3]) + (q - sw[2]));
      found = true;
    }
  }
  if (!found) {  // nothing staged there: no mask bit names it
    src_out = 0;
    scale_out = 0.f;
    return;
  }
  assert(src >= 0 && src < a.xs_rows);
  if (src >= a.m) {  // a row of X's zero padding
    src_out = 0;
    scale_out = 0.f;
    return;
  }
  src_out = static_cast<int32_t>(src);
  scale_out = sc * __ldg(a.col_scale + src);
}

// T is float4 (width counted in float4s, NV = 1) or float (NV = 2): lane l
// owns elements c0 + l + 32 * i, i < NV, of its rows, for one 32 * NV-wide
// column slab c0. The accumulator tile holds NE = NV * sizeof(T) / 4
// floats per lane and row, at [e][row][lane].
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
panel_spmm_kernel(const PanelArgs a) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);                // NE * 128 * 32
  int32_t* s_src = reinterpret_cast<int32_t*>(s_acc + NE * kTileRows * kWarp);
  float* s_scale = reinterpret_cast<float*>(s_src + kBatch * kTileRows);
  int32_t* s_list = reinterpret_cast<int32_t*>(s_scale + kBatch * kTileRows);
  int32_t* s_scan = s_list + kListCap;                           // kWarps + 1

  const int64_t unit = blockIdx.x / a.slabs;
  const int64_t c0 = (blockIdx.x % a.slabs) * kWarp * NV;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  const int tile_word = __ldg(a.units + unit * 3);
  const int u_begin = __ldg(a.units + unit * 3 + 1);
  const int u_end = __ldg(a.units + unit * 3 + 2);
  const bool split = tile_word < 0;
  const int64_t tile = split ? ~tile_word : tile_word;
  const T* __restrict__ x = static_cast<const T*>(a.x);

  for (int i = tid; i < NE * kTileRows * kWarp; i += kThreads) s_acc[i] = 0.f;
  const int my_row = tid >> 2;  // this thread's mask word of each slot:
  const int my_word = tid & 3;  // tile row my_row, window rows 32 my_word..

  for (int sb = u_begin; sb < u_end; sb += kBatch) {
    const int nb = min(kBatch, u_end - sb);
    __syncthreads();  // the previous batch's readers are done
    for (int e = tid; e < nb * kTileRows; e += kThreads) {
      const int64_t slot = __ldg(a.unit_slots + sb + e / kTileRows);
      const int64_t s = slot / a.G;
      int sw[kWinWords];
#pragma unroll
      for (int k = 0; k < kWinWords; ++k) sw[k] = __ldg(a.step_win + s * kWinWords + k);
      const int pos = __ldg(a.blk + slot) * kTileRows + e % kTileRows;
      resolve(a, sw, pos, s_src[e], s_scale[e]);
    }
    unsigned words[kBatch];
    int cnt = 0;
#pragma unroll
    for (int gi = 0; gi < kBatch; ++gi) {
      words[gi] = 0u;
      if (gi < nb) {
        const int64_t slot = __ldg(a.unit_slots + sb + gi);
        words[gi] = static_cast<unsigned>(
            __ldg(a.masks + (slot * 4 + my_word) * kTileRows + my_row));
      }
      cnt += __popc(words[gi]);
    }
    // block-wide exclusive prefix sum of the counts
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == kWarp - 1) s_scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kWarps ? s_scan[lane] : 0;
      int w = v;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const int t = __shfl_up_sync(kFullMask, w, off);
        if (lane >= off) w += t;
      }
      __syncwarp();
      if (lane < kWarps) s_scan[lane] = w - v;
      if (lane == kWarps - 1) s_scan[kWarps] = w;
    }
    __syncthreads();
    const int first = s_scan[warp] + incl - cnt;
    const int total = s_scan[kWarps];

    for (int r0 = 0; r0 < total; r0 += kListCap) {
      const int n_list = min(kListCap, total - r0);
      if (cnt > 0 && first < r0 + kListCap && first + cnt > r0) {
        int idx = first;
#pragma unroll
        for (int gi = 0; gi < kBatch; ++gi) {
          unsigned w = words[gi];
          while (w) {
            const int b = __ffs(w) - 1;
            w &= w - 1;
            if (idx >= r0 && idx < r0 + kListCap) {
              s_list[idx - r0] = (gi << 14) | ((my_word * 32 + b) << 7) | my_row;
            }
            ++idx;
          }
        }
      }
      __syncthreads();
      for (int c = warp * kChunk; c < n_list; c += kWarps * kChunk) {
        // the chunk's entries are the same for the whole warp: issue its
        // X rows' loads first, then re-read the entries to sum them
        T v[kChunk][NV];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
#pragma unroll
          for (int i = 0; i < NV; ++i) v[u][i] = T{};
          if (c + u < n_list) {
            const T* xr = x + static_cast<int64_t>(s_src[s_list[c + u] >> 7]) * a.width;
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              const int64_t col = c0 + lane + i * kWarp;
              if (col < a.width) v[u][i] = __ldg(xr + col);
            }
          }
        }
        T acc[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = T{};
        int row = s_list[c] & (kTileRows - 1);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (c + u >= n_list) break;
          const int ent = s_list[c + u];
          const int r = ent & (kTileRows - 1);
          if (r != row) {  // a run of the chunk's edges into one tile row ends
            add_row(s_acc, row, lane, acc);
#pragma unroll
            for (int i = 0; i < NV; ++i) acc[i] = T{};
            row = r;
          }
          const float sc = s_scale[ent >> 7];
#pragma unroll
          for (int i = 0; i < NV; ++i) fma_acc(acc[i], sc, v[u][i]);
        }
        add_row(s_acc, row, lane, acc);
      }
      __syncthreads();  // the list is read before the next round rewrites it
    }
  }
  __syncthreads();

  T* __restrict__ out = static_cast<T*>(a.out);
  for (int j = warp; j < kTileRows; j += kWarps) {
    const int64_t r = (a.out_tile0 + tile) * kTileRows + j;
    if (r >= a.n) break;  // the ragged last tile
    const float rs = __ldg(a.row_scale + r);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t col = c0 + lane + i * kWarp;
      if (col >= a.width) continue;
      T val;
#pragma unroll
      for (int e = 0; e < NE / NV; ++e) {
        set_elem(val, e, s_acc[((i * (NE / NV) + e) * kTileRows + j) * kWarp + lane] * rs);
      }
      store(out + r * a.width + col, val, split);
    }
  }
}

// Zero the rows of the tiles that several units add into: tile
// split_tiles[blockIdx.x] of the segment, rows [.. * 128, min(.. + 128, n)).
__global__ void zero_split_rows(const int32_t* __restrict__ split_tiles, float* out,
                                int64_t out_tile0, int64_t n, int64_t d) {
  const int64_t r0 = (out_tile0 + __ldg(split_tiles + blockIdx.x)) * kTileRows;
  const int64_t r1 = r0 + kTileRows < n ? r0 + kTileRows : n;
  float* p = out + r0 * d;
  for (int64_t i = threadIdx.x; i < (r1 - r0) * d; i += blockDim.x) p[i] = 0.f;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int NV>
cudaError_t launch(const PanelArgs& a, int64_t n_units, cudaStream_t s) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  constexpr size_t smem = sizeof(float) * NE * kTileRows * kWarp +
                          sizeof(int32_t) * (2 * kBatch * kTileRows + kListCap + kWarps + 1);
  const auto kernel = panel_spmm_kernel<T, NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (n_units * a.slabs > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_units * a.slabs), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One segment of a placed PanelPlan against x float32 (m, d); writes the
// segment's rows [out_tile0 * 128, min((out_tile0 + n_tiles) * 128, n)) of
// out float32 (n, d): one block per work unit and column slab, after one
// zeroing block per split tile. Every pointer is a contiguous device array
// (see PanelArgs; stage_scale may be null). Returns a cudaError_t.
int ofs_panel_spmm(const void* blk, const void* masks, const void* step_win,
                   const void* range_rows, const void* direct_rows,
                   const void* stage_take, const void* stage_scale,
                   const void* hot_ids, const void* col_scale,
                   const void* row_scale, const void* unit_slots, const void* units,
                   const void* split_tiles, const void* x, void* out,
                   int64_t m, int64_t xs_rows, int64_t n, int64_t d,
                   int64_t out_tile0, int64_t n_units, int64_t n_split, int G, int n_hot,
                   int RC, int RQ, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units == 0 || d == 0) return 0;
  if (n_split > 0x7fffffff || G <= 0 || RQ <= 0 || RC % RQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PanelArgs a;
  a.blk = static_cast<const int32_t*>(blk);
  a.masks = static_cast<const int32_t*>(masks);
  a.step_win = static_cast<const int32_t*>(step_win);
  a.range_rows = static_cast<const int32_t*>(range_rows);
  a.direct_rows = static_cast<const int32_t*>(direct_rows);
  a.stage_take = static_cast<const int32_t*>(stage_take);
  a.stage_scale = static_cast<const float*>(stage_scale);
  a.hot_ids = static_cast<const int32_t*>(hot_ids);
  a.col_scale = static_cast<const float*>(col_scale);
  a.row_scale = static_cast<const float*>(row_scale);
  a.unit_slots = static_cast<const int32_t*>(unit_slots);
  a.units = static_cast<const int32_t*>(units);
  a.x = x;
  a.out = out;
  a.m = m;
  a.xs_rows = xs_rows;
  a.n = n;
  a.out_tile0 = out_tile0;
  a.G = G;
  a.n_hot = n_hot;
  a.RC = RC;
  a.RQ = RQ;
  a.n_rq = RC / RQ;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    zero_split_rows<<<static_cast<unsigned>(n_split), 256, 0, s>>>(
        static_cast<const int32_t*>(split_tiles), static_cast<float*>(out), out_tile0, n, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (d % 4 == 0 && aligned16(x) && aligned16(out)) {
    a.width = d / 4;
    a.slabs = (a.width + kWarp - 1) / kWarp;
    err = launch<float4, 1>(a, n_units, s);
  } else {
    a.width = d;
    a.slabs = (d + 2 * kWarp - 1) / (2 * kWarp);
    err = launch<float, 2>(a, n_units, s);
  }
  return static_cast<int>(err);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
