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
// height, or 128 in window mode) are padding. dst0 is 0, or in window
// mode the step's 128-row window ctrl[s, 10] * 128.
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
// What bounds it on the H100: bytes. It reads each real group slot's lane
// rows and masks or indices (0.5-2.5 KB), one X row per selection (L2
// serves repeats) and writes Y. The compulsory traffic (each plan array
// once, each referenced X row once, Y once; utils/roofline.py
// StagedTraffic) over 3.35 TB/s is its bound: 0.0604 ms (fused) and
// 0.0616 ms (ranges) for one arxiv SpMM at d = 128. The work list below
// is a few KB and stays out of the bound.
//
// What the first design lost: one block of 4 warps per lane group slot,
// each warp walking all the selections of its 32 lanes alone, 4 X rows in
// flight, and every lane's sum added into a zeroed Y with a float32
// atomic. Selections per slot are far from even (arxiv: mean 143, p99
// 1,067, max 6,921): the busiest warp walked 2,226 selections, 557
// dependent rounds of loads. And each lane is one atomic row add: 3.8
// (fused) and 4.2 (ranges) per output row on arxiv, 16.9 and 17.8 on
// products-small, 2.1-2.2 GB of read-modify-write against a 125 MB Y. It
// took 0.58-0.59 ms on arxiv, 9.6x its bound.
//
// This design is the panel kernel's (csrc/panels.cu) on these plans:
// - placement cuts each key's group slots with real selections, in step
//   order, into work units of at most E selections (sparse/panels.py
//   UNIT_EDGES, 8,192; a denser single slot is a unit alone) and orders
//   them heaviest first (StagedWindows.units, sparse/staged_windows.py
//   work_list). A key is the output block a step writes: its tile of R
//   rows, or in window mode its 128-row window block (the steps of one
//   block interleave with the other blocks' across virtual tiles, so such
//   a block gets a unit per run and is split). One block runs one unit,
//   one 128-row pass of the key's rows (R > 128 without window mode: a
//   pass lists only the lanes whose rows it holds) and one column slab:
//   blockIdx.x = (unit * passes + pass) * slabs + slab. Staging-only steps
//   and padding slots are never listed;
// - per batch of up to 8 slots the block resolves their 8 x 128 window
//   rows to (X row, scale) pairs in shared memory, once, and each lane's
//   pass-local row and value (val_hi + val_lo, or 1). Then each thread
//   takes one mask word (lane tid / 4, word tid % 4) of each slot (the
//   one-hot lane's bit, for one-hot plans), and one block-wide prefix sum
//   of the per-slot popcounts (8 counts packed into two 64-bit words)
//   gives each (slot, thread) its place: the batch's selections land in a
//   shared list as (window row, row) and multiplier, slot by slot and lane
//   by lane, so a lane's selections are consecutive (4,096 at a time);
// - the 16 warps take that list in chunks of 8 selections, round robin: 8
//   X rows in flight per warp (the first design had 4), and a warp's
//   critical path is about a unit's selections / 16. A chunk's run of
//   selections into one row is summed in registers, then added to a
//   128-row fp32 accumulator tile in shared memory (shared-memory
//   atomics; laid out [element][row][lane], so a warp's 32 adds fall on
//   32 banks);
// - the epilogue multiplies each row by row_scale once (the first design
//   folded it into every lane). A key with one unit stores its rows: no
//   zero pass, no atomics. The rows of a key cut into several units are
//   zeroed first (one small kernel over those keys only, on the same
//   stream), and each unit adds its scaled partial with the sm_90 vector
//   atomicAdd(float4*) (scalar atomicAdd on the scalar path). Y is never
//   zeroed as a whole: a key without selections has an empty unit, which
//   writes its zero rows;
// - blockIdx.x's slab picks a column slab of X: 128 columns, one float4
//   per lane, when d % 4 == 0; 64 columns, two floats per lane, otherwise.
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

#include "tile_accumulate.cuh"

namespace ofs_staged {

constexpr int kWarp = 32;
constexpr int kL = 128;         // window block rows = lanes per group = rows per pass
constexpr int kWarps = 16;
constexpr int kThreads = kWarp * kWarps;
constexpr int kBatch = 8;       // group slots resolved and listed at once
constexpr int kListCap = 4096;  // selections listed at once
constexpr int kChunk = 8;       // selections (X rows in flight) per warp and turn
constexpr int kWinWords = 3;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == 4 * kL, "one thread per mask word of a slot");
static_assert(kBatch == 8, "the prefix sum packs 8 slot counts into two 64-bit words");
static_assert(kL == ofs_tile::kRows && kWarp == ofs_tile::kWarp, "the accumulator tile");

struct Args {
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
  const int32_t* unit_slots;   // (n_live,) slot ids step * G + g
  const int32_t* units;        // (n_units, 3) [key or ~key, first, end]
  const void* x;               // (m, d) float32
  void* out;                   // (n, d) float32
  int64_t m, xs_rows, n, width, out_row0, slabs;
  int32_t G, R, n_hot, RC, RQ, n_rq, multihot, window, nwb, passes;
};

using ofs_tile::add_row;
using ofs_tile::fma_acc;
using ofs_tile::set_elem;
using ofs_tile::store;

// count of slot gi in a thread's packed counts (16 bits each, 4 per word)
__device__ __forceinline__ int field(unsigned long long lo, unsigned long long hi, int gi) {
  return static_cast<int>(((gi < 4 ? lo : hi) >> (16 * (gi & 3))) & 0xffffu);
}

// first output row and height of a unit key: a tile of R rows, or in
// window mode one of a tile's 128-row window blocks
__device__ __forceinline__ void key_rows(const Args& a, int64_t key, int64_t& row0,
                                         int& height) {
  if (a.window) {
    const int w = static_cast<int>(key % a.nwb);
    row0 = a.out_row0 + (key / a.nwb) * a.R + static_cast<int64_t>(w) * kL;
    height = min(kL, a.R - w * kL);
  } else {
    row0 = a.out_row0 + key * a.R;
    height = a.R;
  }
}

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

// T is float4 (width counted in float4s, NV = 1) or float (NV = 2): lane l
// owns elements c0 + l + 32 * i, i < NV, of its rows, for one 32 * NV-wide
// column slab c0. The accumulator tile holds NE = NV * sizeof(T) / 4
// floats per lane and row, at [e][row][lane].
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
staged_spmm_kernel(const Args a) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);                // NE * 128 * 32
  auto* s_scan = reinterpret_cast<unsigned long long*>(s_acc + NE * kL * kWarp);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_scan + 2 * (kWarps + 1));  // [slot][window row]
  float* s_scale = reinterpret_cast<float*>(s_src + kBatch * kL);
  float* s_lval = s_scale + kBatch * kL;                         // [slot][lane]
  int32_t* s_lrow = reinterpret_cast<int32_t*>(s_lval + kBatch * kL);  // pass row or -1
  int32_t* s_list = s_lrow + kBatch * kL;                        // (window row) << 7 | row
  float* s_mul = reinterpret_cast<float*>(s_list + kListCap);

  const int64_t unit = blockIdx.x / (a.passes * a.slabs);
  const int pass = static_cast<int>((blockIdx.x / a.slabs) % a.passes);
  const int64_t c0 = (blockIdx.x % a.slabs) * kWarp * NV;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  const int key_word = __ldg(a.units + unit * 3);
  const int u_begin = __ldg(a.units + unit * 3 + 1);
  const int u_end = __ldg(a.units + unit * 3 + 2);
  const bool split = key_word < 0;
  int64_t key_row0;
  int height;
  key_rows(a, split ? ~key_word : key_word, key_row0, height);
  const int pass_row0 = pass * kL;                 // the pass's rows of the key
  const int pass_rows = min(kL, height - pass_row0);
  const T* __restrict__ x = static_cast<const T*>(a.x);

  for (int i = tid; i < NE * kL * kWarp; i += kThreads) s_acc[i] = 0.f;
  const int my_lane = tid >> 2;  // this thread's mask word of each slot:
  const int my_word = tid & 3;   // lane my_lane, window rows 32 my_word..

  for (int sb = u_begin; sb < u_end; sb += kBatch) {
    const int nb = min(kBatch, u_end - sb);
    __syncthreads();  // the previous batch's readers are done
    for (int e = tid; e < nb * kL; e += kThreads) {
      const int64_t slot = __ldg(a.unit_slots + sb + e / kL);
      const int64_t s = slot / a.G;
      int sw[kWinWords];
#pragma unroll
      for (int k = 0; k < kWinWords; ++k) sw[k] = __ldg(a.step_win + s * kWinWords + k);
      resolve(a, sw, __ldg(a.blk + slot) * kL + e % kL, s_src[e], s_scale[e]);
      // lane e % kL of the slot: its row in this pass (padding lanes and
      // other passes' rows: -1) and its value
      const int64_t li = slot * kL + e % kL;
      const int r = __ldg(a.lrow + li) - pass_row0;
      const bool mine = r >= 0 && r < pass_rows;
      s_lrow[e] = mine ? r : -1;
      s_lval[e] = mine && a.val_hi != nullptr ? __ldg(a.val_hi + li) + __ldg(a.val_lo + li) : 1.f;
    }
    __syncthreads();
    unsigned words[kBatch];
    unsigned long long cnt_lo = 0ull, cnt_hi = 0ull;
#pragma unroll
    for (int gi = 0; gi < kBatch; ++gi) {
      words[gi] = 0u;
      if (gi < nb && s_lrow[gi * kL + my_lane] >= 0) {
        const int64_t slot = __ldg(a.unit_slots + sb + gi);
        if (a.multihot) {
          words[gi] = static_cast<unsigned>(__ldg(a.lidx + (slot * 4 + my_word) * kL + my_lane));
        } else {
          const int w = __ldg(a.lidx + slot * kL + my_lane) & (kL - 1);
          words[gi] = (w >> 5) == my_word ? 1u << (w & 31) : 0u;
        }
      }
      const unsigned long long c = static_cast<unsigned long long>(__popc(words[gi]));
      if (gi < 4) {
        cnt_lo |= c << (16 * gi);
      } else {
        cnt_hi |= c << (16 * (gi - 4));
      }
    }
    // block-wide exclusive prefix sum of the packed counts (fields stay
    // below 2^16: at most 512 threads x 32 bits each)
    unsigned long long inc_lo = cnt_lo, inc_hi = cnt_hi;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const unsigned long long tl = __shfl_up_sync(kFullMask, inc_lo, off);
      const unsigned long long th = __shfl_up_sync(kFullMask, inc_hi, off);
      if (lane >= off) {
        inc_lo += tl;
        inc_hi += th;
      }
    }
    if (lane == kWarp - 1) {
      s_scan[warp] = inc_lo;
      s_scan[kWarps + 1 + warp] = inc_hi;
    }
    __syncthreads();
    if (warp == 0) {
      const unsigned long long vl = lane < kWarps ? s_scan[lane] : 0ull;
      const unsigned long long vh = lane < kWarps ? s_scan[kWarps + 1 + lane] : 0ull;
      unsigned long long wl = vl, wh = vh;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const unsigned long long tl = __shfl_up_sync(kFullMask, wl, off);
        const unsigned long long th = __shfl_up_sync(kFullMask, wh, off);
        if (lane >= off) {
          wl += tl;
          wh += th;
        }
      }
      __syncwarp();
      if (lane < kWarps) {
        s_scan[lane] = wl - vl;
        s_scan[kWarps + 1 + lane] = wh - vh;
      }
      if (lane == kWarps - 1) {
        s_scan[kWarps] = wl;
        s_scan[2 * kWarps + 1] = wh;
      }
    }
    __syncthreads();
    const unsigned long long ex_lo = s_scan[warp] + inc_lo - cnt_lo;
    const unsigned long long ex_hi = s_scan[kWarps + 1 + warp] + inc_hi - cnt_hi;
    const unsigned long long tot_lo = s_scan[kWarps];
    const unsigned long long tot_hi = s_scan[2 * kWarps + 1];
    int total = 0;
#pragma unroll
    for (int gi = 0; gi < kBatch; ++gi) total += field(tot_lo, tot_hi, gi);

    for (int r0 = 0; r0 < total; r0 += kListCap) {
      const int n_list = min(kListCap, total - r0);
      int base = 0;  // the first list place of slot gi: slots before it, then threads
#pragma unroll
      for (int gi = 0; gi < kBatch; ++gi) {
        unsigned w = words[gi];
        int idx = base + field(ex_lo, ex_hi, gi);
        if (w != 0u && idx < r0 + kListCap && idx + __popc(w) > r0) {
          const int row = s_lrow[gi * kL + my_lane];
          const float lv = s_lval[gi * kL + my_lane];
          while (w) {
            const int b = __ffs(w) - 1;
            w &= w - 1;
            if (idx >= r0 && idx < r0 + kListCap) {
              const int win = gi * kL + my_word * 32 + b;
              s_list[idx - r0] = (win << 7) | row;
              s_mul[idx - r0] = s_scale[win] * lv;
            }
            ++idx;
          }
        }
        base += field(tot_lo, tot_hi, gi);
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
        int row = s_list[c] & (kL - 1);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (c + u >= n_list) break;
          const int r = s_list[c + u] & (kL - 1);
          if (r != row) {  // a run of the chunk's selections into one row ends
            add_row(s_acc, row, lane, acc);
#pragma unroll
            for (int i = 0; i < NV; ++i) acc[i] = T{};
            row = r;
          }
          const float sc = s_mul[c + u];
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
  for (int j = warp; j < pass_rows; j += kWarps) {
    const int64_t r = key_row0 + pass_row0 + j;
    if (r >= a.n) break;  // the ragged last tile
    const float rs = a.row_scale != nullptr ? __ldg(a.row_scale + r) : 1.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t col = c0 + lane + i * kWarp;
      if (col >= a.width) continue;
      T val;
#pragma unroll
      for (int e = 0; e < NE / NV; ++e) {
        set_elem(val, e, s_acc[((i * (NE / NV) + e) * kL + j) * kWarp + lane] * rs);
      }
      store(out + r * a.width + col, val, split);
    }
  }
}

// Zero the rows of the keys that several units add into: key
// split_keys[blockIdx.x] of the segment, its rows below n.
__global__ void zero_split_rows(const Args a, const int32_t* __restrict__ split_keys,
                                int64_t d) {
  int64_t r0;
  int height;
  key_rows(a, __ldg(split_keys + blockIdx.x), r0, height);
  const int64_t r1 = r0 + height < a.n ? r0 + height : a.n;
  float* p = static_cast<float*>(a.out) + r0 * d;
  for (int64_t i = threadIdx.x; i < (r1 - r0) * d; i += blockDim.x) p[i] = 0.f;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int NV>
cudaError_t launch_units(const Args& a, int64_t n_units, cudaStream_t s) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  constexpr size_t smem = sizeof(float) * NE * kL * kWarp +
                          sizeof(unsigned long long) * 2 * (kWarps + 1) +
                          sizeof(int32_t) * (4 * kBatch * kL + 2 * kListCap);
  const auto kernel = staged_spmm_kernel<T, NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = n_units * a.passes * a.slabs;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Launch one segment: one zeroing block per split key, then one block per
// work unit, pass and column slab. Returns a cudaError_t.
inline int launch(Args a, const int32_t* split_keys, int64_t d, int64_t n_units,
                  int64_t n_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units == 0 || d == 0 || a.n == 0) return 0;
  if (a.G <= 0 || a.R <= 0 || a.RQ <= 0 || a.RC % a.RQ != 0 || n_split > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_rq = a.RC / a.RQ;
  a.nwb = (a.R + kL - 1) / kL;
  a.passes = a.window ? 1 : a.nwb;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    zero_split_rows<<<static_cast<unsigned>(n_split), 256, 0, st>>>(a, split_keys, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (d % 4 == 0 && aligned16(a.x) && aligned16(a.out)) {
    a.width = d / 4;
    a.slabs = (a.width + kWarp - 1) / kWarp;
    err = launch_units<float4, 1>(a, n_units, st);
  } else {
    a.width = d;
    a.slabs = (d + 2 * kWarp - 1) / (2 * kWarp);
    err = launch_units<float, 2>(a, n_units, st);
  }
  return static_cast<int>(err);
}

// One segment of a placed plan (the body of ofs_fused_spmm and
// ofs_ranges_spmm, which say what the arguments are).
inline int spmm_segment(const void* blk, const void* lidx, const void* lrow,
                        const void* val_hi, const void* val_lo, const void* step_win,
                        const void* range_rows, const void* staged_rows, const void* hot_ids,
                        const void* col_scale, const void* row_scale, const void* unit_slots,
                        const void* units, const void* split_keys, const void* x, void* out,
                        int64_t m, int64_t xs_rows, int64_t n, int64_t d, int64_t out_row0,
                        int64_t n_units, int64_t n_split, int G, int R, int n_hot, int RC,
                        int RQ, int multihot, int window, int device, void* stream) {
  Args a{};
  a.blk = static_cast<const int32_t*>(blk);
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.val_hi = static_cast<const float*>(val_hi);
  a.val_lo = static_cast<const float*>(val_lo);
  a.step_win = static_cast<const int32_t*>(step_win);
  a.range_rows = static_cast<const int32_t*>(range_rows);
  a.staged_rows = static_cast<const int32_t*>(staged_rows);
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
  a.out_row0 = out_row0;
  a.G = G;
  a.R = R;
  a.n_hot = n_hot;
  a.RC = RC;
  a.RQ = RQ;
  a.multihot = multihot;
  a.window = window;
  return launch(a, static_cast<const int32_t*>(split_keys), d, n_units, n_split, device,
                stream);
}

}  // namespace ofs_staged
