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
// bound. The design is simple on purpose:
// - one block of 16 warps owns one 128-row output tile and walks that
//   tile's compute steps in order; nothing carries between blocks, so
//   there are no atomics and no zero pass over the output;
// - blockIdx.y picks a column slab of X: 128 columns, one float4 per
//   lane, when d % 4 == 0; 64 columns, two floats per lane, otherwise
//   (four would spill at 64 registers); any d;
// - per batch of 8 group slots, the block resolves the 8 x 128 window rows
//   to (X row, scale) pairs in shared memory, once;
// - each warp owns 8 output rows: one coalesced load brings the 4 mask
//   words of each of its rows, shuffles hand each row's words to the
//   whole warp, and the warp walks the set bits with __ffs, four X rows in
//   flight at a time, into float32 register accumulators;
// - steps whose control word says they hold no real group are skipped,
//   and padded slots (all-zero masks at the tail of a step) are not read.
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

namespace {

constexpr int kWarp = 32;
constexpr int kTileRows = 128;
constexpr int kWarps = 16;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = kTileRows / kWarps;  // 8
constexpr int kBatch = 8;                         // group slots resolved at once
constexpr int kCtrlWords = 24;
constexpr int kWinWords = 5;
constexpr unsigned kFullMask = 0xffffffffu;

struct PanelArgs {
  const int32_t* ctrl;         // (steps, 24)
  const int32_t* blk;          // (steps, G)
  const int32_t* masks;        // (steps * G, 4, 128)
  const int32_t* tile_steps;   // (n_tiles + 1,)
  const int32_t* step_win;     // (steps, 5)
  const int32_t* range_rows;   // (n_windows, n_rq)
  const int32_t* direct_rows;  // (n_direct,)
  const int32_t* stage_take;   // (n_take,)
  const float* stage_scale;    // (n_take,) or null (rank-1 plans)
  const int32_t* hot_ids;      // (n_hot,)
  const float* col_scale;      // (m,)
  const float* row_scale;      // (n,)
  const void* x;               // (m, d) float32
  void* out;                   // (n, d) float32
  int64_t m, xs_rows, n, width, out_tile0;
  int32_t G, n_hot, RC, RQ, n_rq;
};

__device__ __forceinline__ void fma_acc(float4& acc, float v, const float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ void fma_acc(float& acc, float v, const float x) {
  acc = fmaf(v, x, acc);
}

__device__ __forceinline__ float4 scaled(const float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float scaled(float a, float s) { return a * s; }

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
// column slab c0 = blockIdx.y * 32 * NV.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
panel_spmm_kernel(const PanelArgs a) {
  __shared__ int32_t s_src[kBatch * kTileRows];
  __shared__ float s_scale[kBatch * kTileRows];

  const int tile = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int row0 = warp * kRowsPerWarp;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kWarp * NV;
  const T* __restrict__ x = static_cast<const T*>(a.x);

  T acc[kRowsPerWarp][NV];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[j][i] = T{};

  const int s_begin = __ldg(a.tile_steps + tile);
  const int s_end = __ldg(a.tile_steps + tile + 1);
  for (int s = s_begin; s < s_end; ++s) {
    const int g1 = __ldg(a.ctrl + static_cast<int64_t>(s) * kCtrlWords + 1);
    if (g1 == 1) continue;  // a staging-only step: no real group
    const int real = g1 == 0 ? a.G : g1 - 1;
    int sw[kWinWords];
#pragma unroll
    for (int k = 0; k < kWinWords; ++k) {
      sw[k] = __ldg(a.step_win + static_cast<int64_t>(s) * kWinWords + k);
    }
    const int64_t slot0 = static_cast<int64_t>(s) * a.G;
    for (int gb = 0; gb < real; gb += kBatch) {
      const int nb = min(kBatch, real - gb);
      __syncthreads();  // the previous batch's readers are done
      for (int e = threadIdx.x; e < nb * kTileRows; e += kThreads) {
        const int g = gb + e / kTileRows;
        const int pos = __ldg(a.blk + slot0 + g) * kTileRows + e % kTileRows;
        resolve(a, sw, pos, s_src[e], s_scale[e]);
      }
      __syncthreads();
      for (int gi = 0; gi < nb; ++gi) {
        // lane l holds word (l / 8) of row row0 + l % 8
        const int32_t word = __ldg(a.masks + (slot0 + gb + gi) * (4 * kTileRows) +
                                   (lane >> 3) * kTileRows + row0 + (lane & 7));
        const int32_t* src_g = s_src + gi * kTileRows;
        const float* scale_g = s_scale + gi * kTileRows;
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            unsigned bits = static_cast<unsigned>(__shfl_sync(kFullMask, word, k * 8 + j));
            while (bits) {  // uniform across the warp
              int w[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (bits) {
                  w[u] = k * 32 + __ffs(bits) - 1;
                  bits &= bits - 1;
                } else {
                  w[u] = -1;
                }
              }
              T v[4][NV];
              float sc[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                sc[u] = 0.f;
#pragma unroll
                for (int i = 0; i < NV; ++i) v[u][i] = T{};
                if (w[u] >= 0) {
                  sc[u] = scale_g[w[u]];
                  const T* xr = x + static_cast<int64_t>(src_g[w[u]]) * a.width;
#pragma unroll
                  for (int i = 0; i < NV; ++i) {
                    const int64_t c = c0 + lane + i * kWarp;
                    if (c < a.width) v[u][i] = __ldg(xr + c);
                  }
                }
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int i = 0; i < NV; ++i) fma_acc(acc[j][i], sc[u], v[u][i]);
            }
          }
        }
      }
    }
  }

  T* __restrict__ out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int64_t r = (a.out_tile0 + tile) * kTileRows + row0 + j;
    if (r >= a.n) break;  // the ragged last tile
    const float rs = __ldg(a.row_scale + r);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t c = c0 + lane + i * kWarp;
      if (c < a.width) out[r * a.width + c] = scaled(acc[j][i], rs);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// One segment of a placed PanelPlan against x float32 (m, d); writes the
// segment's rows [out_tile0 * 128, min((out_tile0 + n_tiles) * 128, n)) of
// out float32 (n, d). Every pointer is a contiguous device array (see
// PanelArgs; stage_scale may be null). Returns a cudaError_t.
int ofs_panel_spmm(const void* ctrl, const void* blk, const void* masks,
                   const void* tile_steps, const void* step_win,
                   const void* range_rows, const void* direct_rows,
                   const void* stage_take, const void* stage_scale,
                   const void* hot_ids, const void* col_scale,
                   const void* row_scale, const void* x, void* out,
                   int64_t m, int64_t xs_rows, int64_t n, int64_t d,
                   int64_t out_tile0, int64_t n_tiles, int G, int n_hot, int RC,
                   int RQ, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0 || d == 0) return 0;
  if (n_tiles > 0x7fffffff || G <= 0 || RQ <= 0 || RC % RQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PanelArgs a;
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.blk = static_cast<const int32_t*>(blk);
  a.masks = static_cast<const int32_t*>(masks);
  a.tile_steps = static_cast<const int32_t*>(tile_steps);
  a.step_win = static_cast<const int32_t*>(step_win);
  a.range_rows = static_cast<const int32_t*>(range_rows);
  a.direct_rows = static_cast<const int32_t*>(direct_rows);
  a.stage_take = static_cast<const int32_t*>(stage_take);
  a.stage_scale = static_cast<const float*>(stage_scale);
  a.hot_ids = static_cast<const int32_t*>(hot_ids);
  a.col_scale = static_cast<const float*>(col_scale);
  a.row_scale = static_cast<const float*>(row_scale);
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
  const dim3 block(kThreads);
  if (d % 4 == 0 && aligned16(x) && aligned16(out)) {
    a.width = d / 4;
    const int64_t slabs = (a.width + kWarp - 1) / kWarp;
    if (slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    panel_spmm_kernel<float4, 1><<<dim3(static_cast<unsigned>(n_tiles),
                                        static_cast<unsigned>(slabs)),
                                   block, 0, s>>>(a);
  } else {
    a.width = d;
    const int64_t slabs = (d + 2 * kWarp - 1) / (2 * kWarp);
    if (slabs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    panel_spmm_kernel<float, 2><<<dim3(static_cast<unsigned>(n_tiles),
                                       static_cast<unsigned>(slabs)),
                                  block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
