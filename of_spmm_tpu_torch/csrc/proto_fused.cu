// Hand-written Hopper (sm_90a) kernels of the fused-engine prototype
// (of_spmm_tpu_torch/tools/proto_fused.py).
//
// proto_fused replaces tools/proto_fused.py::_kernel (pallas_call at :131)
// and computes the function of its numpy oracle `reference` (:162). Per
// output tile t < TILES: the window of S staged rows is X[scols[t SPT + k]]
// for the SPT staging chunks k of DELTA = S / SPT rows each, each value v
// taken as bf16(v) + bf16(v - bf16(v)) (the TPU's hi/lo pair, rounded to
// nearest even); for each of the tile's SPT compute steps i (steps SPT (t+1)
// to SPT (t+2) - 1) and G = T / 128 groups g, lane l adds staged row
// u = 128 blk[i, g] + lidx[iG + g, l] into row lrow[iG + g, l] of the tile's
// R rows. (The TPU kernel as written builds its row one-hot along the
// wrong axis, :98-100, and disagrees with its oracle; this follows the
// oracle.) Three modes:
//   fused    each lane finds its X row through both levels of the index
//            (staged row u is slot u % DELTA of chunk u / DELTA of scols),
//            so no window is staged at all;
//   dma      stages only: writes every tile's window of X rows (TILES, S,
//            128) float32 into a staging buffer; the output is zeros, as
//            the TPU's dma mode leaves it (:105-108);
//   compute  the lane work alone, on a window that dma staged before it.
// compute after dma gives fused's result; the TPU's compute mode reads
// scratch that nothing wrote and has no defined result.
//
// What bounds it on the H100: bytes. fused must read the X rows its lanes
// reference (1,014,477 distinct rows of 512 bytes at the tool's defaults:
// the tool's distinct_rows), the index arrays and write the 33.5 MB
// output: 0.1754 ms at 3.35 TB/s; its adds (2 per lane and column) take
// 0.013 ms at 67 TFLOP/s. dma must read the staged X rows and write the
// 1.05 GB buffer; compute reads the staged rows its lanes reference.
// utils/roofline.py proto_fused_work counts each from the run's data.
//
// Design. The TPU stages each tile's 16,000-row window in VMEM (24.6 MB of
// scratch with its hi/lo copy); a block has 227 KB. So fused does not
// stage: it gathers through the two-level index, as the expansion kernels
// gather through their provenance. Each tile's 25,600 lanes add into its
// 512 rows, about 50 lanes a row, so each output row is summed where it
// is computed, in registers, with no device-memory atomics and no zero
// fill. Two launches a call:
//   sort_kernel  one block of 1,024 threads per (tile, slice of kSortRows
//                rows; one slice at the defaults): reads the tile's lrow
//                (coalesced, 4 lanes a thread), counts the lanes of each
//                of its rows and of the rows before its slice
//                (shared-memory atomics), scans the counts into the rows'
//                offsets, then resolves each of its lanes' source (X row
//                through the tile's scols, copied to shared memory where
//                they fit, or staged row) and places it at its row's next
//                slot of the tile's order, in shared memory where the
//                slice's lanes fit (the tile's 100 KB at the defaults),
//                copied out coalesced. A counting sort: the slot atomics
//                make it unstable, so the order of a row's adds, and its
//                last bits, vary from run to run. Writes the offsets
//                (TILES, R + 1) and the order (TILES, lanes), 13 MB at the
//                defaults, scratch the wrapper allocates.
//   rows_kernel  one warp per output row, rows tile-major: reads its
//                row's slots of the order 32 at a time (coalesced) and
//                adds their rows, kInFlight in flight, each thread 4
//                columns (one float4) split into the hi/lo pair and
//                summed in registers; then stores the row once, zeros
//                where no lane selects it. No barrier: every warp runs
//                free.
// Where the time goes (the tool's --kernels, PERF.md): rows_kernel's
// warps read the 3.28M lane-rows, 1.68 GB, out of L2 at about 5.4 TB/s,
// and that read rate, not HBM, bounds it: compute, whose staged rows
// repeat less across tiles, takes as long. A tile's lanes name about
// 10,200 distinct staged rows (5.2 MB), each read 2.5 times, so the
// repeats hit L2 only while few tiles are in flight; at one row a warp
// (32 warps an SM) about 8 tiles are, and two or four rows a warp (4 or
// 2 tiles, but fewer rows in flight) ran slower. A first design sorted and summed in one launch, a
// block per (tile, slice of 32 or 64 rows) that re-read the tile's lrow
// for each slice and waited at four barriers per chunk of lanes: held by
// those phases' latency, it stayed near the old kernel's time.
// dma: stage_kernel, one block per staging chunk, a warp per row, float4
// copies.
//
// An index outside its array stops the kernel with a device-side assertion.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kL = 128;          // lanes per group, row width
constexpr int kW4 = kL / 4;      // row width in float4
constexpr int kSortThreads = 1024;
constexpr int kSortRows = 512;   // rows a sort block counts
constexpr int kRowWarps = 8;     // warps (output rows) a rows_kernel block
constexpr int kRowBlocks = 4;    // rows_kernel blocks an SM holds at least
constexpr int kInFlight = 4;     // X rows a warp has in flight
constexpr int kStageThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// a sort block's static shared memory, rounded up
constexpr int kSortStaticSmem = (kSortRows + 32 + 2) * 4 + 1024;

// An error of a runtime call (one that launched nothing), after clearing
// it from the runtime's last-error state.
int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

struct Args {
  const int32_t* scols;   // (steps, DELTA)
  const int32_t* lidx;    // (steps G, 128)
  const int32_t* lrow;    // (steps G, 128)
  const int32_t* blk;     // (steps, G)
  const float4* xp;       // (N, 128)
  float4* staged;         // (TILES, S, 128)
  float4* out;            // (TILES R, 128)
  int32_t* order;         // (TILES, lanes): each tile's lane sources by row
  int32_t* offsets;       // (TILES, R + 1): row r's slots [offsets[r], offsets[r + 1])
  int64_t N;
  int R, S, SPT, TILES, DELTA, G, lanes, sort_slices;
  int cap;                // slots of a sort block's shared-memory order
  int scols_smem;         // fused: the sort blocks copy their tile's scols to shared memory
};

// float32 values as bf16(v) + bf16(v - bf16(v)), each rounded to nearest
// even, two at a time
__device__ __forceinline__ float2 hilo2(const float a, const float b) {
  const float2 h = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  const float2 l = __bfloat1622float2(__floats2bfloat162_rn(a - h.x, b - h.y));
  return make_float2(h.x + l.x, h.y + l.y);
}

__device__ __forceinline__ void add_hilo(float4& acc, const float4 v) {
  const float2 xy = hilo2(v.x, v.y), zw = hilo2(v.z, v.w);
  acc.x += xy.x;
  acc.y += xy.y;
  acc.z += zw.x;
  acc.w += zw.y;
}

// The exclusive prefix sum of each thread's x over the block; *total gets
// the block's sum. s_warp holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(const int x, int* s_warp, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kSortThreads / 32 ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += v;
    }
    s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return s_warp[warp] + incl - x;
}

// Block b: tile b / sort_slices, rows r0 .. r0 + kSortRows - 1 of it.
// Places each of the slice's lanes' source (kStaged: staged row t S + u,
// else X row scols[t SPT + u / DELTA, u % DELTA]) at its row's next slot
// of the tile's order: slots [base, base + n) hold the slice's lanes.
// Where n <= a.cap they are placed in shared memory and copied out
// coalesced, else written to their slots directly; the tile's S scols are
// read from a copy in shared memory where a.scols_smem.
template <bool kStaged>
__global__ void __launch_bounds__(kSortThreads) sort_kernel(const Args a) {
  extern __shared__ int32_t s_dyn[];    // a.cap order slots, then S scols
  __shared__ int s_next[kSortRows];     // counts, then each row's next slot
  __shared__ int s_warp[32];
  __shared__ int s_base, s_n;
  const int64_t t = blockIdx.x / a.sort_slices;
  const int r0 = static_cast<int>(blockIdx.x % a.sort_slices) * kSortRows;
  const int nr = min(kSortRows, a.R - r0);
  const int64_t e0 = (t + 1) * static_cast<int64_t>(a.lanes);  // compute step SPT (t + 1)
  const int4* lrow4 = reinterpret_cast<const int4*>(a.lrow + e0);
  const int4* lidx4 = reinterpret_cast<const int4*>(a.lidx + e0);
  const int n4 = a.lanes / 4;
  int32_t* s_order = s_dyn;
  const int32_t* scols = a.scols + t * a.S;  // the tile's staging steps' (S,)
  if (!kStaged && a.scols_smem) {
    int32_t* s_scols = s_dyn + a.cap;
    for (int i = threadIdx.x; i < a.S; i += kSortThreads) s_scols[i] = scols[i];
    scols = s_scols;
  }
  for (int k = threadIdx.x; k < nr; k += kSortThreads) s_next[k] = 0;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  int before = 0;  // lanes of rows below r0
#pragma unroll 4
  for (int f = threadIdx.x; f < n4; f += kSortThreads) {
    const int4 rows = lrow4[f];
    const int rr[4] = {rows.x, rows.y, rows.z, rows.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      assert(rr[q] >= 0 && rr[q] < a.R);
      before += rr[q] < r0;
      const unsigned k = static_cast<unsigned>(rr[q] - r0);
      if (k < static_cast<unsigned>(nr)) atomicAdd(&s_next[k], 1);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) before += __shfl_xor_sync(kFull, before, d);
  if (threadIdx.x % 32 == 0 && before != 0) atomicAdd(&s_base, before);
  __syncthreads();
  // thread i scans rows [i kPer, (i + 1) kPer) of the slice
  constexpr int kPer = (kSortRows + kSortThreads - 1) / kSortThreads;
  int cnt[kPer], own = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = threadIdx.x * kPer + q;
    cnt[q] = k < nr ? s_next[k] : 0;
    own += cnt[q];
  }
  const int base = s_base;
  int at = base + block_exclusive_scan(own, s_warp, &s_n);
  int32_t* offsets = a.offsets + t * (a.R + 1) + r0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = threadIdx.x * kPer + q;
    if (k < nr) {
      s_next[k] = at;
      offsets[k] = at;
    }
    at += cnt[q];
  }
  if (r0 + nr == a.R && threadIdx.x == 0) offsets[nr] = a.lanes;
  __syncthreads();
  const bool in_smem = s_n <= a.cap;  // the block's
  int32_t* order = a.order + t * static_cast<int64_t>(a.lanes);
#pragma unroll 4
  for (int f = threadIdx.x; f < n4; f += kSortThreads) {
    const int4 rows = lrow4[f], lis = lidx4[f];
    const int rr[4] = {rows.x, rows.y, rows.z, rows.w}, li[4] = {lis.x, lis.y, lis.z, lis.w};
    const int b = a.blk[(e0 + 4 * f) / kL];  // the 4 lanes' group's block
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned k = static_cast<unsigned>(rr[q] - r0);
      if (k >= static_cast<unsigned>(nr)) continue;
      const int64_t u = static_cast<int64_t>(b) * kL + li[q];
      assert(li[q] >= 0 && li[q] < kL && u >= 0 && u < a.S);
      int32_t src;
      if (kStaged) {
        src = static_cast<int32_t>(t * a.S + u);
      } else {
        src = scols[u];
        assert(src >= 0 && src < a.N);
      }
      const int slot = atomicAdd(&s_next[k], 1);
      if (in_smem) {
        s_order[slot - base] = src;
      } else {
        order[slot] = src;
      }
    }
  }
  if (!in_smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < s_n; i += kSortThreads) order[base + i] = s_order[i];
}

// Warp w sums output row w of the (TILES R, 128) output from its slots of
// its tile's order.
template <bool kStaged>
__global__ void __launch_bounds__(kRowWarps * 32, kRowBlocks) rows_kernel(const Args a) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  if (row >= static_cast<int64_t>(a.TILES) * a.R) return;  // the whole warp
  const float4* src_rows = kStaged ? a.staged : a.xp;
  const int64_t t = row / a.R;
  const int32_t* off = a.offsets + t * (a.R + 1) + row % a.R;
  const int32_t* order = a.order + t * static_cast<int64_t>(a.lanes);
  const int beg = off[0], end = off[1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = beg; m0 < end; m0 += 32) {
    const int n = min(32, end - m0);
    const int32_t mine = lane < n ? order[m0 + lane] : 0;
    for (int k0 = 0; k0 < n; k0 += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int m = 0; m < kInFlight; ++m) {
        const int64_t s = __shfl_sync(kFull, mine, (k0 + m) % 32);
        if (k0 + m < n) v[m] = __ldg(src_rows + s * kW4 + lane);
      }
#pragma unroll
      for (int m = 0; m < kInFlight; ++m) {
        if (k0 + m < n) add_hilo(acc, v[m]);
      }
    }
  }
  a.out[row * kW4 + lane] = acc;
}

// dma: block i stages chunk i % SPT of tile i / SPT (steps 0 to TILES SPT - 1)
__global__ void __launch_bounds__(kStageThreads) stage_kernel(const Args a) {
  const int64_t i = blockIdx.x;
  const int64_t t = i / a.SPT, k = i % a.SPT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < a.DELTA; j += kStageThreads / 32) {
    const int64_t c = a.scols[i * a.DELTA + j];
    assert(c >= 0 && c < a.N);
    a.staged[(t * a.S + k * a.DELTA + j) * kW4 + lane] = __ldg(a.xp + c * kW4 + lane);
  }
}

}  // namespace

extern "C" {

// mode 0 fused, 1 compute, 2 dma. scols int32 ((TILES + 1) SPT, DELTA);
// lidx, lrow int32 ((TILES + 1) SPT G, 128); blk int32 ((TILES + 1) SPT, 1,
// G); xp float32 (N, 128), N < 2^31; staged float32 (TILES, S, 128), TILES S
// < 2^31, read by compute and written by dma (null for fused); out float32
// (TILES R, 128), every row written by fused and compute, untouched by dma;
// order int32 (TILES, SPT G 128) and offsets int32 (TILES, R + 1), scratch
// of fused and compute (null for dma). Contiguous device arrays. Returns a
// cudaError_t.
int ofs_proto_fused(int mode, const void* scols, const void* lidx, const void* lrow,
                    const void* blk, const void* xp, void* staged, void* out, void* order,
                    void* offsets, int64_t N, int R, int S, int SPT, int TILES, int G, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (TILES == 0) return 0;
  const int64_t lanes = static_cast<int64_t>(SPT) * G * kL;
  const int64_t rows_out = static_cast<int64_t>(TILES) * R;
  const int64_t row_blocks = (rows_out + kRowWarps - 1) / kRowWarps;
  if (mode < 0 || mode > 2 || R <= 0 || S <= 0 || SPT <= 0 || TILES < 0 || G <= 0 ||
      S % SPT != 0 || static_cast<int64_t>(TILES) * SPT * G > 0x7fffffff ||
      lanes > 0x7fffffff || N > 0x7fffffff || static_cast<int64_t>(TILES) * S > 0x7fffffff ||
      row_blocks > 0x7fffffff || (mode != 0 && staged == nullptr) ||
      (mode != 2 && (order == nullptr || offsets == nullptr)) ||
      reinterpret_cast<uintptr_t>(lrow) % 16 != 0 || reinterpret_cast<uintptr_t>(lidx) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.scols = static_cast<const int32_t*>(scols);
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.blk = static_cast<const int32_t*>(blk);
  a.xp = static_cast<const float4*>(xp);
  a.staged = static_cast<float4*>(staged);
  a.out = static_cast<float4*>(out);
  a.order = static_cast<int32_t*>(order);
  a.offsets = static_cast<int32_t*>(offsets);
  a.N = N;
  a.R = R;
  a.S = S;
  a.SPT = SPT;
  a.TILES = TILES;
  a.DELTA = S / SPT;
  a.G = G;
  a.lanes = static_cast<int>(lanes);
  a.sort_slices = (R + kSortRows - 1) / kSortRows;
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    stage_kernel<<<static_cast<unsigned>(TILES * SPT), kStageThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // a sort block's dynamic shared memory: its order (the tile's lanes, or
  // as many as fit), then for fused the tile's scols where they fit too
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return fail(err);
  const int64_t slots = (optin - kSortStaticSmem) / 4;
  a.cap = static_cast<int>(std::min<int64_t>(lanes, slots));
  a.scols_smem = mode == 0 && a.cap + static_cast<int64_t>(S) <= slots;
  const size_t smem = (static_cast<size_t>(a.cap) + (a.scols_smem ? S : 0)) * sizeof(int32_t);
  const auto sort = mode == 0 ? sort_kernel<false> : sort_kernel<true>;
  err = cudaFuncSetAttribute(sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  sort<<<static_cast<unsigned>(TILES) * a.sort_slices, kSortThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == 0) {
    rows_kernel<false><<<static_cast<unsigned>(row_blocks), kRowWarps * 32, 0, st>>>(a);
  } else {
    rows_kernel<true><<<static_cast<unsigned>(row_blocks), kRowWarps * 32, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
