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
//   fused    one launch: each lane finds its X row through both levels of
//            the index (staged row u is slot u % DELTA of chunk u / DELTA
//            of scols), so no window is staged at all;
//   dma      stages only: writes every tile's window of X rows (TILES, S,
//            128) float32 into a staging buffer; the output is zeros, as
//            the TPU's dma mode leaves it (:105-108);
//   compute  the lane work alone, on a window that dma staged before it.
// compute after dma gives fused's result; the TPU's compute mode reads
// scratch that nothing wrote and has no defined result.
//
// What bounds it on the H100: bytes. fused must read the X rows its lanes
// reference (about 1.3 M distinct rows of 512 bytes at the tool's
// defaults), the index arrays and write the 33.5 MB output: about 0.2 ms at
// 3.35 TB/s; its adds (2 per lane and column) take 0.013 ms at 67 TFLOP/s.
// dma must read the staged X rows and write the 1.05 GB buffer; compute
// reads the staged rows its lanes reference. utils/roofline.py
// proto_fused_work counts each from the run's data.
//
// Design: the TPU stages each tile's 16,000-row window in VMEM (24.6 MB of
// scratch with its hi/lo copy); a block has 227 KB. So fused does not
// stage: it gathers through the two-level index, as the expansion kernels
// gather through their provenance. One block of 4 warps per (compute step,
// group): 25,600 blocks at the defaults, every one with 128 lanes, so the
// 128 tiles are spread over all 132 SMs and the work is even. Each thread
// resolves one lane (X row or staged row, tile row); each warp then walks
// its 32 lanes, four rows in flight, each thread on 4 columns (one float4),
// splits each value into its hi/lo pair and adds it into the output row
// with a float4 atomic (lanes of one tile share rows; the wrapper zeroes
// out). dma: one block per staging chunk, a warp per row, float4 copies.
//
// An index outside its array stops the kernel with a device-side assertion.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 128;          // lanes per group, row width
constexpr int kW4 = kL / 4;      // row width in float4
constexpr int kThreads = kL;
constexpr int kInFlight = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* scols;   // (steps, DELTA)
  const int32_t* lidx;    // (steps G, 128)
  const int32_t* lrow;    // (steps G, 128)
  const int32_t* blk;     // (steps, G)
  const float4* xp;       // (N, 128)
  float4* staged;         // (TILES, S, 128)
  float4* out;            // (TILES R, 128), zeroed
  int64_t N;
  int R, S, SPT, TILES, DELTA, G;
};

__device__ __forceinline__ float hilo(float v) {
  const float hi = __bfloat162float(__float2bfloat16_rn(v));
  return hi + __bfloat162float(__float2bfloat16_rn(v - hi));
}

__device__ __forceinline__ float4 hilo(const float4 v) {
  return make_float4(hilo(v.x), hilo(v.y), hilo(v.z), hilo(v.w));
}

// kStaged: read the staged buffer (compute) or X through scols (fused)
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) lanes_kernel(const Args a) {
  const int64_t item = blockIdx.x;            // (compute step, group)
  const int64_t i = a.SPT + item / a.G;       // the compute step
  const int g = static_cast<int>(item % a.G);
  const int64_t t = i / a.SPT - 1;            // its tile
  const int64_t e = (i * a.G + g) * kL + threadIdx.x;
  const int64_t b = a.blk[i * a.G + g];
  const int32_t li = a.lidx[e];
  const int32_t row = a.lrow[e];
  const int64_t u = b * kL + li;
  assert(li >= 0 && li < kL && u >= 0 && u < a.S && row >= 0 && row < a.R);
  int64_t src;
  if (kStaged) {
    src = t * a.S + u;
  } else {
    src = a.scols[(t * a.SPT + u / a.DELTA) * a.DELTA + u % a.DELTA];
    assert(src >= 0 && src < a.N);
  }
  const int64_t dst = t * a.R + row;
  const float4* base = kStaged ? a.staged : a.xp;

  const int lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < 32; j0 += kInFlight) {
    float4 v[kInFlight];
    int64_t d[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int64_t s = __shfl_sync(kFull, src, j0 + q);
      d[q] = __shfl_sync(kFull, dst, j0 + q);
      v[q] = __ldg(base + s * kW4 + lane);
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) atomicAdd(a.out + d[q] * kW4 + lane, hilo(v[q]));
  }
}

// dma: block i stages chunk i % SPT of tile i / SPT (steps 0 to TILES SPT - 1)
__global__ void __launch_bounds__(kThreads) stage_kernel(const Args a) {
  const int64_t i = blockIdx.x;
  const int64_t t = i / a.SPT, k = i % a.SPT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < a.DELTA; j += kThreads / 32) {
    const int64_t c = a.scols[i * a.DELTA + j];
    assert(c >= 0 && c < a.N);
    a.staged[(t * a.S + k * a.DELTA + j) * kW4 + lane] = __ldg(a.xp + c * kW4 + lane);
  }
}

}  // namespace

extern "C" {

// mode 0 fused, 1 compute, 2 dma. scols int32 ((TILES + 1) SPT, DELTA);
// lidx, lrow int32 ((TILES + 1) SPT G, 128); blk int32 ((TILES + 1) SPT, 1,
// G); xp float32 (N, 128); staged float32 (TILES, S, 128), read by compute
// and written by dma (null for fused); out float32 (TILES R, 128), zeroed by
// the caller, added into by fused and compute. Contiguous device arrays.
// Returns a cudaError_t.
int ofs_proto_fused(int mode, const void* scols, const void* lidx, const void* lrow,
                    const void* blk, const void* xp, void* staged, void* out, int64_t N, int R,
                    int S, int SPT, int TILES, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (TILES == 0) return 0;
  if (mode < 0 || mode > 2 || R <= 0 || S <= 0 || SPT <= 0 || TILES < 0 || G <= 0 ||
      S % SPT != 0 || static_cast<int64_t>(TILES) * SPT * G > 0x7fffffff ||
      (mode != 0 && staged == nullptr)) {
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
  a.N = N;
  a.R = R;
  a.S = S;
  a.SPT = SPT;
  a.TILES = TILES;
  a.DELTA = S / SPT;
  a.G = G;
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned lane_blocks = static_cast<unsigned>(static_cast<int64_t>(TILES) * SPT * G);
  if (mode == 0) {
    lanes_kernel<false><<<lane_blocks, kThreads, 0, st>>>(a);
  } else if (mode == 1) {
    lanes_kernel<true><<<lane_blocks, kThreads, 0, st>>>(a);
  } else {
    stage_kernel<<<static_cast<unsigned>(TILES * SPT), kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
