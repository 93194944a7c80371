// Hand-written Hopper (sm_90a) kernels of the fused-step microbenchmark
// (of_spmm_tpu_torch/tools/microbench_mxu.py).
//
// mxu_step replaces tools/microbench_mxu.py::run's kernel (pallas_call at
// :88), one template instance per variant. The TPU sums one output tile
// over S sequential grid steps of G groups of 128 lanes, on a window of
// 64 blocks of 128 bf16 rows of width 256 (win). Written as the function
// each variant computes, with lane l < 128 of group g of step i:
//   noop            out[0, :]      += lidx[iG, :] (as float)
//   winread         out[l, :]      += W(blk[i, g], l)
//   winstat         out[l, :]      += W(g, l)
//   rawdyn          out[l, :]      += W(blk[i, g], lidx[iG + g, l])
//   rawstat         out[l, :]      += W(g, lidx[iG + g, l])
//   chain2          out[lrow[iG + g, l], :] += W(blk[i, g], lidx[iG + g, l])
// where W(b, u) = win[128 b + u, :128] + win[128 b + u, 128:] in float32
// (the TPU adds the two 128-column halves of its accumulator at the end of
// each step; here each lane adds its halves first). The tile has 512 rows
// for chain2 and 128 for the others. The TPU's one-hot matmuls select rows
// exactly, so the variants differ in how a row is found (a whole block,
// a gathered row) and where it goes (its own row, a scattered row): the
// tool's question, whether a fused step's cost is in the gather or in the
// scatter.
//
// What bounds it on the H100: operations, at 2 adds per (lane, column):
// 2,000 x 8 x 128 lanes x 256 = 0.52 GFLOP at the tool's defaults, 0.0078 ms
// at 67 TFLOP/s fp32, over the bytes (win, lidx, lrow, blk and out once:
// 20.7 MB, 0.0062 ms). utils/roofline.py mxu_work counts both.
//
// Design: the TPU carries the tile across its sequential grid; blocks here
// run in parallel. The steps are cut into chunks, one block per (chunk,
// 64-column half of the tile), so chain2's 512 x 128 float32 tile (256 KB,
// more than a block's 227 KB of shared memory) is held as two 128 KB
// halves. Each block keeps its half tile in shared memory, its 8 warps
// take the chunk's (step, group) items in turn, and a warp walks the 128
// lanes of an item: each thread holds 4 lanes' indices, broadcast with
// shuffles, and reads 2 columns of each half of the lane's window row (two
// bf16 pairs from L2: the 4 MB window stays there) and adds their sum into
// the lane's tile row with shared-memory atomics (lanes of one item, and
// items of other warps, may share a row). At the end each block adds its
// half tile into out with float4 atomics in global memory; the wrapper has
// zeroed out. The sums are taken in another order than on the TPU.
//
// A window block or row outside the window, or a tile row outside the
// tile, stops the kernel with a device-side assertion.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 128;          // lanes per group, rows per window block, tile width
constexpr int kWin = 256;        // window row width (bf16)
constexpr int kHalf = kL / 2;    // tile columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kNoop = 0, kWinread = 1, kWinstat = 2, kRawdyn = 3, kRawstat = 4, kChain2 = 5 };

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t bits) {
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}

struct Args {
  const int32_t* blk;    // (S, G)
  const int32_t* lidx;   // (S G, 128)
  const int32_t* lrow;   // (S G, 128)
  const uint32_t* win;   // (win_rows, 256) bf16, read as bf16 pairs
  float* out;            // (rows, 128) float32, zeroed
  int64_t S, win_rows;
  int G, rows, nchunk;
};

// noop: thread c of each chunk's block sums lidx[iG, c] over its steps
__global__ void __launch_bounds__(kL) noop_kernel(const Args a) {
  const int64_t i0 = a.S * blockIdx.x / a.nchunk, i1 = a.S * (blockIdx.x + 1) / a.nchunk;
  float acc = 0.f;
  for (int64_t i = i0; i < i1; ++i) {
    acc += static_cast<float>(a.lidx[i * a.G * kL + threadIdx.x]);
  }
  atomicAdd(a.out + threadIdx.x, acc);
}

template <int V>
__global__ void __launch_bounds__(kThreads) mxu_kernel(const Args a) {
  extern __shared__ float tile[];  // (rows, 64): this block's column half
  const int half = blockIdx.y;
  for (int e = threadIdx.x; e < a.rows * kHalf; e += kThreads) tile[e] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t i0 = a.S * blockIdx.x / a.nchunk, i1 = a.S * (blockIdx.x + 1) / a.nchunk;
  const int64_t items = (i1 - i0) * a.G;
  // this thread's two columns of each window half
  const int col = half * kHalf + 2 * lane;
  for (int64_t it = warp; it < items; it += kWarps) {
    const int64_t i = i0 + it / a.G;
    const int g = static_cast<int>(it % a.G);
    const int64_t lanes = (i * a.G + g) * kL;
    int64_t b = g;
    if (V == kWinread || V == kRawdyn || V == kChain2) b = a.blk[i * a.G + g];
    assert(b >= 0 && (b + 1) * kL <= a.win_rows);
    int src[kL / 32], dst[kL / 32];
#pragma unroll
    for (int q = 0; q < kL / 32; ++q) {
      const int l = q * 32 + lane;
      src[q] = (V == kWinread || V == kWinstat) ? l : a.lidx[lanes + l];
      dst[q] = V == kChain2 ? a.lrow[lanes + l] : l;
      assert(src[q] >= 0 && src[q] < kL && dst[q] >= 0 && dst[q] < a.rows);
    }
#pragma unroll
    for (int q = 0; q < kL / 32; ++q) {
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int u = __shfl_sync(kFull, src[q], j);
        const int r = __shfl_sync(kFull, dst[q], j);
        const uint32_t* row = a.win + (b * kL + u) * (kWin / 2);
        const float2 lo = bf16x2_to_float2(__ldg(row + col / 2));
        const float2 hi = bf16x2_to_float2(__ldg(row + (kL + col) / 2));
        float* t = tile + r * kHalf + 2 * lane;
        atomicAdd(t, lo.x + hi.x);
        atomicAdd(t + 1, lo.y + hi.y);
      }
    }
  }
  __syncthreads();
  // this block's half tile into out, one float4 atomic per thread and step
  for (int e = threadIdx.x; e < a.rows * (kHalf / 4); e += kThreads) {
    const int r = e / (kHalf / 4), c4 = e % (kHalf / 4);
    const float4 v = reinterpret_cast<const float4*>(tile)[e];
    atomicAdd(reinterpret_cast<float4*>(a.out + static_cast<int64_t>(r) * kL + half * kHalf) + c4,
              v);
  }
}

template <int V>
int launch(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(mxu_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_kernel<V><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant 0-5 as above. blk int32 (S, 1, G); lidx and lrow int32
// (S G, 128); win bf16 bits (win_rows, 256); out float32 (rows, 128), zeroed
// by the caller (rows = 512 for chain2, 128 otherwise). nchunk: the number
// of step chunks (blocks per column half). Contiguous device arrays.
// Returns a cudaError_t.
int ofs_mxu_step(int variant, const void* blk, const void* lidx, const void* lrow,
                 const void* win, void* out, int64_t S, int G, int64_t win_rows, int rows,
                 int nchunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0) return 0;
  if (G <= 0 || rows <= 0 || rows > 512 || nchunk <= 0 || nchunk > S || nchunk > 65535 ||
      win_rows % kL != 0 || variant < 0 || variant > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.blk = static_cast<const int32_t*>(blk);
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.win = static_cast<const uint32_t*>(win);
  a.out = static_cast<float*>(out);
  a.S = S;
  a.win_rows = win_rows;
  a.G = G;
  a.rows = rows;
  a.nchunk = nchunk;
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == kNoop) {
    noop_kernel<<<static_cast<unsigned>(nchunk), kL, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(nchunk), 2);
  const size_t smem = sizeof(float) * rows * kHalf;
  switch (variant) {
    case kWinread: return launch<kWinread>(a, grid, smem, st);
    case kWinstat: return launch<kWinstat>(a, grid, smem, st);
    case kRawdyn: return launch<kRawdyn>(a, grid, smem, st);
    case kRawstat: return launch<kRawstat>(a, grid, smem, st);
    default: return launch<kChain2>(a, grid, smem, st);
  }
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
