// Hand-written Hopper (sm_90a) kernels of the block gather-FMA
// microbenchmark (of_spmm_tpu_torch/tools/microbench_blockfma.py).
//
// blockfma_a replaces tools/microbench_blockfma.py::bench_A's kernel
// (pallas_call at :61). Per step r (an 8-row output block) and slot k < K:
//     out[8r + j, :] += w[8r + j, k] * tier[s_k + j, :],  j < 8,
// with s_k = starts[8r + k % 8, k / 8]: an unaligned 8-row block of the
// tier, weighted row by row.
//
// blockfma_b replaces bench_B's kernel (pallas_call at :98). Per step r and
// slot k, with c = starts[8r + k % 8, k / 8] and v = vals[8r + k % 8, k / 8]:
//     out[8r + c % 8, :] += v * tier[c, :].
// The TPU loads the aligned 8-row block holding row c and multiplies all
// 8 sublanes, 7 of them by 0; here only row c is read and added.
//
// What bounds them on the H100: A is bound by its operations (2 K * 8 * 128
// flops a step, 2.15 GFLOP at the tool's defaults, 0.032 ms at 67 TFLOP/s
// fp32) over its bytes (w, starts, tier and out once: 58.7 MB, 0.0175 ms);
// B by its bytes (starts, vals, tier and out once: 29.4 MB, 0.0088 ms).
// utils/roofline.py blockfma_work counts both.
//
// Design: one block of 8 warps per step, so every block owns its own 8
// output rows and no two blocks write the same memory. Warp j computes
// row 8r + j, each lane 4 columns as one float4, and walks the K slots in
// order, as the TPU's unrolled loop does (fused multiply-adds: one
// rounding where the TPU takes two). The step's starts (and w or vals) are
// first copied to shared memory, so each slot's index is a broadcast read.
// The 4 MB tier stays in the 50 MB L2 across blocks. In B each warp skips
// the slots whose row c % 8 is not its own (a warp-uniform branch).
//
// A start outside the tier stops the kernel with a device-side assertion.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 128;         // tier and output width
constexpr int kRows = 8;        // output rows per step
constexpr int kThreads = kRows * 32;

// kA: variant A (w is (8R, K) float32) or B (w holds vals, (8R, K/8)).
template <bool kA>
__global__ void __launch_bounds__(kThreads)
blockfma_kernel(const int32_t* __restrict__ starts, const float* __restrict__ w,
                const float4* __restrict__ tier, float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_start = reinterpret_cast<int32_t*>(smem_raw);  // (K,) in slot order
  float* s_w = reinterpret_cast<float*>(s_start + K);       // A: (8, K); B: (K,)
  const int64_t r = blockIdx.x;
  const int kk = K / kRows;
  for (int e = threadIdx.x; e < K; e += kThreads) {
    // slot k = 8 * (k / 8) + k % 8 reads row 8r + k % 8, column k / 8
    const int64_t at = (r * kRows + e % kRows) * kk + e / kRows;
    const int32_t s = starts[at];
    assert(s >= 0 && (kA ? s + kRows <= C : s < C));
    s_start[e] = s;
    if (!kA) s_w[e] = w[at];
  }
  if (kA) {
    for (int e = threadIdx.x; e < kRows * K; e += kThreads) {
      s_w[e] = w[r * kRows * K + e];
    }
  }
  __syncthreads();

  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const int s = s_start[k];
    if (!kA && (s & (kRows - 1)) != j) continue;
    const float wk = kA ? s_w[j * K + k] : s_w[k];
    const float4 v = tier[static_cast<int64_t>(kA ? s + j : s) * (kD / 4) + lane];
    acc.x = fmaf(wk, v.x, acc.x);
    acc.y = fmaf(wk, v.y, acc.y);
    acc.z = fmaf(wk, v.z, acc.z);
    acc.w = fmaf(wk, v.w, acc.w);
  }
  out[(r * kRows + j) * (kD / 4) + lane] = acc;
}

}  // namespace

extern "C" {

// variant 0 (A) or 1 (B). starts int32 (8R, K/8); w float32 (8R, K) for A,
// vals float32 (8R, K/8) for B; tier float32 (C, 128); out float32
// (8R, 128), every row written. Contiguous device arrays, K a multiple of
// 8. Returns a cudaError_t.
int ofs_blockfma(int variant, const void* starts, const void* w, const void* tier, void* out,
                 int64_t R, int K, int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  if (K <= 0 || K % kRows != 0 || R > 0x7fffffff || C <= 0 || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int32_t) * K + sizeof(float) * (variant == 0 ? kRows * K : K);
  auto* s = static_cast<const int32_t*>(starts);
  auto* wv = static_cast<const float*>(w);
  auto* t = static_cast<const float4*>(tier);
  auto* o = static_cast<float4*>(out);
  if (variant == 0) {
    err = cudaFuncSetAttribute(blockfma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_kernel<true><<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  } else {
    err = cudaFuncSetAttribute(blockfma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_kernel<false><<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
