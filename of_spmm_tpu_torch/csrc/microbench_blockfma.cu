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
// Design of A: one block of 8 warps per step, so every block owns its own
// 8 output rows and no two blocks write the same memory. Warp j computes
// row 8r + j, each lane 4 columns as one float4, and walks the K slots in
// order, as the TPU's unrolled loop does (fused multiply-adds: one
// rounding where the TPU takes two). The step's starts and w are first
// copied to shared memory, so each slot's index is a broadcast read. The
// 4 MB tier stays in the 50 MB L2 across blocks.
//
// Design of B: each slot names one row c of the tier and one output row
// c % 8, so a warp that walks all K slots for its row skips 7 of 8 and,
// with the branch in its loop, keeps about one load in flight. Here one
// block of 8 warps per step stages the step's K starts and vals in shared
// memory in slot order (one coalesced read of the step's contiguous
// (8, K / 8) block, one barrier); then warp j bins its own slots: 32
// slots a ballot, each hit writing its slot number to the warp's list at
// the count of hits before it, so the list keeps slot order. The warp then
// walks only its list, about K / 8 slots, kInFlight tier rows loaded into
// registers before their fused multiply-adds run in slot order. Every row
// is stored once, 0 where no slot names it. No barrier after the staging:
// each warp's list is its own. (On the card, 2 or 4 steps a block and 2,
// 6, 8 or 16 rows in flight were slower.) Every slot reads its 512-byte
// row out of L2 (rows repeat at random across steps), 537 MB at the
// tool's defaults: that read, not HBM, bounds B.
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
constexpr int kInFlight = 4;    // B: tier rows a warp loads before adding them

// variant A; w is (8R, K) float32
__global__ void __launch_bounds__(kThreads)
blockfma_a_kernel(const int32_t* __restrict__ starts, const float* __restrict__ w,
                  const float4* __restrict__ tier, float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_start = reinterpret_cast<int32_t*>(smem_raw);  // (K,) in slot order
  float* s_w = reinterpret_cast<float*>(s_start + K);       // (8, K)
  const int64_t r = blockIdx.x;
  const int kk = K / kRows;
  for (int e = threadIdx.x; e < K; e += kThreads) {
    // slot k = 8 * (k / 8) + k % 8 reads row 8r + k % 8, column k / 8
    const int64_t at = (r * kRows + e % kRows) * kk + e / kRows;
    const int32_t s = starts[at];
    assert(s >= 0 && s + kRows <= C);
    s_start[e] = s;
  }
  for (int e = threadIdx.x; e < kRows * K; e += kThreads) {
    s_w[e] = w[r * kRows * K + e];
  }
  __syncthreads();

  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float wk = s_w[j * K + k];
    const float4 v = tier[static_cast<int64_t>(s_start[k] + j) * (kD / 4) + lane];
    acc.x = fmaf(wk, v.x, acc.x);
    acc.y = fmaf(wk, v.y, acc.y);
    acc.z = fmaf(wk, v.z, acc.z);
    acc.w = fmaf(wk, v.w, acc.w);
  }
  out[(r * kRows + j) * (kD / 4) + lane] = acc;
}

// shared memory of B: starts and vals (K each, slot order), then the 8
// warps' lists of slot numbers (K each: a step's slots may all name one
// row)
size_t smem_b(int K) { return static_cast<size_t>(K) * (2 * 4 + kRows * 2); }

// variant B; vals is (8R, K / 8) float32
__global__ void __launch_bounds__(kThreads)
blockfma_b_kernel(const int32_t* __restrict__ starts, const float* __restrict__ vals,
                  const float4* __restrict__ tier, float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_c = reinterpret_cast<int32_t*>(smem_raw);
  float* s_v = reinterpret_cast<float*>(s_c + K);
  const int64_t r = blockIdx.x;
  const int kk = K / kRows;
  // the step's (8, K / 8) block is contiguous: element e is slot
  // (e % kk) * 8 + e / kk
  for (int e = threadIdx.x; e < K; e += kThreads) {
    const int32_t c = starts[r * K + e];
    const float v = vals[r * K + e];
    assert(c >= 0 && c < C);
    const int k = (e % kk) * kRows + e / kk;
    s_c[k] = c;
    s_v[k] = v;
  }
  __syncthreads();

  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint16_t* list = reinterpret_cast<uint16_t*>(s_v + K) + static_cast<size_t>(j) * K;
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool hit = k < K && (s_c[k] & (kRows - 1)) == j;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = static_cast<uint16_t>(k);
    n += __popc(m);
  }
  __syncwarp();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += kInFlight) {
    float4 x[kInFlight];
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u < n) {
        const int k = list[i0 + u];
        v[u] = s_v[k];
        x[u] = __ldg(tier + static_cast<int64_t>(s_c[k]) * (kD / 4) + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u < n) {
        acc.x = fmaf(v[u], x[u].x, acc.x);
        acc.y = fmaf(v[u], x[u].y, acc.y);
        acc.z = fmaf(v[u], x[u].z, acc.z);
        acc.w = fmaf(v[u], x[u].w, acc.w);
      }
    }
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
  auto* s = static_cast<const int32_t*>(starts);
  auto* wv = static_cast<const float*>(w);
  auto* t = static_cast<const float4*>(tier);
  auto* o = static_cast<float4*>(out);
  if (variant == 0) {
    const size_t smem = sizeof(int32_t) * K + sizeof(float) * kRows * K;
    err = cudaFuncSetAttribute(blockfma_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_a_kernel<<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  } else {
    if (K > 0xffff) return static_cast<int>(cudaErrorInvalidValue);  // uint16 slot numbers
    const size_t smem = smem_b(K);
    err = cudaFuncSetAttribute(blockfma_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_b_kernel<<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
