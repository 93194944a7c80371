// Hand-written Hopper (sm_90a) kernels of the gather microbenchmark
// (of_spmm_tpu_torch/tools/microbench_gather.py), one per TPU kernel of
// tools/microbench_gather.py (pallas_call line):
//
//   vmem_loop    bench_vmem_loop (:138): out[o] = sum_k vals[o, k] tier[cols[o, k]],
//                K = 128, the tier (C, 128) float32 resident.
//                ell_reduce_kernel: one warp per output row, the row's
//                indices and values loaded 32 at a time and broadcast with
//                a shuffle, the sum in k order with fused multiply-adds, the
//                tier read through L2. Exported as ofs_gather_ell_reduce,
//                which also serves take_fused (csrc/microbench_gather2.cu's
//                tool, K = 8).
//   vmem_take    bench_vmem_take (:175): out[t] = tier[cols[t]].
//   onehot       bench_onehot_mxu (:219): out[t] = sum_c [cols[t] == c] tier[c],
//                that is f32(tier[cols[t]]), an index outside [0, C) giving a
//                zero row. The TPU forms it as a (TILE, C) x (C, 128) one-hot
//                product on its matrix unit; its cost grows with C while the
//                function is a row gather, so here it is one.
//                Both: csrc/gather.cuh's row_gather_kernel<Tier, kZeroFill>
//                (one thread per float4 of the output, the tier read through
//                L1 / L2, a bfloat16 tier 8 bytes a thread and widened, the
//                512 MB output written with streaming stores), with one
//                table and no base: the template that onehot_pair and
//                window_pair (csrc/microbench_gather2.cu) instantiate too.
//                vmem_take asserts its index, onehot stores a zero row.
//   block_slice  bench_block_slice (:263): out[8i + j] = sum_{r < 8, k < K}
//                tier[starts[8i + r, k] + j], unaligned 8-row blocks.
//                block_slice_kernel below: one block per 8-row output step.
//   row_dma      bench_row_dma (:314): out[o] = sum_{m < 16} table[cols.flat[16 o + m]]
//                from a 1 GiB table in device memory. row_sum_async_kernel:
//                W rows in flight per warp, each lane copying its 16 bytes
//                of W rows into a shared-memory ring W rows deep (cp.async,
//                one commit group), the warp waiting for the wave and adding
//                it: the Hopper form of the TPU's W-deep DMA waves. Exported
//                as ofs_gather_row_sum, which also serves dma_deep (128 rows
//                an output row).
//
// What bounds them on the H100 (utils/roofline.py counts each from its
// inputs): bytes. vmem_take writes 512 MB at the tool's defaults; vmem_loop
// moves ~16 MB of indices, values, tier and output, though its warps read
// 512 MB of tier rows from L2; row_dma reads 128 MB of random table rows;
// onehot writes its 512 MB output. The C x 128 one-hot multiply-adds per
// row that the TPU kernel prescribes are reported beside the bound as the
// TPU's count; this kernel performs none.
//
// An index outside the table stops vmem_loop, vmem_take, block_slice and
// row_dma with a device-side assertion; onehot's zero row is its result.

#include "gather.cuh"

namespace {

using namespace ofs_gather;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void fma4(float4& a, const float w, const float4 b) {
  a.x = fmaf(w, b.x, a.x);
  a.y = fmaf(w, b.y, a.y);
  a.z = fmaf(w, b.z, a.z);
  a.w = fmaf(w, b.w, a.w);
}

// The card's opt-in dynamic shared memory per block, in bytes.
cudaError_t smem_optin(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// ---- ELL gather-reduce from L2 -------------------------------------------------

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_reduce_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                  const float4* __restrict__ table, float4* __restrict__ out, int64_t n_out,
                  int K, int64_t C) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (o >= n_out) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int32_t* c_row = cols + o * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    int32_t c = 0;
    float v = 0.f;
    if (lane < n) {
      c = c_row[k0 + lane];
      assert(c >= 0 && c < C);
      v = vals[o * K + k0 + lane];
    }
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int64_t ck = __shfl_sync(kFull, c, k);
      fma4(acc, __shfl_sync(kFull, v, k), __ldg(table + ck * kD4 + lane));
    }
  }
  out[o * kD4 + lane] = acc;
}

// ---- ELL row sum from device memory, W rows in flight per warp ------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_wave() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's warps each own a ring of W rows (W * 512 bytes of dynamic
// shared memory): as many as fit the card's opt-in limit, 1 to 4.
int warps_per_block(int W, int optin_bytes) {
  const int fit = optin_bytes / (W * kD * 4);
  return fit < 1 ? 1 : (fit > 4 ? 4 : fit);
}

__global__ void __launch_bounds__(4 * 32)
row_sum_async_kernel(const int32_t* __restrict__ cols, const float4* __restrict__ table,
                     float4* __restrict__ out, int64_t n_out, int K, int W, int64_t C) {
  extern __shared__ float4 ring[];  // (warps, W, 32)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (o >= n_out) return;  // the whole warp; no block-wide barrier below
  float4* my = ring + static_cast<int64_t>(warp) * W * kD4;
  const int32_t* c_row = cols + o * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += W) {
    const int n = min(W, K - k0);
    for (int j0 = 0; j0 < n; j0 += 32) {  // issue the wave, 32 indices at a time
      const int m = min(32, n - j0);
      int32_t c = 0;
      if (lane < m) {
        c = c_row[k0 + j0 + lane];
        assert(c >= 0 && c < C);
      }
      for (int j = 0; j < m; ++j) {
        const int64_t cj = __shfl_sync(kFull, c, j);
        cp_async16(my + (j0 + j) * kD4 + lane, table + cj * kD4 + lane);
      }
    }
    cp_async_wait_wave();  // each lane reads back only the bytes it copied
    for (int j = 0; j < n; ++j) add4(acc, my[j * kD4 + lane]);
    __syncwarp();  // the wave is read before the next one is issued
  }
  out[o * kD4 + lane] = acc;
}

// Block i sums the 8 K blocks of step i into output rows 8i .. 8i + 7:
// warp j adds tier[s + j] for every start s, in the TPU's order (k, then r).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_slice_kernel(const int32_t* __restrict__ starts, const float4* __restrict__ tier,
                   float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ int32_t s_start[];  // (K, 8): slot k * 8 + r
  const int64_t i = blockIdx.x;
  for (int e = threadIdx.x; e < 8 * K; e += kWarpsPerBlock * 32) {
    const int r = e / K, k = e % K;
    const int32_t s = starts[i * 8 * K + e];
    assert(s >= 0 && s + 8 <= C);
    s_start[k * 8 + r] = s;
  }
  __syncthreads();
  const int j = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int e = 0; e < 8 * K; ++e) {
    add4(acc, __ldg(tier + static_cast<int64_t>(s_start[e] + j) * kD4 + lane));
  }
  out[(i * 8 + j) * kD4 + lane] = acc;
}

}  // namespace

extern "C" {

// Every array is a contiguous device array, float4-aligned where it holds
// rows; each function returns a cudaError_t.

// cols int32 (n_out, K), vals float32 (n_out, K), tier float32 (C, 128),
// out float32 (n_out, 128).
int ofs_gather_ell_reduce(const void* cols, const void* vals, const void* tier, void* out,
                          int64_t n_out, int K, int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (K <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ell_reduce_kernel<<<blocks_for(n_out, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float4*>(tier), static_cast<float4*>(out), n_out, K, C);
  return static_cast<int>(cudaGetLastError());
}

// cols int32 (T,), tier float32 (C, 128), out float32 (T, 128).
int ofs_gather_vmem_take(const void* cols, const void* tier, void* out, int64_t T, int64_t C,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_row_gather<float, false>(cols, nullptr, T, tier, nullptr, out, T, C, C,
                                         static_cast<cudaStream_t>(stream));
}

// bf16: tier bfloat16 (else float32) (C, 128); cols int32 (T,); out
// float32 (T, 128).
int ofs_gather_onehot(int bf16, const void* cols, const void* tier, void* out, int64_t T,
                      int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row_gather<__nv_bfloat16, true>(cols, nullptr, T, tier, nullptr, out, T,
                                                       C, C, st)
              : launch_row_gather<float, true>(cols, nullptr, T, tier, nullptr, out, T, C, C, st);
}

// starts int32 (8 R, K), tier float32 (C, 128), out float32 (8 R, 128).
int ofs_gather_block_slice(const void* starts, const void* tier, void* out, int64_t R, int K,
                           int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  int optin = 0;
  err = smem_optin(device, &optin);
  if (err != cudaSuccess) return fail(err);
  const size_t smem = sizeof(int32_t) * 8 * static_cast<size_t>(K);
  if (K <= 0 || C < 8 || R > 0x7fffffff || smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(block_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  block_slice_kernel<<<static_cast<unsigned>(R), kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const float4*>(tier),
      static_cast<float4*>(out), K, C);
  return static_cast<int>(cudaGetLastError());
}

// cols int32 (n_out K,), table float32 (C, 128), out float32 (n_out, 128);
// W rows in flight per warp, 1 <= W <= 256.
int ofs_gather_row_sum(const void* cols, const void* table, void* out, int64_t n_out, int K,
                       int W, int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (K <= 0 || W <= 0 || W > 256 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = smem_optin(device, &optin);
  if (err != cudaSuccess) return fail(err);
  const int warps = warps_per_block(W, optin);
  const size_t smem = static_cast<size_t>(warps) * W * kD * sizeof(float);
  err = cudaFuncSetAttribute(row_sum_async_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  row_sum_async_kernel<<<blocks_for(n_out, warps), warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float4*>(table),
      static_cast<float4*>(out), n_out, K, W, C);
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
