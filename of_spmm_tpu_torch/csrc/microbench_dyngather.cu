// Hand-written Hopper (sm_90a) kernels of the dynamic-gather probe
// (of_spmm_tpu_torch/tools/microbench_dyngather.py), one per TPU kernel of
// tools/microbench_dyngather.py (pallas_call line):
//
//   take_along  _run (:54): out[t, l] = table[idx[t, l], l] for every lane l
//               of 128 (jnp.take_along_axis on axis 0), for the tool's eq, ne
//               and bcast index shapes. The TPU grid runs `steps` identical
//               passes over the same blocks; one launch here runs `steps`
//               passes too, each re-reading idx and the table (a compiler
//               barrier keeps a pass from reusing the last one's loads), so
//               the tool's rate Tn steps / t means what it meant. One thread
//               per element; the table (at most 16 MB) stays in L2.
//   smem_cap    vmem_cap (:85): x (8, 128) float32 copied through a dynamic
//               shared-memory buffer of nbytes (into its top 4 KB, so the
//               whole buffer must be addressable) and back out. The TPU tool
//               probes the largest VMEM scratch that compiles; the Hopper
//               limit is cudaDevAttrMaxSharedMemoryPerBlockOptin (232,448
//               bytes on the H100), and a larger buffer fails at
//               cudaFuncSetAttribute, which ofs_smem_cap returns.
//
// What bounds them on the H100 (utils/roofline.py): bytes, one pass's
// idx, table elements and output for take_along (about 2 MB: under a
// microsecond at 3.35 TB/s, against `steps` passes of L2 reads), x in and
// out for smem_cap.
//
// An index outside the table stops take_along with a device-side assertion.

#undef NDEBUG  // the index check below is an assert and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kTile4 = 8 * kD / 4;  // x and out: 8 x 128 float32, 256 float4

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const int32_t* idx, const float* table, float* out, int64_t n, int64_t C,
                  int steps) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int l = static_cast<int>(e % kD);
  for (int s = 0; s < steps; ++s) {
    const int32_t c = idx[e];
    assert(c >= 0 && c < C);
    out[e] = table[static_cast<int64_t>(c) * kD + l];
    asm volatile("" ::: "memory");  // the next pass loads anew
  }
}

__global__ void __launch_bounds__(kThreads)
smem_cap_kernel(const float4* __restrict__ x, float4* __restrict__ out, int nbytes) {
  extern __shared__ float4 buf[];
  const int top = nbytes / 16 - kTile4;
  for (int e = threadIdx.x; e < kTile4; e += kThreads) buf[top + e] = x[e];
  __syncthreads();
  for (int e = threadIdx.x; e < kTile4; e += kThreads) out[e] = buf[top + e];
}

}  // namespace

extern "C" {

// idx int32 (n / 128, 128), table float32 (C, 128), out float32 like idx.
// Returns a cudaError_t.
int ofs_take_along(const void* idx, const void* table, void* out, int64_t n, int64_t C, int steps,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (C <= 0 || steps <= 0 || n % kD != 0) return static_cast<int>(cudaErrorInvalidValue);
  take_along_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), n, C, steps);
  return static_cast<int>(cudaGetLastError());
}

// x, out float32 (8, 128); nbytes of dynamic shared memory, a multiple of
// 16 and at least 4096. Returns a cudaError_t: cudaErrorInvalidValue from
// cudaFuncSetAttribute where nbytes exceeds the card's opt-in limit.
int ofs_smem_cap(const void* x, void* out, int nbytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbytes < kTile4 * 16 || nbytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(smem_cap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // launched nothing: clear it for the next launch's check
    return static_cast<int>(err);
  }
  smem_cap_kernel<<<1, kThreads, nbytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), nbytes);
  return static_cast<int>(cudaGetLastError());
}

// The card's cudaDevAttrMaxSharedMemoryPerBlockOptin into *value.
int ofs_smem_optin(int device, int* value) {
  return static_cast<int>(
      cudaDeviceGetAttribute(value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
