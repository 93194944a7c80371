// Hand-written Hopper (sm_90a) kernels of the dynamic-gather probe
// (of_spmm_tpu_torch/tools/microbench_dyngather.py), one per TPU kernel of
// tools/microbench_dyngather.py (pallas_call line):
//
//   take_along  _run (:54): out[t, l] = table[idx[t, l], l] for every lane l
//               of 128 (jnp.take_along_axis on axis 0), for the tool's eq, ne
//               and bcast index shapes. The TPU grid runs `steps` identical
//               passes over the same blocks, each a gather out of VMEM, and
//               the tool reports the rate Tn steps / t "gathered from VMEM":
//               the passes are the work it measures. Hopper's counterpart of
//               VMEM is shared memory, so one launch here runs `steps`
//               passes out of shared memory; the result is the last pass's.
//   smem_cap    vmem_cap (:85): x (8, 128) float32 copied through a dynamic
//               shared-memory buffer of nbytes (into its top 4 KB, so the
//               whole buffer must be addressable) and back out. The TPU tool
//               probes the largest VMEM scratch that compiles; the Hopper
//               limit is cudaDevAttrMaxSharedMemoryPerBlockOptin (232,448
//               bytes on the H100), and a larger buffer fails at
//               cudaFuncSetAttribute, which ofs_smem_cap returns.
//
// What bounds take_along on the H100 (utils/roofline.py take_along_work):
// the larger of one pass's bytes from device memory (the distinct table
// elements, idx and the output: about 2 MB, under a microsecond at 3.35
// TB/s) and the passes' shared-memory words, steps Tn 128 at 32 words a
// clock on each of 132 SMs at 1,980 MHz (8.36e12 words/s): 0.0080 ms for
// tala_eq (C = T = 2,048, 256 passes). smem_cap: x in and out.
//
// take_along's design: a block stages lanes [l0, l0 + w) of every table
// row into shared memory once with cp.async (16-byte copies where w is a
// multiple of 4), row-major (C, w) with w = `lanes` (the last slice of the
// 128 lanes may be narrower), and takes a range of the gathered rows t:
// its threads load their elements' indices once into registers
// (asserting each), run the passes as shared-memory loads
// (ld.volatile.shared, so that no pass is dropped though only the last
// one's values are stored: one LDS per element and pass in the SASS), and
// store the last pass once. The host picks w = min(16, opt-in shared
// memory / 4C), a multiple of 4 from 4 on: 16 lanes hold C = 2,048 in 128
// KB, and a warp's 32 threads then cover 2 rows of 16 lanes, bank
// (16 c + l) mod 32, at most 2-way conflicted; 4 lanes at C = 8,192, 1 at
// C = 32,768 (whose staging reads one word of each 32-byte sector). The
// slices x row ranges fill the SMs, one block of up to 1,024 threads a
// SM, at most 8 elements a thread. Where C is too large for one lane
// (above 58,112 rows at the H100's 232,448 bytes), the host passes 0 lanes
// and the direct kernel runs instead: every pass re-loads idx[e] and one
// word of a random table row through L1/L2 (a compiler barrier keeps a
// pass from reusing the last one's loads), one thread per element.
//
// An index outside the table stops take_along with a device-side assertion
// on either path.

#undef NDEBUG  // the index check below is an assert and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kTile4 = 8 * kD / 4;  // x and out: 8 x 128 float32, 256 float4
constexpr int kSliceThreads = 1024;
constexpr int kMaxLanes = 16;       // lanes a slice at most
constexpr int kMaxElems = 8;        // elements a thread of a slice block at most

__global__ void __launch_bounds__(kThreads)
take_along_kernel(const int32_t* idx, const float* table, float* out, int64_t n, int64_t C,
                  int steps) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int l = static_cast<int>(e % kD);
  {
    const int32_t c = idx[e];
    assert(c >= 0 && c < C);
  }
  for (int s = 0; s < steps; ++s) {
    const int32_t c = idx[e];
    out[e] = table[static_cast<int64_t>(c) * kD + l];
    asm volatile("" ::: "memory");  // the next pass loads anew
  }
}

// a shared-memory load that is never dropped or merged, where `on`
__device__ __forceinline__ void ld_volatile_shared(float& v, uint32_t addr, uint32_t on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p ld.volatile.shared.f32 %0, [%1];\n}\n"
      : "+f"(v)
      : "r"(addr), "r"(on));
}

// one slice of `lanes` lanes (blockIdx.y) and `t_rows` gathered rows
// (blockIdx.x); E elements a thread at most
template <int E>
__global__ void __launch_bounds__(kSliceThreads, 1)
take_slice_kernel(const int32_t* __restrict__ idx, const float* __restrict__ table,
                  float* __restrict__ out, int64_t Tn, int C, int lanes, int64_t t_rows,
                  int steps) {
  extern __shared__ float s_tab[];  // (C, w): lanes [l0, l0 + w) of every table row
  const int l0 = blockIdx.y * lanes;
  const int w = min(lanes, kD - l0);
  // staged with cp.async, every copy in flight at once: 16 bytes where the
  // slice is whole 16-byte pieces of the row, else 4
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s_tab));
  if (w % 4 == 0) {
    const int q = w / 4;
    for (int e = threadIdx.x; e < C * q; e += blockDim.x) {
      const int c = e / q;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * e),
                   "l"(table + static_cast<int64_t>(c) * kD + l0 + 4 * (e - c * q))
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < C * w; e += blockDim.x) {
      const int c = e / w;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(base + 4u * e),
                   "l"(table + static_cast<int64_t>(c) * kD + l0 + (e - c * w))
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int64_t t0 = blockIdx.x * t_rows;
  const int64_t t1 = Tn < t0 + t_rows ? Tn : t0 + t_rows;
  const int n_el = static_cast<int>((t1 - t0) * w);
  uint32_t addr[E], on[E];
  int64_t dst[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    on[k] = e < n_el;
    addr[k] = base;
    dst[k] = 0;
    if (on[k]) {
      const int l = e % w;
      dst[k] = (t0 + e / w) * kD + l0 + l;
      const int32_t c = idx[dst[k]];
      assert(c >= 0 && c < C);
      addr[k] = base + 4u * static_cast<uint32_t>(c * w + l);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = 0.f;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < E; ++k) ld_volatile_shared(v[k], addr[k], on[k]);
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (on[k]) out[dst[k]] = v[k];
  }
}

template <int E>
int launch_slices(const int32_t* idx, const float* table, float* out, int64_t Tn, int C,
                  int lanes, int64_t t_rows, int steps, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(C) * lanes;
  cudaError_t err = cudaFuncSetAttribute(take_slice_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // E elements a thread, whole warps
  const int64_t threads = ((t_rows * lanes + E - 1) / E + 31) / 32 * 32;
  const dim3 grid(static_cast<unsigned>((Tn + t_rows - 1) / t_rows),
                  static_cast<unsigned>((kD + lanes - 1) / lanes));
  take_slice_kernel<E><<<grid, static_cast<unsigned>(threads), smem, st>>>(idx, table, out, Tn, C,
                                                                           lanes, t_rows, steps);
  return static_cast<int>(cudaGetLastError());
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
// lanes: 1..16 lanes a shared-memory slice (C lanes 4 bytes at most the
// card's opt-in shared memory), or 0 for the direct kernel. Returns a
// cudaError_t.
int ofs_take_along(const void* idx, const void* table, void* out, int64_t n, int64_t C, int steps,
                   int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (C <= 0 || steps <= 0 || n % kD != 0 || lanes < 0 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  if (lanes == 0) {
    take_along_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        i, t, o, n, C, steps);
    return static_cast<int>(cudaGetLastError());
  }
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(sizeof(float)) * C * lanes > optin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c32 = static_cast<int>(C);  // C lanes words fit the shared memory
  // one block a SM: the row ranges that, beside the slices, fill the SMs,
  // at most kMaxElems elements a thread
  const int64_t Tn = n / kD, slices = (kD + lanes - 1) / lanes;
  const int64_t ranges = std::max<int64_t>(1, sms / slices);
  int64_t t_rows = (Tn + ranges - 1) / ranges;
  t_rows = std::max<int64_t>(1, std::min<int64_t>(t_rows, kMaxElems * kSliceThreads / lanes));
  const int64_t per_thread = (t_rows * lanes + kSliceThreads - 1) / kSliceThreads;
  switch (per_thread) {
    case 1: return launch_slices<1>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 2: return launch_slices<2>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 3: return launch_slices<3>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 4: return launch_slices<4>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 5: return launch_slices<5>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 6: return launch_slices<6>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    case 7: return launch_slices<7>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
    default: return launch_slices<8>(i, t, o, Tn, c32, lanes, t_rows, steps, st);
  }
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
