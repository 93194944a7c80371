// Hand-written Hopper (sm_90a) kernels of the predication microbenchmark
// (of_spmm_tpu_torch/tools/microbench_cond.py).
//
// cond_steps replaces tools/microbench_cond.py::make's kernel
// (pallas_call at :105), the panel kernel's compute block. Per step s and
// group g < G (32) of that step, bit k of column c is
// (masks[sG + g, k / 32, c] >> k % 32) & 1, and the group's product is
// P_g[c, :] = sum_k bit(k, c) win[k, :] over the 128 window rows (256 bf16
// columns); the step's tile is
//     tile_s[c, :] = sum over the groups run of P_g[c, :128] + P_g[c, 128:].
// nocond runs all G groups. cond_* and when_* run the sub-blocks of 4
// groups whose first group s0 has gcnt[s] > s0 (a branch uniform across the
// block); *_all and *_half are gcnt = 32 and 16. cond keeps the taken
// sub-blocks' sum in registers, when adds each taken sub-block into the
// tile in memory, as the TPU's pl.when form adds into its output block.
//
// Every TPU step overwrites the one output tile, so the TPU's result is the
// last step's. So that no step's work can be dropped, every step's tile is
// written here, into out (steps, 128, 128); the wrapper's result for the
// TPU function is out[-1].
//
// What bounds it on the H100: operations. The TPU's work is a dense bf16
// product, 2 * 128 * 128 * 256 flops a group: 550 GFLOP over the 65,536
// groups of the tool's defaults, 0.556 ms at the tensor cores' 989 TFLOP/s;
// the bytes (masks of the groups run, the window, the 134 MB of tiles) take
// 0.08 ms. utils/roofline.py cond_work counts both. This first kernel
// stays on the CUDA cores, so its own floor is the masked sum at 67
// TFLOP/s fp32: it adds the window's two column halves once (the sum of two
// bf16 values is exact in float32 but for rare exponent gaps), which
// halves the work, then does one fused multiply-add by the 0/1 bit per
// (k, c, column): 137 G of them at the defaults, about 4 ms.
//
// Design: one block of 256 threads per step. The block builds the summed
// window (128 x 128 float32, 64 KB) in shared memory; each thread owns an
// 8 x 8 register tile (8 columns c of the masks, 8 window columns), reads
// its 8 mask words per 32 k from L1, and for each k one 8-float row of the
// window from shared memory. The sums over k run in order, as in a dot.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 128;
constexpr int kSub = 4;          // groups per predicated sub-block
constexpr int kThreads = 256;
constexpr int kT = 8;            // register tile: 8 c x 8 columns

enum Mode { kNocond = 0, kCond = 1, kWhen = 2 };

template <int M>
__global__ void __launch_bounds__(kThreads)
cond_kernel(const int32_t* __restrict__ gcnt, const int32_t* __restrict__ masks,
            const uint16_t* __restrict__ win, float* __restrict__ out, int G) {
  extern __shared__ float ws[];  // (128, 128): win[:, :128] + win[:, 128:]
  for (int e = threadIdx.x; e < kL * kL; e += kThreads) {
    const int k = e / kL, n = e % kL;
    ws[e] = __uint_as_float(static_cast<uint32_t>(win[k * 2 * kL + n]) << 16) +
            __uint_as_float(static_cast<uint32_t>(win[k * 2 * kL + kL + n]) << 16);
  }
  __syncthreads();

  const int64_t s = blockIdx.x;
  const int c0 = (threadIdx.x / (kL / kT)) * kT;   // this thread's mask columns
  const int n0 = (threadIdx.x % (kL / kT)) * kT;   // this thread's window columns
  float* tile = out + s * kL * kL;
  const int g_cnt = gcnt[s];
  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
#pragma unroll
    for (int n = 0; n < kT; ++n) acc[i][n] = 0.f;
  }
  if (M == kWhen) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      float4* t = reinterpret_cast<float4*>(tile + (c0 + i) * kL + n0);
      t[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      t[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int s0 = 0; s0 < G; s0 += kSub) {
    if (M != kNocond && !(g_cnt > s0)) continue;
    for (int g = s0; g < s0 + kSub && g < G; ++g) {
      const int32_t* mg = masks + (s * G + g) * 4 * kL;
      for (int kw = 0; kw < 4; ++kw) {
        const int4 w0 = *reinterpret_cast<const int4*>(mg + kw * kL + c0);
        const int4 w1 = *reinterpret_cast<const int4*>(mg + kw * kL + c0 + 4);
        const uint32_t m[kT] = {static_cast<uint32_t>(w0.x), static_cast<uint32_t>(w0.y),
                                static_cast<uint32_t>(w0.z), static_cast<uint32_t>(w0.w),
                                static_cast<uint32_t>(w1.x), static_cast<uint32_t>(w1.y),
                                static_cast<uint32_t>(w1.z), static_cast<uint32_t>(w1.w)};
#pragma unroll 4
        for (int kb = 0; kb < 32; ++kb) {
          const float4* wr = reinterpret_cast<const float4*>(ws + (kw * 32 + kb) * kL + n0);
          const float4 a = wr[0], b = wr[1];
          const float v[kT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < kT; ++i) {
            const float bit = static_cast<float>((m[i] >> kb) & 1u);
#pragma unroll
            for (int n = 0; n < kT; ++n) acc[i][n] = fmaf(bit, v[n], acc[i][n]);
          }
        }
      }
    }
    if (M == kWhen) {
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        float4* t = reinterpret_cast<float4*>(tile + (c0 + i) * kL + n0);
        float4 p = t[0], q = t[1];
        p.x += acc[i][0]; p.y += acc[i][1]; p.z += acc[i][2]; p.w += acc[i][3];
        q.x += acc[i][4]; q.y += acc[i][5]; q.z += acc[i][6]; q.w += acc[i][7];
        t[0] = p;
        t[1] = q;
#pragma unroll
        for (int n = 0; n < kT; ++n) acc[i][n] = 0.f;
      }
    }
  }
  if (M != kWhen) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      float4* t = reinterpret_cast<float4*>(tile + (c0 + i) * kL + n0);
      t[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      t[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int M>
int launch(const int32_t* gcnt, const int32_t* masks, const uint16_t* win, float* out,
           int64_t steps, int G, cudaStream_t st) {
  const size_t smem = sizeof(float) * kL * kL;
  cudaError_t err = cudaFuncSetAttribute(
      cond_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cond_kernel<M><<<static_cast<unsigned>(steps), kThreads, smem, st>>>(gcnt, masks, win, out, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 0 nocond, 1 cond, 2 when. gcnt int32 (steps,); masks int32
// (steps G, 4, 128); win bf16 bits (128, 256); out float32 (steps, 128, 128),
// every element written. Contiguous device arrays. Returns a cudaError_t.
int ofs_cond_steps(int mode, const void* gcnt, const void* masks, const void* win, void* out,
                   int64_t steps, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (steps == 0) return 0;
  if (G <= 0 || steps > 0x7fffffff || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const int32_t*>(gcnt);
  auto* m = static_cast<const int32_t*>(masks);
  auto* w = static_cast<const uint16_t*>(win);
  auto* o = static_cast<float*>(out);
  if (mode == kNocond) return launch<kNocond>(g, m, w, o, steps, G, st);
  if (mode == kCond) return launch<kCond>(g, m, w, o, steps, G, st);
  return launch<kWhen>(g, m, w, o, steps, G, st);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
