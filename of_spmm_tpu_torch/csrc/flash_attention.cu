// Hand-written Hopper (sm_90a) flash-attention forward kernel.
//
// flash_attention replaces of_spmm_tpu/ops/pallas/flash_attention.py::
// _flash_kernel (launched there by _flash_fwd). For each of BH heads it
// computes O = softmax(Q K^T * scale) V, scale = 1/sqrt(d), with
// q (BH, Tq, d), k and v (BH, Tk, d) contiguous, all of one type T
// (float, __nv_bfloat16 or __half), and writes O in T. It keeps the TPU
// kernel's arithmetic: float32 scores, a masked key scored -1e30 and its
// probability set to 0, running float32 row max m, row sum l and
// accumulator (online softmax), P rounded to T before P V, a row with
// l = 0 divided by 1, and a top-left causal mask (key j is seen by query
// i iff j <= i) under which KV tiles wholly above the diagonal are never
// loaded. Unlike the TPU kernel it needs no T divisible by its tile: it
// masks the ragged ends of Tq and Tk itself.
//
// What bounds it on the H100: operations. Attention does 4 d operations
// per (query, key) pair and reads each input once: at BERT-base width
// (d = 64, T = 512) that is 256 operations per 4-byte element moved, far
// above the ~20 at which float32 on the CUDA cores (67 TFLOP/s against
// 3.35 TB/s) stops being bound by bytes. In bf16 the tensor cores
// (989 TFLOP/s) would move the line to ~295 operations per byte, and the
// bound becomes the bytes.
//
// The design is deliberately simple: the scores and P V run in float32
// on the CUDA cores for every type (no wgmma, no TMA, no warp
// specialisation yet). One block of 256 threads per (head, 64-query
// tile) loops over 64-key tiles, which replaces the TPU grid's
// sequential KV axis; blocks of the heaviest (causal: last) query tiles
// are issued first. Shared memory holds Q^T and K^T (d-major, 68-float
// rows so float4 reads are aligned and spread over the banks), then V in
// K's place, and P^T. Thread (ty, tx) of the 16 x 16 grid owns a 4 x 4
// register tile of the scores (rows 4ty.., keys 4tx..) and 4 rows x d/16
// columns of the accumulator, so each shared-memory read feeds four
// multiply-adds. A row's statistics are reduced over the 16 lanes that
// share it with shuffles. The head width is a template bound
// (16, 32, 64, 128 or 256, d padded up to it): 1 <= d <= 256.
//
// Launchers take torch's current stream, allocate nothing, and return
// cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kLd = kBQ + 4;    // row stride of Q^T, K^T and P^T (floats)
constexpr float kMasked = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBQ == 64 && kBK == 64, "the 4 x 4 register tiles assume 64 x 64");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// round to T (nearest even) and back: P's rounding before P V
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

// VW consecutive floats from shared memory (16, 8 or 4 bytes aligned)
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    load4(p, out);
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// max or sum over the 16 lanes (one half-warp) that hold one query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DMAX * kLd + kBK * kLd);
}

// One block per (head blockIdx.x, query tile); see the file comment.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int64_t tq, int64_t tk, int d, float scale,
                 int causal) {
  constexpr int NC = DMAX / 16;           // accumulator columns per thread
  constexpr int VW = NC < 4 ? NC : 4;     // read VW of them at once
  constexpr int G = NC / VW;              // in G groups
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // Q^T [DMAX][kLd]
  float* kv = qt + DMAX * kLd;                  // K^T [DMAX][kLd], then V [kBK][DMAX]
  float* pt = kv + DMAX * kLd;                  // P^T [kBK][kLd]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qh = q + bh * tq * d;
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;

  // the Q tile, transposed; rows past Tq are zero (computed, never stored)
  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    qt[c * kLd + r] = q0 + r < tq ? to_f(qh[q0 * d + e]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int64_t n_tiles = (tk + kBK - 1) / kBK;
  if (causal) {
    const int64_t q_last = (q0 + kBQ < tq ? q0 + kBQ : tq) - 1;
    n_tiles = n_tiles < q_last / kBK + 1 ? n_tiles : q_last / kBK + 1;
  }
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t k0 = t * kBK;
    const int nk = static_cast<int>(tk - k0 < kBK ? tk - k0 : kBK);
    __syncthreads();  // Q^T is written; the last tile's P V is done with kv and pt
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      kv[c * kLd + r] = r < nk ? to_f(kh[k0 * d + e]) : 0.f;
    }
    __syncthreads();

    // scores: rows 4ty + i, keys 4tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
      load4(qt + c * kLd + ty * 4, a);
      load4(kv + c * kLd + tx * 4, b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with K^T: V goes in its place
    for (int e = tid; e < nk * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      kv[r * DMAX + c] = to_f(vh[k0 * d + e]);
    }

    // online softmax; s becomes P, rounded to T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i;
      bool keep[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx * 4 + j;
        keep[j] = kj < nk && (!causal || k0 + kj <= qpos);
        s[i][j] = keep[j] ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      // m_next >= -1e30 once a tile is seen; exp(-inf) = 0 on the first
      const float m_next = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_next) : 0.f;
        sum += p;
        s[i][j] = to_f(from_f<T>(p));
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V: rows 4ty + i, columns g * 16 VW + tx VW + w
    for (int j = 0; j < nk; ++j) {
      float a[4];
      load4(pt + j * kLd + ty * 4, a);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float b[VW];
        load_vec<VW>(kv + j * DMAX + g * 16 * VW + tx * VW, b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            acc[i][g * VW + w] = fmaf(a[i], b[w], acc[i][g * VW + w]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty * 4 + i;
    if (r >= tq) continue;
    const float div = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (bh * tq + r) * d;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        const int c = g * 16 * VW + tx * VW + w;
        if (c < d) orow[c] = from_f<T>(acc[i][g * VW + w] / div);
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int64_t bh,
                   int64_t tq, int64_t tk, int d, float scale, int causal,
                   cudaStream_t stream) {
  const auto kernel = flash_fwd_kernel<T, DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((tq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int64_t bh,
                     int64_t tq, int64_t tk, int d, float scale, int causal,
                     cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 32) return launch<T, 32>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  return launch<T, 256>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
}

}  // namespace

extern "C" {

// q (bh, tq, d), k and v (bh, tk, d), out (bh, tq, d), contiguous, of one
// type: dtype 0 float32, 1 bfloat16, 2 float16. 1 <= d <= 256; bh below
// 2^31 and tq below 65535 * 64 (the grid). Returns a cudaError_t.
int ofs_flash_attention(const void* q, const void* k, const void* v, void* out, int64_t bh,
                        int64_t tq, int64_t tk, int64_t d, float scale, int causal,
                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bh == 0 || tq == 0) return 0;
  if (d < 1 || d > 256 || bh > 0x7fffffff || (tq + kBQ - 1) / kBQ > 65535 || tk < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
    case 1:
      return static_cast<int>(
          launch_d<__nv_bfloat16>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
    case 2:
      return static_cast<int>(launch_d<__half>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
