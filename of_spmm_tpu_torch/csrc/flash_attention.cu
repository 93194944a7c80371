// Hand-written Hopper (sm_90a) flash-attention forward kernel.
//
// flash_attention replaces of_spmm_tpu/ops/pallas/flash_attention.py::
// _flash_kernel (launched there by _flash_fwd). For each of BH heads it
// computes O = softmax(Q K^T * scale) V, scale = 1/sqrt(d), with
// q (BH, Tq, d), k and v (BH, Tk, d) contiguous, all of one type T
// (float, __nv_bfloat16 or __half), and writes O in T. It keeps the TPU
// kernel's arithmetic: float32 scores, a masked key scored -1e30 and its
// probability set to 0, running float32 row max m, row sum l and
// accumulator (online softmax), P rounded to T before P V (its unrounded
// sum in l), a row with l = 0 divided by 1, and a top-left causal mask
// (key j is seen by query i iff j <= i) under which KV tiles wholly above
// the diagonal are never loaded. Unlike the TPU kernel it needs no T divisible by its tile: it
// masks the ragged ends of Tq and Tk itself.
//
// What bounds it on the H100. Attention does 4 d operations per (query,
// key) pair and reads each input once: at BERT-base width (d = 64,
// T = 512) that is 256 operations per 4-byte element moved, far above
// the ~20 at which float32 on the CUDA cores (67 TFLOP/s against
// 3.35 TB/s) stops being bound by bytes, so float32 is bound by
// operations (0.0962 ms at (BH, T, d) = (96, 512, 64)). In bf16 and fp16
// the tensor cores (989 TFLOP/s) move the line to ~295 operations per
// byte: at (96, 512, 64) the operations take 0.0065 ms and the bytes
// 0.0075 ms, so the two are all but level and the bytes bound it.
//
// float32 (flash_fwd_kernel): the scores and P V run in float32 on the
// CUDA cores (TF32 would break the float32 bar of 1e-5 + 1e-4|p|). One
// block of 256 threads per (head, 64-query tile) loops over 64-key
// tiles, which replaces the TPU grid's sequential KV axis; blocks of the
// heaviest (causal: last) query tiles are issued first. Shared memory
// holds Q^T and K^T (d-major, 68-float rows so float4 reads are aligned
// and spread over the banks), then V in K's place, and P^T. Thread
// (ty, tx) of the 16 x 16 grid owns a 4 x 4 register tile of the scores
// (rows 4ty.., keys 4tx..) and 4 rows x d/16 columns of the accumulator,
// so each shared-memory read feeds four multiply-adds. A row's
// statistics are reduced over the 16 lanes that share it with shuffles.
// The head width is a template bound (16, 32, 64, 128 or 256, d padded
// up to it): 1 <= d <= 256.
//
// bfloat16 and float16 (flash_tc_kernel), FlashAttention-2's layout on
// the tensor cores: one block of 4 warps per (head, 64-query tile), the
// heaviest tiles first as above, each warp owning 16 query rows. K and V
// tiles of 64 keys come into shared memory with 16-byte cp.async copies,
// double-buffered, so the next tile loads while this one computes and one
// barrier an iteration suffices (plain loads when d % 8 != 0 or a pointer
// is not 16-byte aligned). S = Q K^T
// and O += P V run as mma.sync m16n8k16 (T in, float32 accumulate) with
// operands from ldmatrix (.trans for V); rows of DP + 8 elements put
// ldmatrix's eight row addresses on distinct banks. The online softmax
// (row max, row sum, in the log2 domain: ex2.approx of scores
// pre-scaled by log2 e; tiles that no row of a warp sees in part skip
// the mask) runs on the accumulator fragments in registers, the row
// statistics reduced over the 4 lanes of a row. P is rounded to T in
// registers and is, as it lies, the A operand of P V. The head width is
// padded up to DP, a multiple of 16 (16, 32, 48, 64, 80, 96, 128, 192,
// 256); zero columns change nothing. Up to DP = 128 each warp keeps its
// Q fragments in registers for the whole loop; above, it re-reads them
// from shared memory at every k-step (the 16 x DP float32 output
// accumulator alone takes DP / 2 registers a thread). O leaves through
// the warp's rows of the Q tile, in 16-byte stores. Left for later: wgmma
// with its operands in shared memory, TMA copies on an mbarrier, and
// warp specialisation (a producer warp keeping the copies in flight).
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

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel (FlashAttention-2's layout)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;                  // 16 query rows each
constexpr int kTcThreads = kTcWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == 16 * kTcWarps, "one m16 tile of queries per warp");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: m16n8k16, T in, float32 accumulate
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction (ex2.approx: 2 ulp, 2^-inf = 0), as
// FlashAttention does; float32's kernel keeps expf
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T (nearest even), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// KV tiles in the shared-memory ring: double buffering
constexpr int kTcStages = 2;

template <int DP>
constexpr size_t tc_smem_bytes() {
  return sizeof(uint16_t) * (1 + 2 * kTcStages) * kBQ * (DP + 8);  // Q, K's, V's
}

// Rows [row0, row0 + 64) of a (rows, d) head into a 64 x DP tile of
// shared memory (row stride DP + 8 elements: ldmatrix's eight row
// addresses fall on distinct banks); rows past `rows` and columns past d
// are zeros. vec: 16-byte cp.async copies (d % 8 == 0, aligned), which
// the caller waits for; else plain loads and stores.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, int64_t row0,
                                          int64_t rows, int d, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < kBQ * CH; e += kTcThreads) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const bool ok = row0 + r < rows && c < d;
      cp_async16(s + r * LD + c, ok ? g + (row0 + r) * d + c : g, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBQ * DP; e += kTcThreads) {
      const int r = e / DP, c = e - r * DP;
      s[r * LD + c] = row0 + r < rows && c < d ? g[(row0 + r) * d + c] : from_f<T>(0.f);
    }
  }
}

// One block of 4 warps per (head blockIdx.x, 64-query tile); warp w owns
// query rows 16 w.. of the tile. See the file comment.
template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int64_t tq, int64_t tk, int d, float scale_log2,
                int causal, int vec_in, int vec_out) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;          // k-steps of Q K^T over the head width
  constexpr int NO = DP / 8;           // n-tiles of the output
  constexpr int NS = kBK / 8;          // n-tiles of the scores
  static_assert(4 * NS <= 32, "one mask bit per score a thread holds");
  constexpr bool kQInRegs = DP <= 128; // wider: A fragments re-read from shared memory
  static_assert(DP % 16 == 0 && DP <= 256, "head width padded to a multiple of 16");
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);
  T* sk = sq + kBQ * LD;               // kTcStages buffers of K, then of V
  T* sv = sk + kTcStages * kBK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row, column pair
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qh = q + bh * tq * d;
  const T* kh = k + bh * tk * d;
  const T* vh = v + bh * tk * d;
  const bool vec = vec_in != 0;

  int64_t n_tiles = (tk + kBK - 1) / kBK;
  if (causal) {
    const int64_t q_last = (q0 + kBQ < tq ? q0 + kBQ : tq) - 1;
    n_tiles = n_tiles < q_last / kBK + 1 ? n_tiles : q_last / kBK + 1;
  }
  load_tile<T, DP>(sq, qh, q0, tq, d, vec);
#pragma unroll
  for (int p = 0; p < kTcStages - 1; ++p) {  // one copy group per KV tile, Q in the first
    if (p < n_tiles) {
      load_tile<T, DP>(sk + p * kBK * LD, kh, p * kBK, tk, d, vec);
      load_tile<T, DP>(sv + p * kBK * LD, vh, p * kBK, tk, d, vec);
    }
    cp_async_commit();
  }

  // ldmatrix addressing: lane l names row l % 8 of 8 x 8 matrix l / 8
  const int mat = lane >> 3, mrow = lane & 7;
  const T* q_frag = sq + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[kQInRegs ? KS : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int64_t row_g[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int64_t t = 0; t < n_tiles; ++t) {
    cp_async_wait<kTcStages - 2>();  // tile t has landed
    __syncthreads();  // for every thread; and tile t - 1's buffer is free
    const int64_t ahead = t + kTcStages - 1;  // loads while this tile computes
    if (ahead < n_tiles) {
      const int nb = static_cast<int>(ahead % kTcStages);
      load_tile<T, DP>(sk + nb * kBK * LD, kh, ahead * kBK, tk, d, vec);
      load_tile<T, DP>(sv + nb * kBK * LD, vh, ahead * kBK, tk, d, vec);
    }
    cp_async_commit();
    const int buf = static_cast<int>(t % kTcStages);
    const T* kb = sk + buf * kBK * LD;
    const T* vb = sv + buf * kBK * LD;
    if (kQInRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KS : 0); ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];  // keys of n-tiles j, j + 1; head columns kk*16 .. +15
        ldmatrix_x4(b, kb + ((j + (mat >> 1)) * 8 + mrow) * LD + kk * 16 + (mat & 1) * 8);
        mma16816<T>(s[j], a, b[0], b[1]);
        mma16816<T>(s[j + 1], a, b[2], b[3]);
      }
    }

    // online softmax on the fragments (log2 domain); s becomes P. Bit
    // 4 j + i of `keep` says whether score s[j][i] is seen; a tile that
    // every row of the warp sees whole needs no mask.
    const int64_t k0 = t * kBK;
    uint32_t keep = 0xffffffffu;
    if (k0 + kBK > tk || (causal && k0 + kBK - 1 > q0 + warp * 16)) {
      const int key_end = static_cast<int>(tk - k0 < kBK ? tk - k0 : kBK);
      int last[2];  // the last key offset each of this thread's rows sees
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row_g[h] - k0;
        last[h] = !causal ? kBK : r < 0 ? -1 : r > kBK ? kBK : static_cast<int>(r);
      }
      keep = 0u;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = j * 8 + 2 * t4 + (i & 1);
          keep |= static_cast<uint32_t>(kl < key_end && kl <= last[i >> 1]) << (4 * j + i);
        }
    }
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = (keep >> (4 * j + i)) & 1u ? s[j][i] * scale_log2 : kMasked;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      // m_next >= -1e30 once a tile is seen; exp2(-inf) = 0 on the first
      const float m_next = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp2_approx(m_run[h] - m_next);
      m_run[h] = m_next;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (keep >> (4 * j + i)) & 1u ? exp2_approx(s[j][i] - m_run[i >> 1]) : 0.f;
        sum[i >> 1] += p;
        s[j][i] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(kFullMask, sum[h], 1);
      sum[h] += __shfl_xor_sync(kFullMask, sum[h], 2);
      l_run[h] = alpha[h] * l_run[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P rounded to T in registers is the A operand as it lies
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                             pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                             pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];  // keys kk*16 .. +15; head columns of n-tiles n, n + 1
        ldmatrix_x4_trans(b, vb + (kk * 16 + (mat & 1) * 8 + mrow) * LD + (n + (mat >> 1)) * 8);
        mma16816<T>(o[n], a, b[0], b[1]);
        mma16816<T>(o[n + 1], a, b[2], b[3]);
      }
    }
  }

  // O / l, rounded to T, through the warp's own 16 rows of the Q tile,
  // then out in whole rows
  cp_async_wait<0>();  // with no KV tile, the Q copy may still be landing
  float div[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) div[h] = l_run[h] == 0.f ? 1.f : l_run[h];
  T* so = sq + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * LD + n * 8 + 2 * t4) =
        pack2<T>(o[n][0] / div[0], o[n][1] / div[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + n * 8 + 2 * t4) =
        pack2<T>(o[n][2] / div[1], o[n][3] / div[1]);
  }
  __syncwarp();
  const int64_t r0 = q0 + warp * 16;
  T* oh = out + (bh * tq + r0) * d;
  if (vec_out) {
    constexpr int CH = DP / 8;
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = (e - r * CH) * 8;
      if (r0 + r < tq && c < d) {
        *reinterpret_cast<uint4*>(oh + r * d + c) =
            *reinterpret_cast<const uint4*>(so + r * LD + c);
      }
    }
  } else {
    for (int e = lane; e < 16 * d; e += 32) {
      const int r = e / d, c = e - r * d;
      if (r0 + r < tq) oh[r * d + c] = so[r * LD + c];
    }
  }
}

template <typename T, int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int64_t bh,
                      int64_t tq, int64_t tk, int d, float scale, int causal,
                      cudaStream_t stream) {
  const auto kernel = flash_tc_kernel<T, DP>;
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int vec_in = d % 8 == 0 && a16(q) && a16(k) && a16(v);
  const int vec_out = d % 8 == 0 && a16(out);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((tq + kBQ - 1) / kBQ));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, d, scale * kLog2e, causal, vec_in, vec_out);
  return cudaGetLastError();
}

// the head width padded up to a multiple of 16 (112 to 128, above 128 to
// 192 or 256: fewer instantiations, the same result)
template <typename T>
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, void* out, int64_t bh,
                        int64_t tq, int64_t tk, int d, float scale, int causal,
                        cudaStream_t s) {
  if (d <= 16) return launch_tc<T, 16>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 32) return launch_tc<T, 32>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 48) return launch_tc<T, 48>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 64) return launch_tc<T, 64>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 80) return launch_tc<T, 80>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 96) return launch_tc<T, 96>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 128) return launch_tc<T, 128>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  if (d <= 192) return launch_tc<T, 192>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
  return launch_tc<T, 256>(q, k, v, out, bh, tq, tk, d, scale, causal, s);
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
          launch_tc_d<__nv_bfloat16>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
    case 2:
      return static_cast<int>(
          launch_tc_d<__half>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
