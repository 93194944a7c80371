// Hand-written Hopper (sm_90a) flash-attention forward kernels.
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
// T = 512) that is 256 operations per 4-byte element moved. In bf16 and
// fp16 the tensor cores (989 TFLOP/s against 3.35 TB/s) need ~295
// operations per byte: at (BH, T, d) = (96, 512, 64) the operations take
// 0.0065 ms and the bytes 0.0075 ms, so the two are all but level and the
// bytes bound it. In float32 the tensor cores bound it: TF32 keeps 10
// mantissa bits, too few for the float32 bar of 1e-5 + 1e-4|p|, so each
// product is taken as three TF32 products, x ~ hi + lo with hi = tf32(x)
// and lo = tf32(x - hi), a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (the
// lo·lo term is below 2^-22 of the product). That keeps float32's
// accuracy, and three products at 495 TFLOP/s (0.0390 ms at (96, 512,
// 64)) still beat one on the CUDA cores at 67 (0.0962 ms). The kernel
// issues mma.sync, which reaches well below 495 TFLOP/s (only wgmma is
// rated at it), so it cannot reach that bound (PERF.md).
//
// Both kernels take FlashAttention-2's layout: one block of 4 warps per
// (head, 64-query tile), blocks of the heaviest (causal: last) query tiles
// issued first, each warp owning 16 query rows; a loop over KV tiles
// replaces the TPU grid's sequential KV axis. K and V tiles come into
// shared memory with 16-byte cp.async copies, double-buffered, so the
// next tile loads while this one computes and one barrier an iteration
// suffices (plain loads when d is not a whole number of 16-byte chunks or
// a pointer is not 16-byte aligned). Rows are padded by one 16-byte chunk
// so that ldmatrix's eight row addresses fall on distinct banks. The
// online softmax (row max, row sum, in the log2 domain: ex2.approx, 2
// ulp, of scores pre-scaled by log2 e; tiles that no row of a warp sees
// in part skip the mask) runs on the accumulator fragments in registers,
// the row statistics reduced over the 4 lanes of a row. The head width is
// padded up to DP (16, 32, 48, 64, 80, 96, 128, 192, 256); zero columns
// change nothing. O leaves through the warp's rows of the Q tile, in
// 16-byte stores. Left for later: wgmma with its operands in shared
// memory, TMA copies on an mbarrier, and warp specialisation.
//
// float32 (flash_f32_kernel): S = Q K^T and O += P V run as mma.sync
// m16n8k8 TF32 (float32 accumulate), three per product, lo·hi and hi·lo
// first, then hi·hi. The split is integer arithmetic on the float's bits
// (split_tf32), which no compiler folds. Q and K fragments come from
// ldmatrix (b16 view: lane l gets 32-bit word l % 4 of row l / 4, which
// is the TF32 A and B layout), and each is split as it is loaded: Q again
// at every KV tile (kept split in registers, at DP = 64 it took 194
// registers a thread against 157 and ran no faster), K and V once a warp
// (split once a tile into hi / lo planes in shared memory instead, they
// need a second barrier a tile and more shared memory, and ran no faster
// once the split took three integer operations; PERF.md). P V takes P's
// score fragment as its A operand as it lies, by reading key 2t of each
// 8-key group as column t and key 2t + 1 as column t + 4; V's B fragments
// follow that order with scalar shared loads (rows of DP + 4 floats put a
// warp's 32 loads on distinct banks). P stays float32 and is split in
// registers. KV tiles are 64 keys up to DP = 64 and 32 above, so that Q
// and two stages of K and V fit in shared memory (200 KB at DP = 256).
// Registers a thread (nvcc -Xptxas -v, sm_90a, CUDA 12.8): DP = 64: 157,
// DP = 128: 185, DP = 256: 230, no spills. At DP = 64 shared memory (87
// KB a block) allows two blocks an SM.
//
// bfloat16 and float16 (flash_tc_kernel): mma.sync m16n8k16 (T in,
// float32 accumulate) with operands from ldmatrix (.trans for V), KV
// tiles of 64 keys. P is rounded to T in registers and is, as it lies,
// the A operand of P V. Up to DP = 128 each warp keeps its Q fragments in
// registers for the whole loop; above, it re-reads them from shared
// memory at every k-step (the 16 x DP float32 output accumulator alone
// takes DP / 2 registers a thread).
//
// Launchers take torch's current stream, allocate nothing, and return
// cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile (bf16 / fp16; float32 below)
constexpr float kMasked = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// round to T (nearest even): P's rounding before P V
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

// ---------------------------------------------------------------------------
// The tensor-core kernels' shared pieces, and the bf16 / fp16 kernel
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
// FlashAttention does
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

// Rows [row0, row0 + ROWS) of a (rows, d) head into a ROWS x DP tile of
// shared memory (row stride DP plus one 16-byte chunk: ldmatrix's eight
// row addresses fall on distinct banks); rows past `rows` and columns past
// d are zeros. vec: 16-byte cp.async copies (d a whole number of chunks,
// aligned), which the caller waits for; else plain loads and stores.
template <typename T, int DP, int ROWS = kBQ>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, int64_t row0,
                                          int64_t rows, int d, bool vec) {
  constexpr int EC = 16 / sizeof(T);  // elements a chunk
  constexpr int LD = DP + EC;
  if (vec) {
    constexpr int CH = DP / EC;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < ROWS * CH; e += kTcThreads) {
      const int r = e / CH, c = (e - r * CH) * EC;
      const bool ok = row0 + r < rows && c < d;
      cp_async16(s + r * LD + c, ok ? g + (row0 + r) * d + c : g, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += kTcThreads) {
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
  // then out in whole rows. With no KV tile, another warp's Q copy may
  // still be landing in these rows: every thread waits for its own, then
  // for the others.
  cp_async_wait<0>();
  __syncthreads();
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// x ~ hi + lo for the tensor cores, which read only an operand's TF32 bits
// (sign, exponent, 10 mantissa bits) and drop the 13 below: hi = x plus
// half a TF32 ulp, read as x rounded to nearest, ties away (what
// cvt.rna.tf32.f32 gives), and lo = x - that value exactly, read
// truncated; |x - (hi + lo)| <= 2^-21 |x| as read. Integer arithmetic on
// the bits, which no compiler folds. cvt.rna.tf32.f32 itself compiles on
// sm_90 to a compare, an add, a mask and a select; with two of them a
// split the kernel ran slower (PERF.md). A NaN in x stays NaN in hi or
// lo, and an inf makes lo NaN, so either reaches the products.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a b on the tensor cores: m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms lo·hi and hi·lo first, then hi·hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma1688(d, al, bh[0], bh[1]);
  mma1688(d, ah, bl[0], bl[1]);
  mma1688(d, ah, bh[0], bh[1]);
}

// keys per KV tile: 64, or 32 above DP = 64 so that two stages fit
template <int DP>
constexpr int kF32Keys = DP <= 64 ? 64 : 32;

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBQ + 2 * kTcStages * kF32Keys<DP>) * (DP + 4);  // Q, K's, V's
}

// One block of 4 warps per (head blockIdx.x, 64-query tile); warp w owns
// query rows 16 w.. of the tile. See the file comment. The explicit
// minimum of one block an SM leaves ptxas its full register budget, and
// the kernel ran faster so (PERF.md).
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int64_t tq, int64_t tk,
                 int d, float scale_log2, int causal, int vec_in, int vec_out) {
  constexpr int BK = kF32Keys<DP>;
  constexpr int LD = DP + 4;
  constexpr int KS = DP / 8;           // k-steps of Q K^T over the head width
  constexpr int NO = DP / 8;           // n-tiles of the output
  constexpr int NS = BK / 8;           // n-tiles of the scores, k-steps of P V
  static_assert(4 * NS <= 32 && NS % 2 == 0, "one mask bit per score; n-tiles in pairs");
  static_assert(DP % 8 == 0 && DP <= 256, "head width padded to a multiple of 8");
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kBQ * LD;           // kTcStages buffers of K, then of V
  float* sv = sk + kTcStages * BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row, column pair
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qh = q + bh * tq * d;
  const float* kh = k + bh * tk * d;
  const float* vh = v + bh * tk * d;
  const bool vec = vec_in != 0;

  int64_t n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    const int64_t q_last = (q0 + kBQ < tq ? q0 + kBQ : tq) - 1;
    n_tiles = n_tiles < q_last / BK + 1 ? n_tiles : q_last / BK + 1;
  }
  load_tile<float, DP>(sq, qh, q0, tq, d, vec);
#pragma unroll
  for (int p = 0; p < kTcStages - 1; ++p) {  // one copy group per KV tile, Q in the first
    if (p < n_tiles) {
      load_tile<float, DP, BK>(sk + p * BK * LD, kh, p * BK, tk, d, vec);
      load_tile<float, DP, BK>(sv + p * BK * LD, vh, p * BK, tk, d, vec);
    }
    cp_async_commit();
  }

  // ldmatrix addressing: lane l names row l % 8 of 8 x 8 matrix l / 8
  // (b16 view: 8 rows of 4 floats)
  const int mat = lane >> 3, mrow = lane & 7;
  const float* q_frag = sq + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 4;
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
      load_tile<float, DP, BK>(sk + nb * BK * LD, kh, ahead * BK, tk, d, vec);
      load_tile<float, DP, BK>(sv + nb * BK * LD, vh, ahead * BK, tk, d, vec);
    }
    cp_async_commit();
    const int buf = static_cast<int>(t % kTcStages);
    const float* kb = sk + buf * BK * LD;
    const float* vb = sv + buf * BK * LD;

    // S = Q K^T: 16 rows x BK keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], ah[4], al[4];
      ldmatrix_x4(a, q_frag + kk * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];  // keys of n-tiles j, j + 1; head columns kk*8 .. +7
        ldmatrix_x4(b, kb + ((j + (mat >> 1)) * 8 + mrow) * LD + kk * 8 + (mat & 1) * 4);
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(__uint_as_float(b[i]), bh[i >> 1][i & 1], bl[i >> 1][i & 1]);
        }
        mma3(s[j], ah, al, bh[0], bl[0]);
        mma3(s[j + 1], ah, al, bh[1], bl[1]);
      }
    }

    // online softmax on the fragments (log2 domain); s becomes P. Bit
    // 4 j + i of `keep` says whether score s[j][i] is seen; a tile that
    // every row of the warp sees whole needs no mask.
    const int64_t k0 = t * BK;
    uint32_t keep = 0xffffffffu;
    if (k0 + BK > tk || (causal && k0 + BK - 1 > q0 + warp * 16)) {
      const int key_end = static_cast<int>(tk - k0 < BK ? tk - k0 : BK);
      int last[2];  // the last key offset each of this thread's rows sees
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row_g[h] - k0;
        last[h] = !causal ? BK : r < 0 ? -1 : r > BK ? BK : static_cast<int>(r);
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

    // O += P V, 8 keys a k-step. P's scores (row g / g + 8, keys 2 t4 and
    // 2 t4 + 1) are its A operand when column t4 stands for key 2 t4 and
    // column t4 + 4 for key 2 t4 + 1; V's B rows t4 and t4 + 4 follow.
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      const float* vrow = vb + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(vrow[n * 8], bh[0], bl[0]);
        split_tf32(vrow[LD + n * 8], bh[1], bl[1]);
        mma3(o[n], ah, al, bh, bl);
      }
    }
  }

  // O / l through the warp's own 16 rows of the Q tile, then out in whole
  // rows. With no KV tile, another warp's Q copy may still be landing in
  // these rows: every thread waits for its own, then for the others.
  cp_async_wait<0>();
  __syncthreads();
  float div[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) div[h] = l_run[h] == 0.f ? 1.f : l_run[h];
  float* so = sq + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(so + g * LD + n * 8 + 2 * t4) =
        make_float2(o[n][0] / div[0], o[n][1] / div[0]);
    *reinterpret_cast<float2*>(so + (g + 8) * LD + n * 8 + 2 * t4) =
        make_float2(o[n][2] / div[1], o[n][3] / div[1]);
  }
  __syncwarp();
  const int64_t r0 = q0 + warp * 16;
  float* oh = out + (bh * tq + r0) * d;
  if (vec_out) {
    constexpr int CH = DP / 4;
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = (e - r * CH) * 4;
      if (r0 + r < tq && c < d) {
        *reinterpret_cast<float4*>(oh + r * d + c) =
            *reinterpret_cast<const float4*>(so + r * LD + c);
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
  constexpr bool kF32 = std::is_same_v<T, float>;
  const auto kernel = [] {
    if constexpr (kF32) {
      return flash_f32_kernel<DP>;
    } else {
      return flash_tc_kernel<T, DP>;
    }
  }();
  constexpr size_t smem = kF32 ? f32_smem_bytes<DP>() : tc_smem_bytes<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte copy
  const int vec_in = d % kChunk == 0 && a16(q) && a16(k) && a16(v);
  const int vec_out = d % kChunk == 0 && a16(out);
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
      return static_cast<int>(launch_tc_d<float>(q, k, v, out, bh, tq, tk, di, scale, causal, s));
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
