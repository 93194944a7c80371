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
// block): the groups [0, min(G, 4 ceil(gcnt / 4))), none when gcnt <= 0;
// *_all and *_half are gcnt = 32 and 16. cond keeps the taken sub-blocks'
// sum in registers, when adds each taken sub-block into the tile in
// memory, as the TPU's pl.when form adds into its output block.
//
// Every TPU step overwrites the one output tile, so the TPU's result is the
// last step's. So that no step's work can be dropped, every step's tile is
// written here, into out (steps, 128, 128); the wrapper's result for the
// TPU function is out[-1].
//
// The window is the same for every group, so the sum over the groups of
// bits_g^T win is (sum_g bits_g)^T win: one product of the step's count
// matrix Cnt[k, c] = sum_g bit_g(k, c) (integers 0..G, exact in bf16 up to
// 256) with the window, where the TPU multiplies once a group.
//
// What bounds it on the H100: bytes. The masks of the groups run (134 MB
// at the tool's defaults), the window, gcnt and the 134 MB of tiles take
// 0.080 ms at 3.35 TB/s; the product once a step, 2 x 128 x 128 x 256
// flops, 17.2 GFLOP, 0.017 ms at the tensor cores' 989 TFLOP/s.
// utils/roofline.py cond_work counts both.
//
// Design: a persistent grid, as many blocks of 8 warps as fit on the SMs
// (two a SM for nocond and cond), each loading the window once into
// shared memory, transposed (256 rows of 128 k, rows padded to 136 bf16 so
// that ldmatrix's eight row addresses fall on distinct banks), then
// walking the steps s = blockIdx.x, + gridDim.x, ... Per step and pass:
//   count  thread t holds columns 2 (t % 64), + 1 of mask word t / 64 and
//          reads the pass's groups, 16 uint2 loads in flight; unsigned
//          SWAR counters: (w >> i) & 0x11111111 for i < 4 adds 8 bit
//          counts in nibbles with one add (8 groups at most, so no nibble
//          overflows), folded into byte counters (byte b of counter i
//          counts bit 8b + i) every 8 groups; the counts go to shared
//          memory as Cnt^T (128 c x 128 k bf16, the mma's row-major A);
//   mma    warp w owns tile rows [64 (w / 4), + 64) and columns
//          [32 (w % 4), + 32): mma.sync m16n8k16 bf16 with float32
//          accumulation, A from Cnt^T and B from each window half in
//          turn, so the two halves add in the accumulators (K = 256).
// nocond and cond count all the groups run in one pass (kChunk groups a
// pass: 128, so the byte counters and bf16 stay exact) and store the
// tile from registers. when runs one pass per taken sub-block (counts
// 0..4) and adds each pass's product into the step's tile in shared
// memory (128 x 136 float32, each thread's elements its own), stored once
// at the step's end; its passes alternate between two count buffers, so
// the next sub-block's words load while this one's product runs, one
// barrier a pass: 8 counts and products a step for when_all where nocond
// takes one, and one block a SM (its 209 KB of shared memory).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kL = 128;
constexpr int kN = 2 * kL;       // window columns
constexpr int kLd = kL + 8;      // padded row of the bf16 operands
constexpr int kTileLd = kL + 8;  // padded row of when's float32 tile
constexpr int kSub = 4;          // groups per predicated sub-block
constexpr int kChunk = 128;      // groups counted into one product at most
constexpr int kThreads = 256;
constexpr int kBatch = 16;       // mask loads a thread keeps in flight

enum Mode { kNocond = 0, kCond = 1, kWhen = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two counts (0..255) as bf16, exactly, lo in the low half
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  return (__float_as_uint(__uint2float_rn(lo)) >> 16) |
         (__float_as_uint(__uint2float_rn(hi)) & 0xffff0000u);
}

// nocond and cond: the window and one count buffer; when: two count
// buffers and the tile
size_t smem_bytes(int mode) {
  return mode == kWhen ? sizeof(uint16_t) * (kN + 2 * kL) * kLd + sizeof(float) * kL * kTileLd
                       : sizeof(uint16_t) * (kN + kL) * kLd;
}

// this thread's mask words of step s, group 0: word kw = t / 64, columns
// c = 2 (t % 64), + 1 (group g at + 256 g)
__device__ __forceinline__ const uint2* words_of(const int32_t* __restrict__ masks, int64_t s,
                                                 int G) {
  return reinterpret_cast<const uint2*>(masks + (s * G * 4 + threadIdx.x / 64) * kL +
                                        2 * (threadIdx.x % 64));
}

// the words of groups [ga, ga + B), zeros from group g1 on
template <int B>
__device__ __forceinline__ void load_words(const uint2* p, int ga, int g1, uint2 (&w)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    w[u] = ga + u < g1 ? __ldg(p + static_cast<int64_t>(ga + u) * (2 * kL)) : make_uint2(0u, 0u);
  }
}

// adds the words' bits into the byte counters: 8 words at most into
// nibbles, then folded
template <int B>
__device__ __forceinline__ void add_bits(const uint2 (&w)[B], uint32_t (&bytes)[2][8]) {
#pragma unroll
  for (int h = 0; h < B; h += 8) {
    uint32_t nib[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) nib[0][i] = nib[1][i] = 0u;
#pragma unroll
    for (int u = h; u < h + 8 && u < B; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nib[0][i] += (w[u].x >> i) & 0x11111111u;
        nib[1][i] += (w[u].y >> i) & 0x11111111u;
      }
    }
#pragma unroll
    for (int col = 0; col < 2; ++col) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bytes[col][i] += nib[col][i] & 0x0f0f0f0fu;
        bytes[col][i + 4] += (nib[col][i] >> 4) & 0x0f0f0f0fu;
      }
    }
  }
}

// the byte counters into Cnt^T[c, k] in shared memory: byte b of counter
// i counts bit 8b + i of word kw, k = 32 kw + 8b + i
__device__ __forceinline__ void store_counts(const uint32_t (&bytes)[2][8], uint16_t* s_cnt) {
  const int kw = threadIdx.x / 64, c = 2 * (threadIdx.x % 64);
#pragma unroll
  for (int col = 0; col < 2; ++col) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        v[i / 2] = bf16_pair((bytes[col][i] >> (8 * b)) & 0xffu,
                             (bytes[col][i + 1] >> (8 * b)) & 0xffu);
      }
      *reinterpret_cast<uint4*>(s_cnt + (c + col) * kLd + 32 * kw + 8 * b) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// acc += Cnt^T [win[:, :128] | win[:, 128:]] over this warp's 64 x 32
// block of the tile
__device__ __forceinline__ void multiply(const uint16_t* s_cnt, const uint16_t* s_w,
                                         float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = 64 * (warp / 4), n0 = 32 * (warp % 4);
#pragma unroll 2
  for (int kk = 0; kk < kL; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      ldmatrix_x4(a[mi], s_cnt + (m0 + 16 * mi + lane % 16) * kLd + kk + (lane / 16) * 8);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, s_w + (h * kL + n0 + 16 * nj + lane % 8 + (lane / 16) * 8) * kLd + kk +
                           ((lane / 8) % 2) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  }
}

// the (row, column) of accumulator element e of block (mi, ni): rows g and
// g + 8 of the m16 block, columns 2t, 2t + 1 of the n8 block
__device__ __forceinline__ int acc_row(int mi, int e) {
  return 64 * (threadIdx.x / 32 / 4) + 16 * mi + (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int ni) {
  return 32 * (threadIdx.x / 32 % 4) + 8 * ni + 2 * (threadIdx.x % 4);
}

template <int M>
__global__ void __launch_bounds__(kThreads, 2)
cond_kernel(const int32_t* __restrict__ gcnt, const int32_t* __restrict__ masks,
            const uint16_t* __restrict__ win, float* __restrict__ out, int64_t steps, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_w = reinterpret_cast<uint16_t*>(smem_raw);  // (256 n, kLd): win^T
  uint16_t* s_cnt = s_w + kN * kLd;  // (128 c, kLd): Cnt^T; when: two of them
  float* s_tile = reinterpret_cast<float*>(s_cnt + 2 * kL * kLd);  // when: (128, kTileLd)
  for (int e = threadIdx.x; e < kL * kN / 2; e += kThreads) {
    const int k = e / (kN / 2), n = 2 * (e % (kN / 2));
    const uint32_t v = reinterpret_cast<const uint32_t*>(win)[e];
    s_w[n * kLd + k] = static_cast<uint16_t>(v & 0xffffu);
    s_w[(n + 1) * kLd + k] = static_cast<uint16_t>(v >> 16);
  }
  __syncthreads();

  const int n_sub = (G + kSub - 1) / kSub;
  int q = 0;  // when: the passes this block has run; their parity picks the count buffer
  for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
    const int g_cnt = gcnt[s];
    const int subs = M == kNocond ? n_sub : g_cnt <= 0 ? 0 : min(n_sub, (g_cnt - 1) / kSub + 1);
    const int groups = min(G, kSub * subs);
    const uint2* words = words_of(masks, s, G);
    float* tile = out + s * kL * kL;
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
    if (M == kWhen) {
      // the tile's elements this thread accumulates are its own: no barrier
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            *reinterpret_cast<float2*>(s_tile + acc_row(mi, e) * kTileLd + acc_col(ni)) =
                make_float2(0.f, 0.f);
          }
        }
      }
      // one pass per taken sub-block; the next sub-block's words load
      // while this one's product runs, its counts go to the other buffer
      uint2 w[kSub];
      if (subs > 0) load_words(words, 0, G, w);
      for (int sb = 0; sb < subs; ++sb, ++q) {
        uint16_t* cnt = s_cnt + (q & 1) * kL * kLd;
        uint32_t bytes[2][8] = {};
        add_bits(w, bytes);
        store_counts(bytes, cnt);
        __syncthreads();
        if (sb + 1 < subs) load_words(words, kSub * (sb + 1), G, w);
        multiply(cnt, s_w, acc);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              float2* t =
                  reinterpret_cast<float2*>(s_tile + acc_row(mi, e) * kTileLd + acc_col(ni));
              float2 p = *t;
              p.x += acc[mi][ni][e];
              p.y += acc[mi][ni][e + 1];
              *t = p;
              acc[mi][ni][e] = acc[mi][ni][e + 1] = 0.f;
            }
          }
        }
      }
    } else {
      for (int g0 = 0; g0 < groups; g0 += kChunk) {
        const int g1 = min(groups, g0 + kChunk);
        uint32_t bytes[2][8] = {};
        for (int ga = g0; ga < g1; ga += kBatch) {
          uint2 w[kBatch];
          load_words(words, ga, g1, w);
          add_bits(w, bytes);
        }
        store_counts(bytes, s_cnt);
        __syncthreads();
        multiply(s_cnt, s_w, acc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int row = acc_row(mi, e), col = acc_col(ni);
          const float2 v = M == kWhen
                               ? *reinterpret_cast<const float2*>(s_tile + row * kTileLd + col)
                               : make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
          __stcs(reinterpret_cast<float2*>(tile + row * kL + col), v);
        }
      }
    }
  }
}

template <int M>
int launch(const int32_t* gcnt, const int32_t* masks, const uint16_t* win, float* out,
           int64_t steps, int G, int device, cudaStream_t st) {
  const size_t smem = smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(
      cond_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cond_kernel<M>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = std::min<int64_t>(steps, static_cast<int64_t>(sms) * std::max(per_sm, 1));
  cond_kernel<M><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(gcnt, masks, win, out,
                                                                         steps, G);
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
  if (mode == kNocond) return launch<kNocond>(g, m, w, o, steps, G, device, st);
  if (mode == kCond) return launch<kCond>(g, m, w, o, steps, G, device, st);
  return launch<kWhen>(g, m, w, o, steps, G, device, st);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
