// Hand-written Hopper (sm_90a) kernels of the fused-step microbenchmark
// (of_spmm_tpu_torch/tools/microbench_mxu.py).
//
// mxu_step replaces tools/microbench_mxu.py::run's kernel (pallas_call at
// :88), one template instance per variant. The TPU sums one output tile
// over S sequential grid steps of G groups of 128 lanes, on a window of
// 64 blocks of 128 bf16 rows of width 256 (win). Written as the function
// each variant computes, with lane l < 128 of group g of step i:
//   noop            out[0, :]      += lidx[iG, :] (as float)
//   winread         out[l, :]      += W(blk[i, g], l)
//   winstat         out[l, :]      += W(g, l)
//   rawdyn          out[l, :]      += W(blk[i, g], lidx[iG + g, l])
//   rawstat         out[l, :]      += W(g, lidx[iG + g, l])
//   chain2          out[lrow[iG + g, l], :] += W(blk[i, g], lidx[iG + g, l])
// where W(b, u) = win[128 b + u, :128] + win[128 b + u, 128:] in float32
// (the TPU adds the two 128-column halves of its accumulator at the end of
// each step). The tile has 512 rows (R) for chain2 and 128 for the
// others. The TPU's one-hot matmuls select rows exactly, so the variants
// differ in how a row is found (a whole block, a gathered row) and where
// it goes (its own row, a scattered row): the tool's question, whether a
// fused step's cost is in the gather or in the scatter.
//
// Over all lanes every variant but noop is one product: with Cnt[r, w]
// the number of lanes that send window row w to tile row r,
//     out = Cnt @ win[:, :128] + Cnt @ win[:, 128:],
// rows x win_rows (512 x 8,192 for chain2) times 8,192 x 256 bf16. That is
// the function summed in another order.
//
// What bounds it on the H100: bytes. The window rows the lanes read, lidx,
// lrow, blk and the tile once: 20.9 MB at the tool's defaults, 0.0062 ms at
// 3.35 TB/s; the product, 2 x 512 x 8,192 x 256 flops, takes 0.0022 ms at
// the tensor cores' 989 TFLOP/s. (The lane form, 2 adds per lane and
// column on the CUDA cores, would take 0.0078 ms.) utils/roofline.py
// mxu_work counts both.
//
// Design: out = sum over window blocks b of Cnt_b @ W_b, with Cnt_b the
// counts of the lanes that read block b (rows x 128) and W_b its 128
// window rows. One kernel after a cudaMemsetAsync of out, on the caller's
// stream, one block of 16 warps per (window block b, part p of the items,
// tile rows t):
//   count  the block lists the (step, group) items of part p that read
//          block b (dynamic variants: a scan of blk, every load of a
//          4,096-item chunk in flight; winstat and rawstat read block g,
//          so their items (i, b) need no scan) and counts their lanes
//          with rows in its tile into uint32 counts in shared memory (a
//          warp reads 8 items at once, one shared atomic a lane), while
//          window block b loads with cp.async. winread and winstat add
//          their item count onto the block's diagonal, so 128 lanes never
//          contend on one cell. No count goes through device memory, so
//          nothing is zeroed there and no device-memory atomic counts.
//   product  Cnt_b (rows_t x 128) times both halves of W_b on the tensor
//          cores: warp w owns tile rows [16 MI (w / 4), + 16 MI) and
//          columns [32 (w % 4), + 32); mma.sync m16n8k16 bf16 with float32
//          accumulation, A built in registers from the counts (digits
//          below), B each window half in turn (ldmatrix.trans from the
//          row-major block), so the two halves add in the accumulators,
//          as the cond_steps kernel does (csrc/microbench_cond.cu).
//   add    the partial tile through shared memory into out with float4
//          atomics (nb x parts partials a tile row); a block whose counts
//          are all zero adds nothing.
// The host picks the plan (ops/cuda/microbench_mxu.py count_plan): tiles
// of 256 rows for chain2 (136 KB of counts; two tiles at R 512), 128 for
// the others, and the parts that make nb x parts x tiles fill the SMs
// (chain2 64 x 1 x 2; rawdyn 64 x 2; rawstat 8 x 16; winread, winstat one
// part: their count is their item count).
//
// Exact counts: bf16 holds integers exactly only up to 256, and a count
// reaches S G 128 (2,048,000 at the defaults: every lane on one row and
// one window row). Each count is cut into base-256 digits, and digit d
// enters the product as the bf16 value digit x 256^d (at most 8
// significant bits: exact), all digits into the same accumulators. A block
// runs the products of the digits that some count of its tile has: it
// block ORs its counts (warp __reduce_or_sync, then shared memory), so
// chain2's random lanes (largest count about 8) take one product,
// winstat's (all 2,000) two, the ceiling three; no count is rounded.
//
// noop keeps its own kernel, a floor and not a gather.
//
// A window block outside the window, a lane index outside 0..127 or a tile
// row outside the tile stops the kernel with a device-side assertion.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kL = 128;           // lanes per group, rows per window block, tile width
constexpr int kWin = 2 * kL;      // window row width (bf16)
constexpr int kThreads = 512;
constexpr int kTileM = 128;       // tile rows: R is rounded up to a multiple of it
constexpr int kMaxTileRows = 256; // tile rows a block holds at most (136 KB of counts)
constexpr int kLdC = kL + 8;      // padded row of the counts (uint32)
constexpr int kLdW = kWin + 8;    // padded row of the window block (bf16)
constexpr int kLdO = kL + 4;      // padded row of the partial tile (float32)
constexpr int kItemChunk = 4096;  // items a block lists at a time
constexpr int kItemsAtOnce = 8;   // items a warp reads at once

enum Variant { kNoop = 0, kWinread = 1, kWinstat = 2, kRawdyn = 3, kRawstat = 4, kChain2 = 5 };

struct Args {
  const int32_t* blk;    // (S, G)
  const int32_t* lidx;   // (S G, 128)
  const int32_t* lrow;   // (S G, 128)
  const uint16_t* win;   // (win_rows, 256) bf16 bits
  float* out;            // (rows, 128) float32, zeroed
  int64_t S, win_rows;
  int G, rows;
};

// noop: thread c of each chunk's block sums lidx[iG, c] over its steps
__global__ void __launch_bounds__(kL) noop_kernel(const Args a, int nchunk) {
  const int64_t i0 = a.S * blockIdx.x / nchunk, i1 = a.S * (blockIdx.x + 1) / nchunk;
  float acc = 0.f;
  for (int64_t i = i0; i < i1; ++i) {
    acc += static_cast<float>(a.lidx[i * a.G * kL + threadIdx.x]);
  }
  atomicAdd(a.out + threadIdx.x, acc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// digit d of two counts as bf16 values digit x 256^d (exact), lo in the
// low half
__device__ __forceinline__ uint32_t digit_pair(uint32_t lo, uint32_t hi, int d, float scale) {
  const float flo = __uint2float_rn((lo >> (8 * d)) & 0xffu) * scale;
  const float fhi = __uint2float_rn((hi >> (8 * d)) & 0xffu) * scale;
  return (__float_as_uint(flo) >> 16) | (__float_as_uint(fhi) & 0xffff0000u);
}

// One block per (window block b, part p, tile rows t): block b's lanes of
// the items in part p, counted into Cnt_b's rows [t rows_t, + rows_t) in
// shared memory, then Cnt_b times window block b on the tensor cores (A
// built in registers from the counts, digit d of each as bf16; B each
// window half, ldmatrix.trans from the block's rows in shared memory); the
// partial tile added into out with float4 atomics. MI: m16 blocks a warp
// (rows_t / 64).
template <int V, int MI>
__global__ void __launch_bounds__(kThreads, 1)
mxu_kernel(const Args a, int parts, int rows_t) {
  constexpr bool kStatic = V == kWinstat || V == kRawstat;
  constexpr bool kDiag = V == kWinread || V == kWinstat;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t cnt_bytes = sizeof(uint32_t) * rows_t * kLdC;
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(smem);                     // (rows_t, kLdC)
  uint16_t* s_w = reinterpret_cast<uint16_t*>(smem + cnt_bytes);           // (128, kLdW)
  int* s_items = reinterpret_cast<int*>(smem + cnt_bytes + sizeof(uint16_t) * kL * kLdW);
  __shared__ int s_n;
  __shared__ uint32_t s_or;
  const int b = blockIdx.x, p = blockIdx.y, r0 = blockIdx.z * rows_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  assert(static_cast<int64_t>(b + 1) * kL <= a.win_rows || !kStatic);
  // window block b into shared memory while the lanes are counted
  if (!kStatic || static_cast<int64_t>(b + 1) * kL <= a.win_rows) {
    const uint16_t* wb = a.win + static_cast<int64_t>(b) * kL * kWin;
    for (int e = threadIdx.x; e < kL * (kWin / 8); e += kThreads) {
      const int k = e / (kWin / 8), q = e % (kWin / 8);
      cp_async16(s_w + k * kLdW + 8 * q, wb + k * kWin + 8 * q);
    }
  }
  cp_commit();
  for (int e = threadIdx.x; e < rows_t * kLdC / 4; e += kThreads) {
    reinterpret_cast<uint4*>(s_cnt)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) s_or = 0u;
  const int64_t n_all = kStatic ? a.S : a.S * a.G;
  const int64_t c0 = n_all * p / parts, c1 = n_all * (p + 1) / parts;
  int64_t diag = 0;
  __syncthreads();
  for (int64_t ch = c0; ch < c1; ch += kItemChunk) {
    const int nc = static_cast<int>(c1 - ch < kItemChunk ? c1 - ch : kItemChunk);
    int n = nc;
    if (!kStatic) {
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      int bb[kItemChunk / kThreads];
#pragma unroll
      for (int k = 0; k < kItemChunk / kThreads; ++k) {
        const int j = threadIdx.x + k * kThreads;
        bb[k] = j < nc ? a.blk[ch + j] : b + 1;
      }
#pragma unroll
      for (int k = 0; k < kItemChunk / kThreads; ++k) {
        const int j = threadIdx.x + k * kThreads;
        assert(j >= nc || (bb[k] >= 0 && static_cast<int64_t>(bb[k] + 1) * kL <= a.win_rows));
        if (bb[k] == b) s_items[atomicAdd(&s_n, 1)] = j;
      }
      __syncthreads();
      n = s_n;
    }
    if (kDiag) {
      diag += n;
    } else {
      for (int j0 = warp * kItemsAtOnce; j0 < n; j0 += (kThreads / 32) * kItemsAtOnce) {
        int u[kItemsAtOnce][4], r[kItemsAtOnce][4];
#pragma unroll
        for (int k = 0; k < kItemsAtOnce; ++k) {
          const int j = j0 + k < n ? j0 + k : j0;
          const int64_t it = kStatic ? (ch + j) * a.G + b : ch + s_items[j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = q * 32 + lane;
            u[k][q] = a.lidx[it * kL + l];
            r[k][q] = V == kChain2 ? a.lrow[it * kL + l] : l;
          }
        }
#pragma unroll
        for (int k = 0; k < kItemsAtOnce; ++k) {
          if (j0 + k >= n) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            assert(u[k][q] >= 0 && u[k][q] < kL && r[k][q] >= 0 && r[k][q] < a.rows);
            const int m = r[k][q] - r0;
            if (m >= 0 && m < rows_t) atomicAdd(s_cnt + m * kLdC + u[k][q], 1u);
          }
        }
      }
    }
    __syncthreads();  // the item list is refilled
  }
  if (kDiag) {
    for (int l = threadIdx.x; l < kL; l += kThreads) {
      if (l >= r0 && l < r0 + rows_t) s_cnt[(l - r0) * kLdC + l] = static_cast<uint32_t>(diag);
    }
  }
  cp_wait<0>();
  __syncthreads();
  // the digits the counts have
  uint32_t bits = 0u;
  for (int e = threadIdx.x; e < rows_t * kL / 4; e += kThreads) {
    const int m = e / (kL / 4), c4 = e % (kL / 4);
    const uint4 v = *reinterpret_cast<const uint4*>(s_cnt + m * kLdC + 4 * c4);
    bits |= v.x | v.y | v.z | v.w;
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (lane == 0 && bits != 0u) atomicOr(&s_or, bits);
  __syncthreads();
  const uint32_t used = s_or;
  if (used == 0u) return;
  // warp w: tile rows [MI 16 (w / 4), + MI 16), columns [32 (w % 4), + 32)
  const int m0 = MI * 16 * (warp / 4), n0 = 32 * (warp % 4);
  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  const int g = lane / 4, t = lane % 4;
  float scale = 1.f;
  for (int d = 0; d < 4; ++d, scale *= 256.f) {
    if (((used >> (8 * d)) & 0xffu) == 0u) continue;
#pragma unroll 2
    for (int kk = 0; kk < kL; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint32_t* c = s_cnt + (m0 + 16 * mi + g) * kLdC + kk + 2 * t;
        const uint2 x0 = *reinterpret_cast<const uint2*>(c);
        const uint2 x1 = *reinterpret_cast<const uint2*>(c + 8 * kLdC);
        const uint2 x2 = *reinterpret_cast<const uint2*>(c + 8);
        const uint2 x3 = *reinterpret_cast<const uint2*>(c + 8 * kLdC + 8);
        af[mi][0] = digit_pair(x0.x, x0.y, d, scale);
        af[mi][1] = digit_pair(x1.x, x1.y, d, scale);
        af[mi][2] = digit_pair(x2.x, x2.y, d, scale);
        af[mi][3] = digit_pair(x3.x, x3.y, d, scale);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bf[4][2];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t rr[4];
          ldmatrix_x4_trans(rr, s_w + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kLdW + h * kL + n0 +
                                    16 * nj + (lane / 16) * 8);
          bf[2 * nj][0] = rr[0];
          bf[2 * nj][1] = rr[1];
          bf[2 * nj + 1][0] = rr[2];
          bf[2 * nj + 1][1] = rr[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
      }
    }
  }
  // the partial tile through shared memory (over the counts), then float4
  // atomics into out
  __syncthreads();
  float* s_o = reinterpret_cast<float*>(smem);  // (rows_t, kLdO)
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = m0 + 16 * mi + g + 8 * (e / 2);
        const int col = n0 + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(s_o + row * kLdO + col) =
            make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows_t * (kL / 4); e += kThreads) {
    const int r = e / (kL / 4), c4 = e % (kL / 4);
    if (r0 + r < a.rows) {
      atomicAdd(reinterpret_cast<float4*>(a.out + static_cast<int64_t>(r0 + r) * kL) + c4,
                *reinterpret_cast<const float4*>(s_o + r * kLdO + 4 * c4));
    }
  }
}

template <int V>
int launch(const Args& a, int nb, int parts, int rows_t, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * rows_t * kLdC + sizeof(uint16_t) * kL * kLdW +
                      sizeof(int) * kItemChunk;
  auto kern = rows_t == kMaxTileRows ? mxu_kernel<V, 4> : mxu_kernel<V, 2>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.rows + kTileM - 1) / kTileM * kTileM / rows_t;
  kern<<<dim3(nb, parts, tiles), kThreads, smem, st>>>(a, parts, rows_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant 0-5 as above. blk int32 (S, 1, G); lidx and lrow int32
// (S G, 128); win bf16 bits (win_rows, 256), 16-byte aligned; out float32
// (rows, 128) (rows = R for chain2, 128 otherwise), zeroed here. The
// plan: nb window blocks (G for winstat and rawstat, win_rows / 128 for
// the others), parts item parts, tiles of rows_t rows (128 or 256,
// dividing rows rounded up to 128). Contiguous device arrays; S G 128 <
// 2^32. Returns a cudaError_t.
int ofs_mxu_step(int variant, const void* blk, const void* lidx, const void* lrow,
                 const void* win, void* out, int64_t S, int G, int64_t win_rows, int rows, int nb,
                 int parts, int rows_t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_pad = (rows + kTileM - 1) / kTileM * kTileM;
  if (G <= 0 || rows <= 0 || rows > 512 || win_rows <= 0 || win_rows % kL != 0 ||
      variant < 0 || variant > 5 || S < 0 || S * G * kL >= (int64_t{1} << 32) || nb <= 0 ||
      nb > 65535 || parts <= 0 || parts > 65535 || (rows_t != kTileM && rows_t != kMaxTileRows) ||
      rows_pad % rows_t != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(float) * rows * kL, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.blk = static_cast<const int32_t*>(blk);
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.win = static_cast<const uint16_t*>(win);
  a.out = static_cast<float*>(out);
  a.S = S;
  a.win_rows = win_rows;
  a.G = G;
  a.rows = rows;
  if (variant == kNoop) {
    const int nchunk = static_cast<int>(std::min<int64_t>({S, 2 * sms, 65535}));
    noop_kernel<<<static_cast<unsigned>(nchunk), kL, 0, st>>>(a, nchunk);
    return static_cast<int>(cudaGetLastError());
  }
  switch (variant) {
    case kWinread: return launch<kWinread>(a, nb, parts, rows_t, st);
    case kWinstat: return launch<kWinstat>(a, nb, parts, rows_t, st);
    case kRawdyn: return launch<kRawdyn>(a, nb, parts, rows_t, st);
    case kRawstat: return launch<kRawstat>(a, nb, parts, rows_t, st);
    default: return launch<kChain2>(a, nb, parts, rows_t, st);
  }
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
