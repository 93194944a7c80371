// The one-hot product gather shared by the gather microbenchmarks' kernels
// (csrc/microbench_gather.cu, csrc/microbench_gather2.cu), on rows of 128
// bfloat16 values:
//
//   onehot_mma_kernel  out[t] = sum_c onehot(idx[t])[c] f32(hi[base + c])
//                      (+ f32(lo[base + c])) over a window of CW rows at a
//                      base per step, on the tensor cores with mma.sync
//                      m16n8k16 bf16 -> f32, and an epilogue that stores
//                      the rows (StoreRows) or scatters them. An index
//                      outside [0, CW) selects no row: a zero row by
//                      definition. A window past the table's end stops the
//                      kernel with a device-side assertion.

#pragma once

#undef NDEBUG  // the window check is an assert and must stay on
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_gather {

constexpr int kD = 128;  // row width (columns)
constexpr unsigned kFull = 0xffffffffu;

// ---- one-hot product gather on the tensor cores ---------------------------------

constexpr int kMmaWarps = 16;           // 8 m-tiles of 16 rows x 2 column halves
constexpr int kMmaRows = 128;           // index rows (lanes) per block
constexpr int kChunk = 64;              // window rows staged per pass
constexpr int kPairStride = kD + 8;     // words per staged row pair: banks 8 apart

// bf16 1.0 in the low half of the word where idx == c, in the high half
// where idx == c + 1: two elements of a one-hot A fragment
__device__ __forceinline__ uint32_t onehot2(const int idx, const int c) {
  return (idx == c ? 0x3F80u : 0u) | (idx == c + 1 ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t a0, const uint32_t a1,
                                         const uint32_t a2, const uint32_t a3,
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Window rows [r0, r0 + kChunk) of the table at `base` as the B operand:
// word (p, n) packs rows r0 + 2p (low half) and r0 + 2p + 1 of column n.
// Rows at or past n_valid are zeros, so that no index outside the window
// selects anything.
__device__ __forceinline__ void stage_pairs(uint32_t* s, const __nv_bfloat16* __restrict__ tab,
                                            const int64_t base, const int r0, const int n_valid) {
  for (int e = threadIdx.x; e < (kChunk / 2) * (kD / 2); e += kMmaWarps * 32) {
    const int p = e / (kD / 2), n2 = e % (kD / 2);
    const int ra = r0 + 2 * p;
    uint32_t va = 0, vb = 0;
    if (ra < n_valid) va = __ldg(reinterpret_cast<const uint32_t*>(tab + (base + ra) * kD) + n2);
    if (ra + 1 < n_valid) {
      vb = __ldg(reinterpret_cast<const uint32_t*>(tab + (base + ra + 1) * kD) + n2);
    }
    s[p * kPairStride + 2 * n2] = __byte_perm(va, vb, 0x5410);
    s[p * kPairStride + 2 * n2 + 1] = __byte_perm(va, vb, 0x7632);
  }
}

// Block b gathers index rows [128 b, 128 b + 128): warp w an m-tile of 16
// rows (w / 2) and 64 columns (w % 2). Per pass, kChunk window rows of hi
// (and lo) are staged in shared memory; each 16-row k-step builds the
// one-hot A fragment from the thread's two rows' indices in registers and
// runs 8 mma per table, hi and lo into separate accumulators (each sum is
// exact: one product of 1 by a bf16 value, the rest zeros). The epilogue
// gets, per n-tile, the thread's fragment: rows (ra, rb), columns
// (col, col + 1), hi values v[4] and lo values (zeros without lo):
//     epi(ra, rb, col, hi[4], lo[4])   with hi[0..1] row ra, hi[2..3] row rb.
// bases: one window base per step of `tile` rows (null: base 0); the
// window is cw rows; n_rows the table's rows. T must be a multiple of 128.
template <bool kPair, class Epi>
__global__ void __launch_bounds__(kMmaWarps * 32)
onehot_mma_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ bases,
                  const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
                  int64_t tile, int cw, int64_t n_rows, Epi epi) {
  __shared__ uint32_t s_hi[(kChunk / 2) * kPairStride];
  __shared__ uint32_t s_lo[kPair ? (kChunk / 2) * kPairStride : 1];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kMmaRows;
  const int64_t base = bases == nullptr ? 0 : bases[t0 / tile];
  assert(base >= 0 && base + cw <= n_rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int64_t ra = t0 + (warp / 2) * 16 + g, rb = ra + 8;
  const int n0 = (warp % 2) * (kD / 2);
  const int ia = idx[ra], ib = idx[rb];

  float acc_hi[8][4], acc_lo[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_hi[nt][i] = acc_lo[nt][i] = 0.f;
  }
  for (int c0 = 0; c0 < cw; c0 += kChunk) {
    __syncthreads();  // the previous pass has read the staged rows
    stage_pairs(s_hi, hi, base, c0, cw);
    if (kPair) stage_pairs(s_lo, lo, base, c0, cw);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      const int c = c0 + ks + 2 * q;
      const uint32_t a0 = onehot2(ia, c), a1 = onehot2(ib, c);
      const uint32_t a2 = onehot2(ia, c + 8), a3 = onehot2(ib, c + 8);
      const uint32_t* ph = s_hi + (ks / 2 + q) * kPairStride + n0 + g;
      const uint32_t* pl = s_lo + (kPair ? (ks / 2 + q) * kPairStride + n0 + g : 0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mma_bf16(acc_hi[nt], a0, a1, a2, a3, ph[nt * 8], ph[4 * kPairStride + nt * 8]);
        if (kPair) {
          mma_bf16(acc_lo[nt], a0, a1, a2, a3, pl[nt * 8], pl[4 * kPairStride + nt * 8]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) epi(ra, rb, n0 + nt * 8 + 2 * q, acc_hi[nt], acc_lo[nt]);
}

// The gather's epilogue: out[r, col .. col + 1] = hi + lo (float32).
struct StoreRows {
  float* out;
  __device__ __forceinline__ void operator()(int64_t ra, int64_t rb, int col, const float (&h)[4],
                                             const float (&l)[4]) const {
    *reinterpret_cast<float2*>(out + ra * kD + col) = make_float2(h[0] + l[0], h[1] + l[1]);
    *reinterpret_cast<float2*>(out + rb * kD + col) = make_float2(h[2] + l[2], h[3] + l[3]);
  }
};

// An error of a runtime call (one that launched nothing), after clearing
// it from the runtime's last-error state, so that the next launch's
// cudaGetLastError() does not report it again.
inline int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

inline unsigned blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace ofs_gather
