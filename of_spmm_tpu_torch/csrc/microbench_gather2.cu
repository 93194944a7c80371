// Hand-written Hopper (sm_90a) kernels of the second-round gather
// microbenchmark (of_spmm_tpu_torch/tools/microbench_gather2.py), for the
// TPU kernels of tools/microbench_gather2.py (pallas_call line):
//
//   onehot_pair  bench_onehot_pair (:57): out[t] = f32(hi[c]) + f32(lo[c]),
//                c = cols[t], with one one-hot feeding two products; an
//                index >= C gives a zero row. onehot_mma_kernel
//                (csrc/gather.cuh) on the tensor cores, hi and lo summed
//                apart and added in float32.
//   take_fused   bench_take_fused (:95): out[n] = sum_{k < 8} vals[n, k]
//                tier[cols[n, k]]; and
//   dma_deep     bench_dma_deep (:150): out[o] = sum_{m < 128}
//                table[cols.flat[128 o + m]] from a 1 GiB table in device
//                memory, W rows in flight per warp: the same functions as
//                vmem_loop and row_dma at other widths, so they launch
//                csrc/microbench_gather.cu's ofs_gather_ell_reduce and
//                ofs_gather_row_sum (ops/cuda/microbench_gather2.py).
//   window_pair  bench_window_pair (:210): out[t] = f32(hi[b + l]) + f32(lo[b + l]),
//                l = lidx[t], b the base of step t / TILE, the one-hot over
//                the CW-row window at b (l >= CW: a zero row).
//   twosided     bench_twosided (:294): out (R, 128) = sum over every lane t of
//                f32(c_hi) + f32(c_lo) into row rows[t], where c is the
//                window pair gather of lane t times vals[t], c_hi = bf16(c)
//                and c_lo = bf16(c - f32(c_hi)), rounded to nearest even.
//                The TPU carries an (R, 128) accumulator across its
//                sequential grid and scatters with a second one-hot product;
//                here the window gather runs on the tensor cores and each
//                lane's row is added into the zeroed output with float4
//                atomics (TwosidedScatter below), in no fixed order.
//
// What bounds them on the H100 (utils/roofline.py): bytes, the rows the
// lanes select and the float32 output (twosided: its (R, 128) output and
// the lanes' rows and values). The one-hot multiply-adds the TPU kernels
// prescribe (C or CW x 128 per lane and table) are reported beside the
// bound, not in it: the functions are row gathers.
//
// A row outside [0, R) stops twosided with a device-side assertion, as
// does a window base with b + CW past the table; an index outside a
// one-hot window gives a zero row.

#include "gather.cuh"

namespace {

using namespace ofs_gather;

// The twosided epilogue: the lane's gathered row g = hi + lo, scaled by its
// value, split into bf16 hi and lo halves and added into its output row.
// Lanes q and q ^ 1 of a quad swap halves so that each adds one float4:
// even q row ra, columns col .. col + 3; odd q row rb, columns col - 2 .. col + 1.
struct TwosidedScatter {
  const int32_t* rows;
  const float* vals;
  float* out;
  int R;

  __device__ __forceinline__ static float split(const float c) {
    const __nv_bfloat16 h = __float2bfloat16_rn(c);
    const float hf = __bfloat162float(h);
    return hf + __bfloat162float(__float2bfloat16_rn(c - hf));
  }

  __device__ __forceinline__ void operator()(int64_t ra, int64_t rb, int col, const float (&h)[4],
                                             const float (&l)[4]) const {
    const float va = vals[ra], vb = vals[rb];
    float v[4];
    v[0] = split((h[0] + l[0]) * va);
    v[1] = split((h[1] + l[1]) * va);
    v[2] = split((h[2] + l[2]) * vb);
    v[3] = split((h[3] + l[3]) * vb);
    const bool even = (threadIdx.x & 1) == 0;
    const float s0 = __shfl_xor_sync(kFull, even ? v[2] : v[0], 1);
    const float s1 = __shfl_xor_sync(kFull, even ? v[3] : v[1], 1);
    const int64_t t = even ? ra : rb;
    const int32_t row = rows[t];
    assert(row >= 0 && row < R);
    const float4 add = even ? make_float4(v[0], v[1], s0, s1) : make_float4(s0, s1, v[2], v[3]);
    const int64_t at = static_cast<int64_t>(row) * kD + (even ? col : col - 2);
    atomicAdd(reinterpret_cast<float4*>(out + at), add);
  }
};

int check_window(int64_t T, int64_t tile, int cw, int64_t n_rows) {
  if (T % kMmaRows != 0 || tile <= 0 || tile % kMmaRows != 0 || T % tile != 0 || cw <= 0 ||
      cw > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// Every array is a contiguous device array, float4-aligned where it holds
// rows; each function returns a cudaError_t.

// cols int32 (T,), T a multiple of 128; hi, lo bfloat16 (C, 128); out
// float32 (T, 128).
int ofs_gather2_onehot_pair(const void* cols, const void* hi, const void* lo, void* out, int64_t T,
                            int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (const int rc = check_window(T, T, C, C)) return rc;
  onehot_mma_kernel<true><<<blocks_for(T, kMmaRows), kMmaWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), nullptr, static_cast<const __nv_bfloat16*>(hi),
      static_cast<const __nv_bfloat16*>(lo), T, C, C, StoreRows{static_cast<float*>(out)});
  return static_cast<int>(cudaGetLastError());
}

// bases int32 (T / tile,), lidx int32 (T,), hi, lo bfloat16 (n_rows, 128),
// out float32 (T, 128); tile a multiple of 128 dividing T; cw <= n_rows.
int ofs_gather2_window_pair(const void* bases, const void* lidx, const void* hi, const void* lo,
                            void* out, int64_t T, int64_t tile, int cw, int64_t n_rows,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (const int rc = check_window(T, tile, cw, n_rows)) return rc;
  onehot_mma_kernel<true><<<blocks_for(T, kMmaRows), kMmaWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lidx), static_cast<const int32_t*>(bases),
      static_cast<const __nv_bfloat16*>(hi), static_cast<const __nv_bfloat16*>(lo), tile, cw,
      n_rows, StoreRows{static_cast<float*>(out)});
  return static_cast<int>(cudaGetLastError());
}

// As window_pair, plus rows int32 (T,) in [0, R) and vals float32 (T,); out
// float32 (R, 128), zeroed by the caller and added into.
int ofs_gather2_twosided(const void* bases, const void* lidx, const void* rows, const void* vals,
                         const void* hi, const void* lo, void* out, int64_t T, int64_t tile,
                         int cw, int64_t n_rows, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int rc = check_window(T, tile, cw, n_rows)) return rc;
  onehot_mma_kernel<true><<<blocks_for(T, kMmaRows), kMmaWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lidx), static_cast<const int32_t*>(bases),
      static_cast<const __nv_bfloat16*>(hi), static_cast<const __nv_bfloat16*>(lo), tile, cw,
      n_rows,
      TwosidedScatter{static_cast<const int32_t*>(rows), static_cast<const float*>(vals),
                      static_cast<float*>(out), R});
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
