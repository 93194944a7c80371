// Hand-written Hopper (sm_90a) kernels of the binned / tiered SpMM path.
//
// bucket_spmm replaces of_spmm_tpu/ops/pallas/spmm.py::_bucket_kernel
// (launched there by _bucket_contrib): for one padded-ELL bucket,
//     out[r, :] = sum_k vals[r, k] * x[row_offset + cols[r, k], :].
// It runs every bucket of a plan: binned buckets and cold tier -1 buckets
// with row_offset 0, warm tier t buckets with row_offset t * tier_size.
//
// gather_rows replaces ::_gather_kernel (launched by _gather_rows /
// gather_rows_pallas): out[i, :] = table[idx[i], :], and a zero row where
// idx[i] is outside [0, rows). The TPU kernel dropped that zero-fill; the
// finish's pos array relies on it (its sentinel for an empty output row
// is the total ELL row count, one past the table).
//
// What bounds them on the H100: bytes. bucket_spmm does 2 flops per
// 4-byte X element it reads; gather_rows does none. The TPU kernels staged
// X rows through VMEM with waves of row DMAs because the TPU cannot gather
// inside a kernel; here each warp reads its X rows straight from global
// memory with 16-byte loads (one float4 per lane per row when d % 4 == 0),
// consecutive lanes on consecutive addresses, and L2 (50 MB) catches the
// rows that many nonzeros share. The design is deliberately simple: one
// warp per output row, column indices and values loaded once per 32
// nonzeros and broadcast with shuffles, float32 register accumulators.
//
// All address arithmetic is 64-bit: row * d passes 2^31 at
// ogbn-products scale. Launchers take torch's current stream, allocate
// nothing, and return cudaGetLastError() so the caller can raise.
//
// A bucket column that points outside x is a plan bug. bucket_spmm stops
// on it with a device-side assertion, as torch's index_select does on the
// card, and the error surfaces at the caller's next synchronization; it
// never adds a silent zero.

#undef NDEBUG  // the column check below is an assert and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void fma_acc(float4& acc, float v, const float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ void fma_acc(float& acc, float v, const float x) {
  acc = fmaf(v, x, acc);
}

// One warp per ELL row. T is float4 (width counted in float4s) or float.
// Lane l owns elements l, l + 32, ..., l + 32 * (NV - 1) of each
// 32 * NV-element column tile; wider rows loop over tiles.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bucket_spmm_kernel(const int32_t* __restrict__ cols,
                   const float* __restrict__ vals,
                   const T* __restrict__ x, T* __restrict__ out,
                   int64_t n_ell_rows, int k_width, int64_t width,
                   int64_t row_offset, int64_t x_rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= n_ell_rows) return;  // uniform across the warp
  const int32_t* row_cols = cols + r * k_width;
  const float* row_vals = vals + r * k_width;
  T* out_row = out + r * width;
  for (int64_t c0 = 0; c0 < width; c0 += kWarp * NV) {
    T acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = T{};
    for (int k0 = 0; k0 < k_width; k0 += kWarp) {
      int my_col = 0;
      float my_val = 0.f;
      if (k0 + lane < k_width) {
        my_col = __ldg(row_cols + k0 + lane);
        my_val = __ldg(row_vals + k0 + lane);
        // each lane checks the column it loaded, once per 32 nonzeros
        assert(row_offset + my_col >= 0 && row_offset + my_col < x_rows);
      }
      const int n = min(kWarp, k_width - k0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t src = row_offset + __shfl_sync(kFullMask, my_col, j);
        const float v = __shfl_sync(kFullMask, my_val, j);
        const T* x_row = x + src * width;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int64_t c = c0 + lane + i * kWarp;
          if (c < width) fma_acc(acc[i], v, __ldg(x_row + c));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int64_t c = c0 + lane + i * kWarp;
      if (c < width) out_row[c] = acc[i];
    }
  }
}

// One warp per output row; lanes stride over the row's width.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gather_rows_kernel(const int32_t* __restrict__ idx,
                   const T* __restrict__ table, T* __restrict__ out,
                   int64_t n_out, int64_t table_rows, int64_t width) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n_out) return;
  const int64_t s = __ldg(idx + i);
  T* out_row = out + i * width;
  if (s < 0 || s >= table_rows) {
    for (int64_t c = lane; c < width; c += kWarp) out_row[c] = T{};
    return;
  }
  const T* src_row = table + s * width;
  for (int64_t c = lane; c < width; c += kWarp) out_row[c] = __ldg(src_row + c);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid for one warp per row, or 0 when the row count does not fit.
unsigned grid_for(int64_t rows) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks > 0x7fffffff ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" {

// cols int32 (R, K), vals f32 (R, K), x f32 (x_rows, d), out f32 (R, d);
// all contiguous. Returns a cudaError_t.
int ofs_bucket_spmm(const void* cols, const void* vals, const void* x,
                    void* out, int64_t n_ell_rows, int64_t k_width, int64_t d,
                    int64_t row_offset, int64_t x_rows, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ell_rows == 0 || d == 0) return 0;
  const unsigned grid = grid_for(n_ell_rows);
  if (grid == 0 || k_width <= 0 || k_width > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 block(kWarp * kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const int k = static_cast<int>(k_width);
  if (d % 4 == 0 && aligned16(x) && aligned16(out)) {
    const int64_t d4 = d / 4;
    const auto* x4 = static_cast<const float4*>(x);
    auto* o4 = static_cast<float4*>(out);
    if (d4 <= kWarp) {
      bucket_spmm_kernel<float4, 1><<<grid, block, 0, s>>>(
          c, v, x4, o4, n_ell_rows, k, d4, row_offset, x_rows);
    } else {
      bucket_spmm_kernel<float4, 2><<<grid, block, 0, s>>>(
          c, v, x4, o4, n_ell_rows, k, d4, row_offset, x_rows);
    }
  } else {
    bucket_spmm_kernel<float, 4><<<grid, block, 0, s>>>(
        c, v, static_cast<const float*>(x), static_cast<float*>(out),
        n_ell_rows, k, d, row_offset, x_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx int32 (M,), table f32 (table_rows, d), out f32 (M, d); contiguous.
int ofs_gather_rows(const void* idx, const void* table, void* out,
                    int64_t n_out, int64_t table_rows, int64_t d, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0 || d == 0) return 0;
  const unsigned grid = grid_for(n_out);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 block(kWarp * kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  if (d % 4 == 0 && aligned16(table) && aligned16(out)) {
    gather_rows_kernel<float4><<<grid, block, 0, s>>>(
        i, static_cast<const float4*>(table), static_cast<float4*>(out), n_out,
        table_rows, d / 4);
  } else {
    gather_rows_kernel<float><<<grid, block, 0, s>>>(
        i, static_cast<const float*>(table), static_cast<float*>(out), n_out,
        table_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
