// Hand-written Hopper (sm_90a) kernels of the binned / tiered SpMM path.
//
// bucket_spmm replaces of_spmm_tpu/ops/pallas/spmm.py::_bucket_kernel
// (launched there by _bucket_contrib, once per bucket): for each padded-ELL
// bucket of a plan,
//     out[r, :] = sum_k vals[r, k] * x[row_offset + cols[r, k], :],
// with row_offset 0 for binned buckets and cold tier -1 buckets and
// t * tier_size for warm tier t buckets. One launch runs every bucket of a
// plan and writes the concatenation of their partial rows (the buffer the
// finish gathers from); a single bucket runs as a one-bucket plan.
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
// inside a kernel; here X rows are read straight from global memory with
// 16-byte loads (one float4 per lane per row when d % 4 == 0), and L2
// (50 MB) catches the rows that many nonzeros share. The compulsory
// traffic of the bucket phase (cols and vals once, each referenced X row
// once, each partial row written once; chip_smoke.py kernel_figures, which
// leaves the work list below out) over 3.35 TB/s is its bound: 0.0582 ms
// for one arxiv SpMM at d = 128, 0.1493 ms on products-small.
//
// What the first design lost: one launch per bucket (18 on arxiv, 9 of
// them under 1,200 rows, each a launch gap and a tail of a nearly idle
// card), and one warp per ELL row walking its K slots alone with 4 X rows
// in flight, so a width-256 row was a chain of 64 dependent rounds (tier
// 1's eight width-256 rows filled one block) and the width-153 / 64 / 33
// buckets of both tiers added their own tails. It took 0.4078 ms on
// arxiv, 7x its bound, 1.69x torch.sparse.mm.
//
// This design runs the plan's buckets in one launch, on balanced units:
// - placement lists the plan's buckets in a small device table (the cols
//   and vals pointers, K, ELL rows, row_offset and first row in the
//   concatenation) and cuts each bucket into work units of whole ELL rows,
//   at most 128 rows and BUCKET_UNIT_SLOTS padded slots (2,048) each (a
//   row wider than that is a unit alone; ops/cuda/spmm.py bucket_units).
//   Units run tier by tier, the cold tier (all of X) last, so one tier's
//   slice of X is what L2 holds while its units run, and heaviest first
//   within a tier, so its wide rows start at once. One block runs one
//   unit and one column slab: blockIdx.x = unit * slabs + slab;
// - the 8 warps take the unit's slots, flattened row by row, in chunks of
//   32, round robin: a width-256 row is 8 chunks on 8 warps, so no warp
//   walks more than 32 slots of one row in sequence (the first design:
//   up to 256), and a chunk of narrow rows covers several of them. Each
//   lane loads one slot's value and column; padding slots (value 0) are
//   skipped, and the column check is a device-side assertion on every
//   slot that loads. The chunk's real slots are summed 8 X rows at a time,
//   each run of one row in registers, and added into a 128-row fp32
//   accumulator tile in shared memory (csrc/tile_accumulate.cuh: the
//   K-slices of one row meet there);
// - the epilogue writes each of the unit's rows once with plain stores:
//   no atomics and no zeroing. A row of padding only is written as zeros;
// - blockIdx.x's slab picks a column slab of X: 128 columns, one float4
//   per lane, when d % 4 == 0; 64 columns, two floats per lane, otherwise.
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

#include "tile_accumulate.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;  // gather_rows: one warp per row
constexpr int kWarps = 8;          // bucket_spmm: warps per work unit
constexpr int kThreads = kWarp * kWarps;
constexpr int kInFlight = 8;       // X rows loaded before their adds
constexpr int kTileRows = 128;     // ELL rows per unit at most
constexpr int kTableWords = 6;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kTileRows == ofs_tile::kRows && kWarp == ofs_tile::kWarp, "the accumulator tile");

struct BucketArgs {
  const long long* table;  // (n_buckets, 6): cols, vals (device pointers), K, ELL rows,
                           // row_offset, first row of the bucket in out
  const int32_t* units;  // (n_units, 3): bucket, first ELL row, rows (<= 128)
  const void* x;         // (x_rows, d) float32
  void* out;             // (total ELL rows, d) float32
  int64_t x_rows, width, slabs;
};

// T is float4 (width counted in float4s, NV = 1) or float (NV = 2): lane l
// owns elements c0 + l + 32 * i, i < NV, of its rows, for one 32 * NV-wide
// column slab c0. The accumulator tile holds NE = NV * sizeof(T) / 4
// floats per lane and row, at [e][row][lane].
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 3)
bucket_spmm_kernel(const BucketArgs a) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);  // NE * 128 * 32

  const int64_t unit = blockIdx.x / a.slabs;
  const int64_t c0 = (blockIdx.x % a.slabs) * kWarp * NV;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  const long long* b = a.table + static_cast<int64_t>(__ldg(a.units + unit * 3)) * kTableWords;
  const int row0 = __ldg(a.units + unit * 3 + 1);
  const int n_rows = __ldg(a.units + unit * 3 + 2);
  const auto* cols = reinterpret_cast<const int32_t*>(__ldg(b));
  const auto* vals = reinterpret_cast<const float*>(__ldg(b + 1));
  const int k_width = static_cast<int>(__ldg(b + 2));
  const int64_t row_offset = __ldg(b + 4);
  const int64_t out_row0 = __ldg(b + 5) + row0;
  const T* __restrict__ x = static_cast<const T*>(a.x);

  for (int i = tid; i < NE * kTileRows * kWarp; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();
  const int64_t slot0 = static_cast<int64_t>(row0) * k_width;
  const int n_slots = n_rows * k_width;
  for (int c = warp * kWarp; c < n_slots; c += kWarps * kWarp) {
    const int f = c + lane;  // this lane's slot of the unit, row by row
    int32_t src = 0;
    float v = 0.f;
    int row = 0;
    if (f < n_slots) {  // value and column loaded together: one round trip
      v = __ldg(vals + slot0 + f);
      const int64_t col = row_offset + __ldg(cols + slot0 + f);
      row = f / k_width;
      if (v != 0.f) {
        assert(col >= 0 && col < a.x_rows);
        src = static_cast<int32_t>(col);
      }
    }
    ofs_tile::accumulate_entries<kInFlight, T, NV>(
        s_acc, x, a.width, c0, lane, __ballot_sync(kFullMask, v != 0.f), src, v, row);
  }
  __syncthreads();
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int j = warp; j < n_rows; j += kWarps) {
    ofs_tile::write_row<T, NV>(s_acc, j, lane, c0, a.width, out + (out_row0 + j) * a.width, 1.f,
                               false);
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

template <typename T, int NV>
cudaError_t launch_buckets(const BucketArgs& a, int64_t n_units, cudaStream_t s) {
  constexpr int NE = NV * static_cast<int>(sizeof(T) / sizeof(float));
  constexpr size_t smem = sizeof(float) * NE * kTileRows * kWarp;
  const auto kernel = bucket_spmm_kernel<T, NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (n_units * a.slabs > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_units * a.slabs), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every bucket of a plan in one launch: table int64 (n_buckets, 6) and
// units int32 (n_units, 3) as in BucketArgs (ops/cuda/spmm.py
// bucket_work), x f32 (x_rows, d), out f32 (total ELL rows, d); all
// contiguous device arrays. Writes every ELL row of every bucket once.
// Returns a cudaError_t.
int ofs_bucket_spmm(const void* table, const void* units, const void* x, void* out,
                    int64_t n_units, int64_t x_rows, int64_t d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units == 0 || d == 0) return 0;
  if (x_rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  BucketArgs a;
  a.table = static_cast<const long long*>(table);
  a.units = static_cast<const int32_t*>(units);
  a.x = x;
  a.out = out;
  a.x_rows = x_rows;
  const auto s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(x) && aligned16(out)) {
    a.width = d / 4;
    a.slabs = (a.width + kWarp - 1) / kWarp;
    err = launch_buckets<float4, 1>(a, n_units, s);
  } else {
    a.width = d;
    a.slabs = (d + 2 * kWarp - 1) / (2 * kWarp);
    err = launch_buckets<float, 2>(a, n_units, s);
  }
  return static_cast<int>(err);
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
